"""Static configuration of the simulator (counterpart of
`sparksched_tpu/config.py`).

The YAML shape (`trainer`/`agent`/`env`, plus `serve:`) is the JAX
package's, so `config/decima_tpch.yaml` loads unmodified. `EnvParams`
stays a frozen dataclass: every shape-determining field lives here and
the engine's tensors are sized from it.

The JAX-only switches of the reference module (`honor_jax_platforms_env`,
`enable_compilation_cache`) have no counterpart. `use_fast_prng`, which
flips jax's process-wide default PRNG to `rbg`, has none either: the
port has no process-wide default impl, and the trainer's `fast_prng:
True` builds every key of its run as an rbg key (`prng.PRNGKey(...,
impl="rbg")`).
"""

from __future__ import annotations

import dataclasses
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from typing import Any

import torch
import yaml


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment parameters (all shape-determining fields);
    field for field the JAX package's `EnvParams`."""

    num_executors: int = 10
    max_jobs: int = 50
    max_stages: int = 20
    max_levels: int = 20
    moving_delay: float = 2000.0
    warmup_delay: float = 1000.0
    beta: float = 0.0
    job_arrival_rate: float = 4.0e-5
    mean_time_limit: float | None = None
    history_cap: int = 0
    obs_dtype: str = "float32"

    def __post_init__(self) -> None:
        canon = {
            "float32": "float32", "f32": "float32",
            "bfloat16": "bfloat16", "bf16": "bfloat16",
        }.get(self.obs_dtype)
        if canon is None:
            raise ValueError(
                f"obs_dtype {self.obs_dtype!r} is not one of "
                "float32/f32/bfloat16/bf16"
            )
        object.__setattr__(self, "obs_dtype", canon)

    @property
    def num_nodes(self) -> int:
        return self.max_jobs * self.max_stages

    def replace(self, **kw: Any) -> "EnvParams":
        return dataclasses.replace(self, **kw)


def env_params_from_cfg(env_cfg: dict[str, Any]) -> EnvParams:
    """Build EnvParams from a reference-style `env:` config section.
    Values are coerced to the declared int/float types: PyYAML 1.1 reads
    unsigned exponent literals (``2.0e7``) as strings."""
    types = {f.name: f.type for f in dataclasses.fields(EnvParams)}
    kw: dict[str, Any] = {}
    for k, v in env_cfg.items():
        if k not in types:
            continue
        if v is not None and types[k] != "str":
            v = int(float(v)) if types[k] == "int" else float(v)
        kw[k] = v
    if "max_jobs" not in kw and "job_arrival_cap" in env_cfg:
        kw["max_jobs"] = int(env_cfg["job_arrival_cap"])
    if "mean_time_limit" in env_cfg and "job_arrival_cap" not in env_cfg:
        kw.setdefault("max_jobs", 200)
    return EnvParams(**kw)


def load(filename: str | None = None) -> dict[str, Any]:
    """Load a YAML experiment config."""
    if not filename:
        args = make_parser().parse_args()
        filename = args.filename
    with open(filename, "r") as stream:
        return yaml.safe_load(stream)


def make_parser() -> ArgumentParser:
    parser = ArgumentParser(
        description="sparksched_tpu_torch experiment runner",
        formatter_class=ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "-f", "--file", dest="filename", help="experiment definition file",
        metavar="FILE", required=True,
    )
    return parser


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; with
    no card the call raises unless the caller asked for the CPU. There is
    no silent fallback. TF32 is switched off for matmuls and cuDNN so
    that float32 on the card means float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sparksched_tpu_torch: device='cuda' requested but no CUDA "
                "device is available; pass device='cpu' explicitly"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


# the top-level `chaos:` YAML block's keys (`chaos.ChaosMonkey`), the JAX
# package's surface
CHAOS_KEYS = frozenset({
    "seed",  # injection-index derivation seed
    "nan_grad",  # iterations: poison one recorded reward with NaN
    "bank_row",  # iterations: poison one recorded obs duration row
    "straggler",  # iterations: inflate one lane's loop_iters counter
    "oom",  # iterations: raise a simulated out-of-memory error
    "sigkill",  # iterations: SIGKILL the process mid-iteration
    "straggler_factor",  # loop_iters inflation factor (default 100)
})


# the top-level `serve:` YAML block's keys, the JAX package's surface:
# `serve/session.py:store_from_config`, `front_from_config` and
# `serve/server.py:server_from_config` fail on any other key, and on a
# key whose feature the port has not ported yet
SERVE_KEYS = frozenset({
    "capacity",  # sessions the store admits (one live cluster per tenant)
    "max_batch",  # batch width K of the batched serve program
    "linger_ms",  # bounded linger window (the `front: linger` partner)
    "deterministic",  # greedy serving (default True)
    "donate",  # in-place slot updates (the port's only layout)
    "seed",  # base key for session resets and sampling
    "trace",  # per-request span stamps + run-log `trace` records
    "metrics",  # attach an obs.metrics.MetricsRegistry to the store
    "front",  # batching front: continuous (default) | pipelined | linger
    "hot_capacity",  # device slots; < capacity pages idle sessions to host
    "shard_dp",  # shard the store over a dp mesh (not ported)
    "record",  # per-decision trajectory records (the online loop's path)
    "pager_aware",  # continuous front: prefer hot sessions in batches
    "ring",  # device-resident trajectory ring depth (0 = per decision)
    "ring_drain",  # the ring's drain cadence (default: about half the ring)
    "groups",  # slot groups (the in-flight window's width)
    "depth",  # `front: pipelined` in-flight window depth (default: groups)
    "harvester",  # background thread materializing outputs
    "prefetch",  # pipelined front: page predicted-next sessions ahead
    "host",  # HTTP front bind address (default 127.0.0.1)
    "port",  # HTTP front port (0 = ephemeral, reported back)
    "replicas",  # serve-fleet width behind a router (not ported)
    "quota_sessions",  # per-tenant live-session quota (0 = unlimited)
    "quota_inflight",  # per-tenant outstanding-decide quota (0 = unlimited)
    "collect",  # fleet collector (not ported)
    "collect_period_s",  # its scrape period (not ported)
    "slo",  # the burn-rate SLO block (not ported)
    "attribution",  # critical-path analyzer on the front (default: trace)
    "hostprof",  # sampling host profiler (not ported)
})

# the top-level `online:` YAML block's keys, the JAX package's surface:
# `online/__init__.py:online_from_config` fails on any other key
ONLINE_KEYS = frozenset({
    "enabled",  # default True when the block is present
    "max_trajectories",  # completed-trajectory buffer bound (FIFO evict)
    "max_steps",  # decisions per trajectory segment (the padded T)
    "batch_trajectories",  # trajectories per update (the padded B)
    "max_param_lag",  # off-policy guard: skip trajectories whose
    #   params-version lag exceeds this (PPO's ratio clip covers the rest)
    "min_decisions",  # drop segments shorter than this many decisions
    "swap_every",  # publish params every N accepted learner updates
    "probation_decisions",  # post-swap decisions watched before a swap
    #   is marked good (the rollback window)
    "max_quarantine_rate",  # roll back when the post-swap quarantine
    #   rate over the probation window exceeds this
    "learner",  # nested PPO overrides for the learner's trainer
    "seed",
})
