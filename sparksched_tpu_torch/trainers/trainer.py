"""Training orchestration (counterpart of
`sparksched_tpu/trainers/trainer.py`).

One iteration: fresh episodes on `num_sequences x num_rollouts` lanes
(the lanes of a sequence group share the job-sequence key), the
single-eval flat collector, returns and the group baselines, then the
trainer's `_update`. The seed layout is the JAX package's: the sequence
key of group g at iteration i is `fold_in(fold_in(PRNGKey(seed), g), i)`,
lane r of it `fold_in(seq, 1000 + r)`, the iteration key
`fold_in(PRNGKey(seed), i)` (`fold_in(·, 90_000 + attempt)` on a health
retry) and the collector's `fold_in(iteration key, 7)`.

Ported: `rollout_engine: flat` with `flat_single_eval` in sync mode, the
Adam optimizer (`lr_anneal`, global-norm clipping as optax writes it),
`fixed_sequences`, `entropy_anneal`, `beta_discount` or the differential
returns, and the health block's rollback-and-retry (reseed, backoff). Not
ported yet (the trainer names the keys it ignores when it starts):
asynchronous collection (`rollout_duration`) and the `core` engine (both
raise), checkpoints (`checkpointing_freq`, `health.checkpoint_every` /
`keep`, `save_train_state` / `load_train_state`), the observability
block (`obs:`), chaos injection and `fast_prng` (the port has only the
threefry stream).
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import metrics, prng
from ..config import EnvParams, env_params_from_cfg, resolve_device
from ..env import core
from ..env.health import RETRYABLE_MASK, describe_mask
from ..schedulers import TrainableScheduler, make_scheduler
from ..workload import make_workload_bank
from .baselines import group_baselines
from .returns import (
    AvgNumJobsBuffer,
    differential_returns,
    discounted_returns,
    step_dts,
)
from .rollout import Rollout, collect_flat_sync_batch

CfgType = dict[str, Any]


class ClippedAdam:
    """`optax.chain(clip_by_global_norm(max_norm), adam(lr))` over a list
    of parameters: the gradients are clipped as optax does (`g / norm *
    max_norm` where the global norm reaches max_norm), then
    `torch.optim.Adam` steps with the learning rate of the schedule at
    the number of steps taken so far. A step not taken (the KL stop, the
    health gate) leaves the moments and the count as they were."""

    def __init__(self, params: list[torch.Tensor], lr, max_grad_norm,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> None:
        self.params = params
        self.lr = lr  # a float, or a function of the step count
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.opt = torch.optim.Adam(params, lr=self.lr_at(0), betas=betas,
                                    eps=eps)

    def lr_at(self, count: int) -> float:
        return float(self.lr(count) if callable(self.lr) else self.lr)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if self.max_grad_norm:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_grad_norm))
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count,
                "opt": copy.deepcopy(self.opt.state_dict())}

    def load_state_dict(self, sd: dict) -> None:
        self.count = sd["count"]
        self.opt.load_state_dict(copy.deepcopy(sd["opt"]))


def make_optimizer(train_cfg: CfgType, params: list[torch.Tensor]
                   ) -> ClippedAdam:
    """Adam with global-norm clipping (`max_grad_norm`) and the optional
    geometric decay `lr_anneal: {final, steps}` over optimizer steps
    (`optax.exponential_decay` with an end value). Other optimizers of
    the JAX package are not ported and raise `ValueError`."""
    opt_cls = str(train_cfg.get("opt_cls", "Adam")).lower()
    if opt_cls != "adam":
        raise ValueError(f"unsupported optimizer {opt_cls!r} (the port has "
                         "Adam only)")
    kwargs = dict(train_cfg.get("opt_kwargs") or {})
    lr = float(kwargs.pop("lr", 3e-4))
    b1, b2 = float(kwargs.pop("b1", 0.9)), float(kwargs.pop("b2", 0.999))
    eps = float(kwargs.pop("eps", 1e-8))
    if kwargs:
        raise ValueError(f"unsupported Adam arguments {sorted(kwargs)}")
    anneal = train_cfg.get("lr_anneal")
    sched: Any = lr
    if anneal:
        final, steps, init = float(anneal["final"]), int(anneal["steps"]), lr
        rate = final / init

        def sched(count: int) -> float:
            v = init * rate ** (count / steps)
            return max(v, final) if rate < 1 else min(v, final)
    return ClippedAdam(params, sched, train_cfg.get("max_grad_norm"),
                       (b1, b2), eps)


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # the net's live parameters, by name
    opt_state: ClippedAdam
    rng: torch.Tensor  # the iteration key
    buf: AvgNumJobsBuffer | None  # differential-returns window, or None
    iteration: int

    def snapshot(self) -> dict:
        """A copy of everything an update changes (for a rollback)."""
        return {"params": {k: v.detach().clone()
                           for k, v in self.params.items()},
                "opt": self.opt_state.state_dict(), "buf": self.buf}

    def restore(self, snap: dict) -> None:
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(snap["params"][k])
        self.opt_state.load_state_dict(snap["opt"])
        self.buf = snap["buf"]


# config keys whose machinery the port does not have yet
_UNPORTED_TRAIN = ("checkpointing_freq", "use_tensorboard", "profiling",
                   "profile_trace_dir")
_UNPORTED_HEALTH = ("checkpoint_every", "keep", "straggler_ratio_max")


class Trainer(abc.ABC):
    """Base trainer; subclasses implement `_update`."""

    def __init__(self, agent_cfg: CfgType, env_cfg: CfgType,
                 train_cfg: CfgType, health_cfg: CfgType | None = None,
                 device: str | torch.device = "cuda",
                 unported: list[str] | None = None) -> None:
        self.device = resolve_device(device)
        unported = list(unported or [])
        if train_cfg.get("rollout_duration") is not None:
            raise NotImplementedError(
                "asynchronous collection (rollout_duration, "
                "collect_flat_async_batch) is not ported yet")
        engine = str(train_cfg.get("rollout_engine", "core"))
        if engine != "flat" or not train_cfg.get("flat_single_eval", True):
            raise NotImplementedError(
                f"rollout_engine {engine!r} without single-eval flat "
                "collection is not ported yet (set rollout_engine: flat, "
                "flat_single_eval: true)")
        unported += [k for k in _UNPORTED_TRAIN if train_cfg.get(k)]
        if train_cfg.get("fast_prng"):
            unported.append("fast_prng (the port runs threefry)")
        self.seed: int = int(train_cfg.get("seed", 42))
        self.num_iterations: int = int(train_cfg["num_iterations"])
        self.num_sequences: int = int(train_cfg["num_sequences"])
        self.num_rollouts: int = int(train_cfg["num_rollouts"])
        self.num_envs = self.num_sequences * self.num_rollouts

        self.entropy_anneal = train_cfg.get("entropy_anneal")
        if self.entropy_anneal and "final" not in self.entropy_anneal:
            raise ValueError("entropy_anneal requires a 'final' value")
        if self.entropy_anneal and "iterations" not in self.entropy_anneal:
            raise ValueError(
                "entropy_anneal requires an explicit 'iterations' horizon "
                "(absolute iteration count, spanning resumed sessions)")
        self.fixed_sequences = bool(train_cfg.get("fixed_sequences", False))

        hc = dict(health_cfg or {})
        self.health_enabled = bool(hc.get("enabled", health_cfg is not None))
        self.health_max_retries = int(hc.get("max_retries", 2))
        self.health_backoff = float(hc.get("backoff_seconds", 1.0))
        unported += [f"health.{k}" for k in _UNPORTED_HEALTH if k in hc]

        if ("reward_buff_cap" in train_cfg) == ("beta_discount" in train_cfg):
            raise ValueError(
                "provide exactly one of reward_buff_cap / beta_discount")
        self.beta = float(train_cfg.get("beta_discount", 0.0))
        self.reward_buff_cap = int(train_cfg.get("reward_buff_cap", 0))
        if self.beta:
            env_cfg = env_cfg | {"beta": self.beta}

        self.params_env: EnvParams = env_params_from_cfg(env_cfg)
        self.bank = make_workload_bank(
            self.params_env.num_executors, self.params_env.max_stages,
            device=self.device,
            **{k: v for k, v in env_cfg.items()
               if k in ("data_dir", "bucket_size", "data_sampler_cls",
                        "bank_dtype")},
        )
        if self.bank.max_stages != self.params_env.max_stages:
            self.params_env = self.params_env.replace(
                max_stages=self.bank.max_stages,
                max_levels=max(self.params_env.max_levels,
                               self.bank.max_stages))
        self.rollout_steps = int(train_cfg.get(
            "rollout_steps", 48 * self.params_env.max_jobs))

        # the level scan bounded by the bank's true max DAG depth (exact:
        # deeper levels are no-op updates); an explicit num_levels wins
        lv = self.bank.node_level.cpu().numpy()
        bank_depth = int(np.max(np.where(lv < self.bank.max_stages, lv,
                                         -1))) + 1
        scheduler = make_scheduler(
            {"num_levels": bank_depth} | agent_cfg
            | {"num_executors": self.params_env.num_executors,
               "device": self.device})
        if not isinstance(scheduler, TrainableScheduler):
            raise TypeError("scheduler must be trainable")
        self.scheduler = scheduler
        self.scheduler.net.requires_grad_(True)
        self.flat_batch_knobs = {
            "event_bulk": bool(train_cfg.get("flat_event_bulk", True)),
            "bulk_events": int(train_cfg.get("flat_bulk_events", 8)),
            "fulfill_bulk": bool(train_cfg.get("flat_fulfill_bulk", True)),
            "bulk_cycles": int(train_cfg.get("flat_bulk_cycles", 1)),
            "bulk_fused": bool(train_cfg.get("flat_bulk_fused", True)),
        }
        self.train_cfg = train_cfg
        self.stats_log: list[dict[str, float]] = []
        self.last_rollout: Rollout | None = None
        if unported:
            print("[sparksched_tpu_torch] config keys whose machinery is "
                  f"not ported yet, ignored: {', '.join(unported)}",
                  flush=True)

    # ------------------------------------------------------------------
    # device-side pieces
    # ------------------------------------------------------------------

    def init_state(self) -> TrainState:
        params = dict(self.scheduler.net.named_parameters())
        return TrainState(
            params=params,
            opt_state=make_optimizer(self.train_cfg, list(params.values())),
            rng=prng.PRNGKey(self.seed, self.device),
            buf=(AvgNumJobsBuffer.create(self.reward_buff_cap, self.device)
                 if self.reward_buff_cap else None),
            iteration=0,
        )

    def _entropy_coeff_at(self, base: float, iteration: int) -> float:
        """Entropy coefficient at `iteration` under the optional
        geometric anneal."""
        if not self.entropy_anneal or not base:
            return base
        final = float(self.entropy_anneal["final"])
        n = float(self.entropy_anneal["iterations"])
        frac = min(max(iteration / n, 0.0), 1.0)
        return base * (final / base) ** frac

    def lane_keys(self, iteration: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(sequence keys, lane keys), [G*R, 2] each, of an iteration."""
        if self.fixed_sequences:
            iteration = 0
        master = prng.PRNGKey(self.seed)
        seq, lane = [], []
        for g in range(self.num_sequences):
            s = prng.fold_in(prng.fold_in(master, g), iteration)
            for r in range(self.num_rollouts):
                seq.append(s)
                lane.append(prng.fold_in(s, 1000 + r))
        return (torch.stack(seq).to(self.device),
                torch.stack(lane).to(self.device))

    def _collect(self, iteration: int, rng: torch.Tensor,
                 counts: dict | None = None):
        """One iteration's rollouts from fresh episodes: `(Rollout,
        health mask[B] or None)`."""
        seq_rngs, lane_rngs = self.lane_keys(iteration)
        states = core.reset_pair(self.params_env, self.bank, seq_rngs,
                                 lane_rngs)
        out = collect_flat_sync_batch(
            self.params_env, self.bank,
            lambda k, obs: self.scheduler.batch_policy(k, obs),
            prng.fold_in(rng, 7), self.rollout_steps, states,
            health=self.health_enabled, counts=counts,
            **self.flat_batch_knobs,
        )
        return out if self.health_enabled else (out, None)

    def _returns_and_baselines(self, state: TrainState, ro: Rollout):
        T = self.rollout_steps
        dts = step_dts(ro.wall_times)
        if self.beta:
            returns = discounted_returns(ro.reward, dts, self.beta)
            buf, avg_num_jobs = state.buf, None
        else:
            buf = state.buf.extend(dts, ro.reward, ro.valid)
            avg_num_jobs = buf.avg_num_jobs()
            returns = differential_returns(ro.reward, dts, avg_num_jobs)
        G, R = self.num_sequences, self.num_rollouts
        baselines = group_baselines(
            ro.wall_times[:, :T].reshape(G, R, T), returns.reshape(G, R, T),
            ro.valid.reshape(G, R, T),
        ).reshape(G * R, T)
        return returns, baselines, buf, avg_num_jobs

    @abc.abstractmethod
    def _update(self, state: TrainState, ro: Rollout):
        """One policy update from an iteration's rollouts, in place on the
        state. Returns (state, stats dict of scalars)."""

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, callback=None) -> TrainState:
        """Run `num_iterations` iterations from the scheduler's weights.
        With the health block on, an iteration whose rollout or update
        trips a retryable sentinel is rolled back to the state before it,
        reseeded and run again after an exponential backoff, at most
        `max_retries` times. `callback(i, state, stats)`, when given, is
        called after each iteration."""
        state = self.init_state()
        for i in range(state.iteration, state.iteration + self.num_iterations):
            last_good = state.snapshot()
            attempt = 0
            while True:
                rng_i = prng.fold_in(prng.PRNGKey(self.seed, self.device), i)
                if attempt:
                    rng_i = prng.fold_in(rng_i, 90_000 + attempt)
                state.rng = rng_i
                counts: dict = {}
                self._sync()
                t0 = time.perf_counter()
                ro, hm = self._collect(state.iteration, state.rng, counts)
                self._sync()
                t1 = time.perf_counter()
                state, stats = self._update(state, ro)
                self._sync()
                t2 = time.perf_counter()
                health_mask = 0
                if self.health_enabled:
                    health_mask = int(np.bitwise_or.reduce(
                        hm.cpu().numpy()))
                    health_mask |= int(stats.get("health_mask", 0))
                if health_mask & RETRYABLE_MASK:
                    if attempt >= self.health_max_retries:
                        raise RuntimeError(
                            f"iteration {i + 1} still unhealthy "
                            f"({describe_mask(health_mask)}) after "
                            f"{attempt} retries — refusing to train on a "
                            "poisoned state")
                    delay = self.health_backoff * (2.0 ** attempt)
                    print(f"[health] iteration {i + 1} attempt {attempt}: "
                          f"{describe_mask(health_mask)} -> rollback_retry "
                          f"after {delay:.3g} s", flush=True)
                    state.restore(last_good)
                    time.sleep(delay)
                    attempt += 1
                    continue
                break
            state.iteration += 1
            host = {k: float(v) for k, v in stats.items()
                    if v is not None and k not in ("avg_num_jobs_est",
                                                   "health_mask")}
            host.update(self._rollout_stats(ro))
            host.update(
                iteration=float(i), collect_seconds=t1 - t0,
                update_seconds=t2 - t1, rows=float(counts.get("rows", 0)),
                decisions=float(ro.valid.sum()),
                health_mask=float(health_mask),
                health_retries=float(attempt))
            if self.device.type == "cuda":
                host["max_memory_allocated"] = float(
                    torch.cuda.max_memory_allocated(self.device))
            self.stats_log.append(host)
            self.last_rollout = ro
            avg = stats.get("avg_num_jobs_est")
            avg = float(avg) if avg is not None else host["avg_num_jobs"]
            print(f"Iteration {i + 1} complete. Avg. # jobs: {avg:.3f}",
                  flush=True)
            if callback is not None:
                callback(i, state, host)
        return state

    def _rollout_stats(self, ro: Rollout) -> dict[str, float]:
        fs = ro.final_state
        d, m = metrics.job_durations(fs)
        pcts = metrics.masked_percentiles(d, m)
        out = {f"job_duration_p{q}": float(v)
               for q, v in zip(metrics.PERCENTILE_QS, pcts)}
        return out | {
            "avg_job_duration": float(metrics.avg_job_duration(fs).mean()),
            "avg_num_jobs": float(metrics.avg_num_jobs(fs).mean()),
            "num_completed_jobs": float(
                metrics.num_completed_jobs(fs).float().mean()),
            "num_job_arrivals": float(
                metrics.num_job_arrivals(fs).float().mean()),
            "episode_length": float(ro.valid.sum(-1).float().mean()),
        }


def make_trainer(cfg: CfgType, device: str | torch.device = "cuda"
                 ) -> Trainer:
    """String-keyed factory over `cfg["trainer"]["trainer_cls"]` (PPO).
    The top-level `obs:`, `chaos:` and `parallel:` blocks are not ported:
    their keys are named as ignored when the trainer starts."""
    from .ppo import PPO

    registry = {"PPO": PPO}
    name = cfg["trainer"]["trainer_cls"]
    if name not in registry:
        raise ValueError(f"'{name}' is not a valid trainer (the port has "
                         f"{sorted(registry)}).")
    unported = [f"{blk}.{k}" for blk in ("obs", "chaos", "parallel")
                for k in (cfg.get(blk) or {})]
    return registry[name](cfg["agent"], cfg["env"], cfg["trainer"],
                          health_cfg=cfg.get("health"), device=device,
                          unported=unported)
