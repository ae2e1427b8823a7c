"""Training orchestration (counterpart of
`sparksched_tpu/trainers/trainer.py`).

One iteration: fresh episodes on `num_sequences x num_rollouts` lanes
(the lanes of a sequence group share the job-sequence key), the
single-eval flat collector, returns and the group baselines, then the
trainer's `_update`. The seed layout is the JAX package's: the sequence
key of group g at iteration i is `fold_in(fold_in(PRNGKey(seed), g), i)`,
lane r of it `fold_in(seq, 1000 + r)`, the iteration key
`fold_in(PRNGKey(seed), i)` (`fold_in(·, 90_000 + attempt)` on a health
retry) and the collector's `fold_in(iteration key, 7)`. Every one of them
is a threefry2x32 key, or an rbg key with `fast_prng: True` (the JAX
package's `use_fast_prng`, which switches its whole training program).

Ported: `rollout_engine: flat` with `flat_single_eval` in sync mode, the
Adam optimizer (`lr_anneal`, global-norm clipping as optax writes it),
`fixed_sequences`, `entropy_anneal`, `beta_discount` or the differential
returns, the health block (rollback-and-retry with reseed and backoff,
the `straggler_ratio_max` quarantine, `checkpoint_every` / `keep`, the
out-of-memory retry), the `chaos:` block's fault injection, `fast_prng`,
checkpoints and resume (`checkpointing_freq`: the best pre-update
parameters as a flax-msgpack `model.msgpack` either package loads;
`save_train_state` / `load_train_state` / `train(resume_from=)`, the
train state written with the port's codec under the JAX package's file
names) and the `obs:` block's run log, telemetry and memory samples.
Not ported yet (the trainer names the keys it ignores when it starts):
asynchronous collection (`rollout_duration`) and the `core` engine (both
raise), TensorBoard and the profiler, `obs.trace_iteration` /
`trace_dir` / `slo`. A train state of the JAX package does not load
here (its optax tree differs); model files load both ways.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import functools
import hashlib
import json
import os
import os.path as osp
import shutil
import time
from typing import Any

import numpy as np
import torch

from .. import metrics, prng
from ..chaos import ChaosMonkey
from ..config import EnvParams, env_params_from_cfg, resolve_device
from ..env import core
from ..env.health import H_OOM, H_STRAGGLER, RETRYABLE_MASK, describe_mask
from ..obs.memory import device_memory_stats
from ..obs.runlog import RunLog, emit
from ..obs.telemetry import summarize, telemetry_zeros
from ..schedulers import TrainableScheduler, make_scheduler
from ..schedulers.decima import params_from_flax
from ..serialization import from_bytes, params_to_flax, to_bytes
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
_UNPORTED_TRAIN = ("use_tensorboard", "profiling", "profile_trace_dir")
_UNPORTED_OBS = ("trace_iteration", "trace_dir", "slo")
OBS_KEYS = frozenset({"runlog", "telemetry", "memory", "runlog_max_bytes"}
                     | set(_UNPORTED_OBS))
HEALTH_KEYS = frozenset({"enabled", "max_retries", "backoff_seconds",
                         "checkpoint_every", "keep", "straggler_ratio_max"})
# update stats the JAX package's `scalars` records do not carry
_PORT_ONLY_STATS = ("minibatches_applied", "kl_stopped", "update_chunks")


@functools.lru_cache(maxsize=None)
def lane_paths(G: int, R: int, device: torch.device) -> torch.Tensor:
    """`Trainer.lane_keys`' paths from the master key, [2, G*R, 3]: the
    sequence keys (g, iteration) and the lane keys (g, iteration,
    1000 + r), the iteration the table's varying counter."""
    it = prng.PATH_VAR
    rows = [(g, it) for g in range(G) for _ in range(R)]
    rows += [(g, it, 1000 + r) for g in range(G) for r in range(R)]
    return prng.path_table(rows, device, (2, G * R))


class Trainer(abc.ABC):
    """Base trainer; subclasses implement `_update`."""

    def __init__(self, agent_cfg: CfgType, env_cfg: CfgType,
                 train_cfg: CfgType, health_cfg: CfgType | None = None,
                 device: str | torch.device = "cuda",
                 unported: list[str] | None = None,
                 obs_cfg: CfgType | None = None,
                 chaos_cfg: CfgType | None = None) -> None:
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
        # the impl of every key of the run (the JAX package's names; the
        # stamp of its train states): rbg keys are four words, threefry's
        # two, so a train state resumes only under the impl that wrote it
        self.prng_impl = ("rbg" if train_cfg.get("fast_prng", False)
                          else "threefry2x32")
        self.seed: int = int(train_cfg.get("seed", 42))
        self.num_iterations: int = int(train_cfg["num_iterations"])
        self.num_sequences: int = int(train_cfg["num_sequences"])
        self.num_rollouts: int = int(train_cfg["num_rollouts"])
        self.num_envs = self.num_sequences * self.num_rollouts
        self.artifacts_dir: str = str(train_cfg.get("artifacts_dir",
                                                    "artifacts"))
        self.checkpointing_freq = int(train_cfg.get("checkpointing_freq",
                                                    50))

        # the obs: block (runlog: true | false | path, runlog_max_bytes,
        # telemetry, memory), validated like the JAX package's
        oc = dict(obs_cfg or {})
        if set(oc) - OBS_KEYS:
            raise ValueError(
                f"unknown obs: config key(s) {sorted(set(oc) - OBS_KEYS)} "
                f"— known keys: {sorted(OBS_KEYS)}")
        self.obs_runlog = oc.get("runlog", True)
        rmb = oc.get("runlog_max_bytes")
        self.obs_runlog_max_bytes = int(rmb) if rmb else None
        self.obs_telemetry = bool(oc.get("telemetry", False))
        self.obs_memory = bool(oc.get("memory", True))
        unported += [f"obs.{k}" for k in _UNPORTED_OBS
                     if oc.get(k) is not None]
        self._runlog: RunLog | None = None

        self.entropy_anneal = train_cfg.get("entropy_anneal")
        if self.entropy_anneal and "final" not in self.entropy_anneal:
            raise ValueError("entropy_anneal requires a 'final' value")
        if self.entropy_anneal and "iterations" not in self.entropy_anneal:
            raise ValueError(
                "entropy_anneal requires an explicit 'iterations' horizon "
                "(absolute iteration count, spanning resumed sessions)")
        self.fixed_sequences = bool(train_cfg.get("fixed_sequences", False))

        hc = dict(health_cfg or {})
        if set(hc) - HEALTH_KEYS:
            raise ValueError(
                f"unknown health: config key(s) {sorted(set(hc) - HEALTH_KEYS)}"
                f" — known keys: {sorted(HEALTH_KEYS)}")
        self.health_enabled = bool(hc.get("enabled", health_cfg is not None))
        self.health_max_retries = int(hc.get("max_retries", 2))
        self.health_backoff = float(hc.get("backoff_seconds", 1.0))
        self.health_checkpoint_every = int(hc.get("checkpoint_every", 0))
        self.checkpoint_keep = int(hc.get("keep", 2))
        srm = hc.get("straggler_ratio_max")
        self.health_straggler_max = None if srm is None else float(srm)
        if self.health_enabled:  # as in the JAX package
            self.obs_telemetry = True

        # seeded fault injection (the top-level `chaos:` block), which
        # drills the recovery paths above
        self._chaos = None
        if chaos_cfg:
            self._chaos = ChaosMonkey(chaos_cfg)
            if self._chaos.any_scheduled() and not self.health_enabled:
                emit("[chaos] warning: chaos: faults scheduled without a "
                     "health: block — injections will NOT be detected or "
                     "recovered (this is only useful for negative tests)")

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
            rng=self.seed_key(),
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

    def seed_key(self, device=None) -> torch.Tensor:
        """`PRNGKey(seed)` under the run's impl, on the trainer's device
        unless another is named."""
        return prng.PRNGKey(self.seed, device or self.device,
                            impl=self.prng_impl)

    def lane_keys(self, iteration: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(sequence keys, lane keys), [G*R, W] each, of an iteration: for
        g, r the sequence key `fold_in(fold_in(master, g), iteration)` and
        the lane key its `fold_in(., 1000 + r)`, all from the master key
        in one launch (the iteration is the table's varying counter)."""
        if self.fixed_sequences:
            iteration = 0
        paths = lane_paths(self.num_sequences, self.num_rollouts,
                           torch.device(self.device))
        keys = prng.derive(self.seed_key(), paths, var=iteration)
        return keys.unbind(0)

    def _collect(self, iteration: int, rng: torch.Tensor,
                 counts: dict | None = None):
        """One iteration's rollouts from fresh episodes: `(Rollout,
        health mask[B] or None)`. `counts`, when given, receives the rows
        run (`rows`) and, with telemetry on, the lanes' counters
        (`telemetry`)."""
        seq_rngs, lane_rngs = self.lane_keys(iteration)
        states = core.reset_pair(self.params_env, self.bank, seq_rngs,
                                 lane_rngs)
        tm = (telemetry_zeros(self.num_envs, self.device)
              if self.obs_telemetry else None)
        out = collect_flat_sync_batch(
            self.params_env, self.bank,
            self.scheduler.lane_policy,
            prng.fold_in(rng, 7), self.rollout_steps, states,
            health=self.health_enabled, counts=counts, telemetry=tm,
            split_policy_keys=True,
            **self.flat_batch_knobs,
        )
        if tm is not None:
            *out, tm = out
            if counts is not None:
                counts["telemetry"] = tm
            out = out[0] if len(out) == 1 else tuple(out)
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

    def train(self, resume_from: str | None = None,
              callback=None) -> TrainState:
        """Run `num_iterations` more iterations from the scheduler's
        weights or, with `resume_from`, from a saved train state (see
        `load_train_state`). With the health block on, an iteration whose
        rollout or update trips a retryable sentinel is rolled back to the
        state before it, reseeded and run again after an exponential
        backoff, at most `max_retries` times; a straggler ratio over
        `straggler_ratio_max` is quarantined (a `health` record, no
        retry). Every `checkpointing_freq` iterations the best pre-update
        parameters by `avg_num_jobs` go to
        `checkpoints/<i+1>/model.msgpack` with `state.json`; every
        `health.checkpoint_every` iterations, and always at the end, the
        train state to `train_state.msgpack`. `callback(i, state, stats)`,
        when given, is called after each iteration."""
        self._setup(fresh=resume_from is None)
        if resume_from:
            state = self.load_train_state(resume_from)
            emit(f"Resumed from {resume_from} at iteration "
                 f"{state.iteration}.")
            if self._runlog is not None:
                self._runlog.write("resume", path=resume_from,
                                   iteration=state.iteration)
        else:
            state = self.init_state()
        best: dict[str, Any] | None = None
        start = state.iteration
        for i in range(start, start + self.num_iterations):
            last_good = state.snapshot()
            attempt = 0
            while True:
                rng_i = prng.fold_in(self.seed_key(), i)
                if attempt:
                    rng_i = prng.fold_in(rng_i, 90_000 + attempt)
                state.rng = rng_i
                counts: dict = {}
                self._sync()
                t0 = time.perf_counter()
                oom = False
                try:
                    ro, hm = self._collect(state.iteration, state.rng,
                                           counts)
                    self._sync()
                    t1 = time.perf_counter()
                    self._span(f"iter {i + 1} collect", t1 - t0)
                    if self._chaos is not None:
                        ro = self._inject(ro, counts, i, attempt)
                    state, stats = self._update(state, ro)
                    self._sync()
                except torch.OutOfMemoryError as e:
                    # a real CUDA allocation failure or the simulated one:
                    # with the health block on, roll back and retry
                    if not (self.health_enabled
                            and self._record_health_and_retry(
                                i, attempt, H_OOM, detail=str(e)[:300])):
                        raise
                    oom = True
                if oom:
                    # the failed attempt's tensors are dropped (the
                    # exception and its frames with them) before the
                    # allocator's cache is returned to the card
                    ro = hm = counts = None
                    state.restore(last_good)
                    if self.device.type == "cuda":
                        torch.cuda.empty_cache()
                    attempt += 1
                    continue
                t2 = time.perf_counter()
                self._span(f"iter {i + 1} update", t2 - t1)
                tm = counts.get("telemetry")
                tsum = summarize(tm) if tm is not None else None
                health_mask = 0
                if self.health_enabled:
                    health_mask = int(np.bitwise_or.reduce(
                        hm.cpu().numpy()))
                    health_mask |= int(stats.get("health_mask", 0))
                    if (self.health_straggler_max is not None
                            and tsum is not None
                            and tsum["straggler_ratio"]
                            > self.health_straggler_max):
                        health_mask |= H_STRAGGLER
                if health_mask & RETRYABLE_MASK:
                    if not self._record_health_and_retry(i, attempt,
                                                         health_mask):
                        raise RuntimeError(
                            f"iteration {i + 1} still unhealthy "
                            f"({describe_mask(health_mask)}) after "
                            f"{attempt} retr"
                            f"{'y' if attempt == 1 else 'ies'} — refusing "
                            "to train on a poisoned state")
                    state.restore(last_good)
                    attempt += 1
                    continue
                if health_mask:  # non-retryable bits: quarantine
                    self._record_health(i, attempt, health_mask,
                                        action="quarantine")
                break
            state.iteration += 1
            roll_stats = self._rollout_stats(ro)
            avg = float(stats.get("avg_num_jobs_est")
                        or roll_stats["avg_num_jobs"])
            if best is None or avg < best["avg_num_jobs"]:
                best = {
                    "iteration": i,
                    "avg_num_jobs": round(avg, 3),
                    "params": params_to_flax(last_good["params"]),
                    "completed_job_count": int(
                        roll_stats["num_completed_jobs"]),
                }
            if (i + 1) % self.checkpointing_freq == 0:
                self._checkpoint(i, best)
                best = None

            scalars = {k: float(v) for k, v in stats.items()
                       if v is not None and k not in (
                           "avg_num_jobs_est", "health_mask")
                       + _PORT_ONLY_STATS}
            scalars["collect_seconds"] = t1 - t0
            scalars["update_seconds"] = t2 - t1
            if self.health_enabled:
                scalars["health_mask"] = float(health_mask)
                scalars["health_retries"] = float(attempt)
            if tsum is not None:
                if self._runlog is not None:
                    self._runlog.telemetry(tsum, iteration=i)
                for k in ("straggler_ratio", "micro_per_decision",
                          "events_per_decision"):
                    scalars[k] = tsum[k]
            if self.obs_memory:
                mem = device_memory_stats(self.device)
                if mem is not None:
                    if self._runlog is not None:
                        self._runlog.memory(mem, iteration=i)
                    scalars["mem_bytes_in_use"] = mem["bytes_in_use"]
                    scalars["mem_peak_bytes"] = mem["peak_bytes_in_use"]
            if self._runlog is not None:
                self._runlog.scalars(i, scalars | roll_stats)
            if (self.health_enabled and self.health_checkpoint_every
                    and (i + 1) % self.health_checkpoint_every == 0):
                self.save_train_state(
                    state, osp.join(self.artifacts_dir, "train_state.msgpack"))

            host = {k: float(v) for k, v in stats.items()
                    if v is not None and k not in ("avg_num_jobs_est",
                                                   "health_mask")}
            host.update(roll_stats)
            host.update(
                iteration=float(i), collect_seconds=t1 - t0,
                update_seconds=t2 - t1, rows=float(counts.get("rows", 0)),
                decisions=float(ro.valid.sum()),
                health_mask=float(health_mask),
                health_retries=float(attempt))
            if tsum is not None:
                host["telemetry_decisions"] = float(tsum["decisions"])
            if self.device.type == "cuda":
                host["max_memory_allocated"] = float(
                    torch.cuda.max_memory_allocated(self.device))
            self.stats_log.append(host)
            self.last_rollout = ro
            emit(f"Iteration {i + 1} complete. Avg. # jobs: {avg:.3f}")
            if callback is not None:
                callback(i, state, host)
        self._cleanup(state)
        return state

    # ------------------------------------------------------------------
    # health recording
    # ------------------------------------------------------------------

    def _span(self, name: str, secs: float) -> None:
        if self._runlog is not None:
            self._runlog.span_event(name, secs)

    def _inject(self, ro: Rollout, counts: dict, i: int, attempt: int
                ) -> Rollout:
        """The `chaos:` block's faults for this attempt, between collect
        and update as in the JAX package: the rollout poisoned, the
        telemetry inflated (in `counts`), a `chaos` run-log record, then a
        SIGKILL or a simulated out-of-memory error if scheduled."""
        ro, injected = self._chaos.poison_rollout(ro, i, attempt)
        tm, more = self._chaos.inflate_straggler(counts.get("telemetry"), i,
                                                 attempt)
        if more:
            counts["telemetry"] = tm
        injected += more
        if injected and self._runlog is not None:
            self._runlog.write("chaos", iteration=i, attempt=attempt,
                               injected=injected)
        self._chaos.maybe_sigkill(i)
        self._chaos.maybe_raise_oom(i, attempt)
        return ro

    def _record_health(self, i: int, attempt: int, mask: int, action: str,
                       **fields: Any) -> None:
        """A runlog `health` record and a console line."""
        if self._runlog is not None:
            self._runlog.health(mask, iteration=i, attempt=attempt,
                                action=action, **fields)
        emit(f"[health] iteration {i + 1} attempt {attempt}: "
             f"{describe_mask(mask) or [hex(mask)]} -> {action}")

    def _record_health_and_retry(self, i: int, attempt: int, mask: int,
                                 **fields: Any) -> bool:
        """Record a tripped sentinel and decide: True means "back off
        (slept here) and run the iteration again", False that the retry
        budget is spent. `fields` go into the `health` record."""
        if attempt >= self.health_max_retries:
            self._record_health(i, attempt, mask, action="gave_up",
                                **fields)
            if self._runlog is not None:
                self._runlog.write("recovery", iteration=i, attempt=attempt,
                                   action="gave_up", mask=int(mask),
                                   bits=describe_mask(mask))
            return False
        delay = self.health_backoff * (2.0 ** attempt)
        self._record_health(i, attempt, mask, action="rollback_retry",
                            backoff_seconds=round(delay, 3), **fields)
        if self._runlog is not None:
            self._runlog.write("recovery", iteration=i, attempt=attempt,
                               action="rollback_retry", mask=int(mask),
                               bits=describe_mask(mask),
                               backoff_seconds=round(delay, 3))
        time.sleep(delay)
        return True

    # ------------------------------------------------------------------
    # artifacts: checkpoints, train states, the run log
    # ------------------------------------------------------------------

    def _setup(self, fresh: bool = True) -> None:
        """The artifacts and checkpoint directories (the latter emptied on
        a fresh run) and the run log with its `run_start` record."""
        os.makedirs(self.artifacts_dir, exist_ok=True)
        self.checkpointing_dir = osp.join(self.artifacts_dir, "checkpoints")
        if fresh:
            shutil.rmtree(self.checkpointing_dir, ignore_errors=True)
        os.makedirs(self.checkpointing_dir, exist_ok=True)
        if self.obs_runlog and self._runlog is None:
            if isinstance(self.obs_runlog, str):
                self._runlog = RunLog(self.obs_runlog,
                                      max_bytes=self.obs_runlog_max_bytes)
            else:
                self._runlog = RunLog.create(
                    self.artifacts_dir, max_bytes=self.obs_runlog_max_bytes)
            self._runlog.write(
                "run_start", trainer=type(self).__name__,
                num_iterations=self.num_iterations, num_envs=self.num_envs,
                rollout_steps=self.rollout_steps, rollout_engine="flat",
                telemetry=self.obs_telemetry, memory=self.obs_memory,
                seed=self.seed)

    def _cleanup(self, state: TrainState) -> None:
        """The final train state, always, and the run log's `run_end`."""
        self.save_train_state(
            state, osp.join(self.artifacts_dir, "train_state.msgpack"))
        if self._runlog is not None:
            self._runlog.close(iteration=state.iteration)
            self._runlog = None
        emit("\nTraining complete.")

    def _checkpoint(self, i: int, best: dict[str, Any]) -> None:
        """`checkpoints/<i+1>/model.msgpack` (the best parameters, the JAX
        package's layout) and `state.json` (iteration, avg_num_jobs,
        completed_job_count)."""
        d = osp.join(self.checkpointing_dir, f"{i + 1}")
        os.makedirs(d, exist_ok=True)
        with open(osp.join(d, "model.msgpack"), "wb") as fp:
            fp.write(to_bytes(best["params"]))
        with open(osp.join(d, "state.json"), "w") as fp:
            json.dump({k: v for k, v in best.items() if k != "params"}, fp)

    def train_state_tree(self, state: TrainState) -> dict:
        """The train state as nested dicts of numpy arrays: the parameters
        in the JAX package's layout, `ClippedAdam`'s count (the learning
        rate schedule's position) and torch Adam's per-parameter `step`,
        `exp_avg` and `exp_avg_sq`, the rng key (uint32[2] under
        threefry2x32, uint32[4] under rbg), the
        differential-returns window and the iteration."""
        opt = state.opt_state
        names = list(state.params)
        moments: dict[str, dict] = {"step": {}, "exp_avg": {},
                                    "exp_avg_sq": {}}
        by_param = opt.opt.state
        for name in names:
            st = by_param.get(state.params[name])
            if not st:
                continue
            for k in moments:
                moments[k][name] = np.asarray(
                    torch.as_tensor(st[k]).detach().cpu().numpy())
        buf = None
        if state.buf is not None:
            buf = {"dt": state.buf.dt.cpu().numpy(),
                   "r": state.buf.r.cpu().numpy(),
                   "ptr": state.buf.ptr.cpu().numpy()}
        return {
            "params": params_to_flax(state.params),
            "opt_state": {"count": int(opt.count), **moments},
            "rng": state.rng.cpu().numpy().astype(np.uint32),
            "buf": buf,
            "iteration": int(state.iteration),
        }

    def _state_from_tree(self, tree: dict) -> TrainState:
        """The TrainState a `train_state_tree` holds, the parameters
        loaded into the scheduler's net and the moments onto its
        device. Raises (ValueError, KeyError, TypeError) on a tree of
        another shape, before anything is loaded."""
        sd = params_from_flax(tree["params"])
        own = dict(self.scheduler.net.named_parameters())
        if set(sd) != set(own) or any(sd[k].shape != own[k].shape
                                      for k in own):
            raise ValueError("the parameters do not match the net")
        ost = tree["opt_state"]
        moments = {}
        for i, name in enumerate(own):
            if name in ost["exp_avg"]:
                moments[i] = {
                    "step": torch.tensor(np.asarray(ost["step"][name],
                                                    np.float32)),
                    "exp_avg": torch.from_numpy(np.asarray(
                        ost["exp_avg"][name], np.float32)),
                    "exp_avg_sq": torch.from_numpy(np.asarray(
                        ost["exp_avg_sq"][name], np.float32)),
                }
        rng = np.asarray(tree["rng"], np.uint32)
        width = prng.IMPL_WIDTH[self.prng_impl]
        if rng.shape != (width,):
            raise ValueError(
                f"rng of shape {rng.shape}, not a {self.prng_impl} key "
                f"(uint32[{width}]) — the state was saved under a different "
                "PRNG impl (trainer config `fast_prng`)")
        buf = tree["buf"]
        if (buf is None) != (not self.reward_buff_cap):
            raise ValueError("the returns window does not match the config")
        self.scheduler.load_params(sd)
        state = self.init_state()
        template = state.opt_state.opt.state_dict()
        state.opt_state.load_state_dict({
            "count": int(ost["count"]),
            "opt": {"state": moments,
                    "param_groups": template["param_groups"]},
        })
        state.rng = torch.from_numpy(rng.astype(np.int64)).to(self.device)
        if buf is not None:
            state.buf = AvgNumJobsBuffer(
                dt=torch.from_numpy(np.asarray(buf["dt"], np.float32)).to(
                    self.device),
                r=torch.from_numpy(np.asarray(buf["r"], np.float32)).to(
                    self.device),
                ptr=torch.as_tensor(np.asarray(buf["ptr"]),
                                    dtype=torch.int32, device=self.device))
        state.iteration = int(tree["iteration"])
        return state

    def save_train_state(self, state: TrainState, path: str,
                         keep: int | None = None) -> None:
        """Atomic, digest-stamped, keep-last-K train-state write: the
        state's bytes (`train_state_tree` through the port's codec) to a
        tmp file, fsynced, then the earlier generations rotated (`path.1`
        the previous one, up to `keep - 1`; a torn generation is dropped,
        never promoted over an intact one) and `os.replace` into place,
        with `path.meta.json` holding `prng_impl`, `sha256` and
        `iteration`."""
        keep = self.checkpoint_keep if keep is None else int(keep)
        data = to_bytes(self.train_state_tree(state))
        meta = {"prng_impl": self.prng_impl,
                "sha256": hashlib.sha256(data).hexdigest(),
                "iteration": int(state.iteration)}

        def fsync_write(target: str, payload, mode: str) -> None:
            tmp = target + ".tmp"
            with open(tmp, mode) as fp:
                fp.write(payload)
                fp.flush()
                os.fsync(fp.fileno())
            os.replace(tmp, target)

        for g in range(keep - 1, 0, -1):
            src = path if g == 1 else f"{path}.{g - 1}"
            if not osp.exists(src):
                continue
            if not _intact(src):
                emit(f"[checkpoint] discarding torn generation {src} "
                     "instead of rotating it over an intact one")
                os.remove(src)
                if osp.exists(src + ".meta.json"):
                    os.remove(src + ".meta.json")
                continue
            os.replace(src, f"{path}.{g}")
            if osp.exists(src + ".meta.json"):
                os.replace(src + ".meta.json", f"{path}.{g}.meta.json")
        fsync_write(path, data, "wb")
        fsync_write(path + ".meta.json", json.dumps(meta), "w")

    def load_train_state(self, path: str) -> TrainState:
        """A verified load with fallback: each generation (`path`,
        `path.1`, ...) is checked against its meta digest and decoded; a
        torn or unreadable one is skipped (a console line and a runlog
        `recovery` record name what was skipped). A `prng_impl` other
        than the run's raises at once, naming the `fast_prng` value to
        set: that is the config, not a torn file. Nothing is
        unpickled."""
        candidates = [path] + [f"{path}.{g}"
                               for g in range(1, max(self.checkpoint_keep, 2))]
        errors: list[str] = []
        for cand in candidates:
            if not osp.exists(cand):
                continue
            digest = None
            meta_path = cand + ".meta.json"
            if osp.exists(meta_path):
                with open(meta_path) as fp:
                    meta = json.load(fp)
                saved = meta.get("prng_impl", self.prng_impl)
                if saved != self.prng_impl:
                    raise ValueError(
                        f"train state {cand} was saved under PRNG impl "
                        f"{saved!r} but this process uses "
                        f"{self.prng_impl!r} — set `fast_prng: "
                        f"{saved == 'rbg'}` in the trainer config before "
                        "resuming")
                digest = meta.get("sha256")
            with open(cand, "rb") as fp:
                data = fp.read()
            if digest is not None and (
                    hashlib.sha256(data).hexdigest() != digest):
                errors.append(f"{cand}: sha256 mismatch (torn write?)")
                continue
            try:
                restored = self._state_from_tree(from_bytes(data))
            except (ValueError, KeyError, TypeError) as e:
                errors.append(f"{cand}: {e}")
                continue
            if errors:
                emit(f"[checkpoint] fell back to {cand} — skipped: "
                     + "; ".join(errors))
                if self._runlog is not None:
                    self._runlog.write("recovery",
                                       action="checkpoint_fallback",
                                       loaded=cand, skipped=errors)
            return restored
        raise ValueError(
            f"could not restore {path}: no intact generation among "
            f"{candidates} ({'; '.join(errors) or 'none found'}) — if "
            "the error is a shape mismatch on `rng`, the state was "
            "saved under a different PRNG impl (trainer config "
            "`fast_prng`)")

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


def _intact(gen: str) -> bool:
    """Does a train-state generation match its meta digest? One without
    a digest passes."""
    meta_p = gen + ".meta.json"
    if not osp.exists(meta_p):
        return True
    try:
        with open(meta_p) as fp:
            want = json.load(fp).get("sha256")
        if want is None:
            return True
        with open(gen, "rb") as fp:
            return hashlib.sha256(fp.read()).hexdigest() == want
    except (OSError, ValueError):
        return False


def make_trainer(cfg: CfgType, device: str | torch.device = "cuda"
                 ) -> Trainer:
    """String-keyed factory over `cfg["trainer"]["trainer_cls"]` (PPO),
    with the top-level `health:`, `obs:` and `chaos:` blocks. The
    `parallel:` block is not ported: its keys are named as ignored when
    the trainer starts."""
    from .ppo import PPO

    registry = {"PPO": PPO}
    name = cfg["trainer"]["trainer_cls"]
    if name not in registry:
        raise ValueError(f"'{name}' is not a valid trainer (the port has "
                         f"{sorted(registry)}).")
    unported = [f"parallel.{k}" for k in (cfg.get("parallel") or {})]
    return registry[name](cfg["agent"], cfg["env"], cfg["trainer"],
                          health_cfg=cfg.get("health"), device=device,
                          unported=unported, obs_cfg=cfg.get("obs"),
                          chaos_cfg=cfg.get("chaos"))
