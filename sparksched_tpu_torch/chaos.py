"""Deterministic fault injection (counterpart of `sparksched_tpu/chaos.py`).

A `chaos:` config block injects seeded, reproducible faults at named
iterations of training, so that every recovery path of the health
runtime can be drilled. Injection sites are host-side boundaries of the
training loop (the collected rollout, the telemetry counters, the gap
between collect and update).

Fault classes (block keys; each an iteration list):

- ``nan_grad`` — one recorded reward set to NaN: returns, advantages,
  losses and gradients go NaN, PPO's sentinel skips the minibatches and
  the trainer rolls back and retries.
- ``bank_row`` — one recorded observation's duration row (all stages of
  one job slot) set to NaN, in the buffer's own dtype (float32 or
  bfloat16 under `obs_dtype`); detected by the same sentinels.
  `corrupt_bank` is the state-level counterpart for drills that drive a
  health-threaded collector directly.
- ``straggler`` — one lane's `loop_iters` counter inflated so the
  straggler ratio passes `health.straggler_ratio_max`: quarantined, not
  retried.
- ``oom`` — a simulated out-of-memory error (`torch.OutOfMemoryError`,
  the class a real CUDA allocation failure raises) between collect and
  update; the trainer backs off and retries.
- ``sigkill`` — SIGKILL of this process after collect, before the update;
  the `health.checkpoint_every` train state resumes the run.

All but sigkill fire on `attempt == 0` only: they model transient
faults. Which lane, step and row is hit derives from `seed` and the
iteration through numpy's `default_rng(seed * 1_000_003 + iteration)`,
the JAX package's stream, so both packages hit the same indices.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any

import numpy as np
import torch

from .config import CHAOS_KEYS
from .obs.runlog import emit
from .obs.telemetry import FIELDS, Telemetry

_LOOP_ITERS = FIELDS.index("loop_iters")


def _iters(cfg: dict, key: str) -> frozenset:
    v = cfg.get(key) or ()
    if isinstance(v, int):
        v = (v,)
    return frozenset(int(x) for x in v)


class ChaosMonkey:
    """Seeded fault injector driven by a `chaos:` config block. Every
    method is a no-op for an iteration with nothing scheduled."""

    def __init__(self, cfg: dict[str, Any] | None) -> None:
        cfg = dict(cfg or {})
        unknown = set(cfg) - CHAOS_KEYS
        if unknown:
            raise ValueError(
                f"unknown chaos: config key(s) {sorted(unknown)} — "
                f"known keys: {sorted(CHAOS_KEYS)}")
        self.seed = int(cfg.get("seed", 0))
        self.nan_grad = _iters(cfg, "nan_grad")
        self.bank_row = _iters(cfg, "bank_row")
        self.straggler = _iters(cfg, "straggler")
        self.oom = _iters(cfg, "oom")
        self.sigkill = _iters(cfg, "sigkill")
        self.straggler_factor = int(cfg.get("straggler_factor", 100))

    def _rng(self, iteration: int) -> np.random.Generator:
        return np.random.default_rng(self.seed * 1_000_003 + int(iteration))

    def any_scheduled(self) -> bool:
        return bool(self.nan_grad | self.bank_row | self.straggler
                    | self.oom | self.sigkill)

    def poison_rollout(self, ro, iteration: int, attempt: int):
        """This iteration's rollout-level faults, on copies of the
        touched buffers; returns `(rollout, [fault names injected])`."""
        injected: list[str] = []
        if attempt != 0:
            return ro, injected
        rng = self._rng(iteration)
        B, T = ro.reward.shape
        if iteration in self.nan_grad:
            b, t = int(rng.integers(B)), int(rng.integers(T))
            reward = ro.reward.clone()
            reward[b, t] = float("nan")
            ro = dataclasses.replace(ro, reward=reward)
            injected.append("nan_grad")
        if iteration in self.bank_row:
            b, t = int(rng.integers(B)), int(rng.integers(T))
            j = int(rng.integers(ro.obs.duration.shape[2]))
            dur = ro.obs.duration.clone()
            dur[b, t, j] = float("nan")
            ro = dataclasses.replace(
                ro, obs=dataclasses.replace(ro.obs, duration=dur))
            injected.append("bank_row")
        return ro, injected

    def inflate_straggler(self, telem: Telemetry | None, iteration: int,
                          attempt: int):
        """Multiply one lane's `loop_iters` so that the straggler ratio
        trips the configured threshold; returns `(telemetry, [names])`."""
        if telem is None or attempt != 0 or iteration not in self.straggler:
            return telem, []
        lanes = telem.t.shape[0]
        b = int(self._rng(iteration).integers(lanes))
        t = telem.t.clone()
        t[b, _LOOP_ITERS] = (t[b, _LOOP_ITERS] + 1) * self.straggler_factor
        return Telemetry(t), ["straggler"]

    def maybe_raise_oom(self, iteration: int, attempt: int) -> None:
        if attempt == 0 and iteration in self.oom:
            raise torch.OutOfMemoryError(
                f"simulated chaos OOM at iteration {iteration} (chaos: oom)")

    def maybe_sigkill(self, iteration: int) -> None:
        """SIGKILL this process: no teardown runs, as in a preempted
        machine. Fires on every attempt."""
        if iteration in self.sigkill:
            emit(f"[chaos] SIGKILL at iteration {iteration} "
                 "(simulated preemption)")
            os.kill(os.getpid(), signal.SIGKILL)


def corrupt_bank(bank, seed: int = 0):
    """A workload bank whose duration stage row 0 (all templates, waves,
    levels and samples of stage 0) is NaN: sampled task durations, and
    then finish times and the wall clock, go NaN, which `state_health`
    must flag (H_EXEC_CONSERVE / H_NONFINITE_TIME). Stage 0 exists in
    every template, so a short episode reads it. Quantized (integer)
    banks have no NaN and raise."""
    if not bank.dur.is_floating_point():
        raise ValueError(
            "corrupt_bank needs a float dur table — quantized "
            "(int-coded) banks have no NaN representation to corrupt "
            "with; drill the default f32 bank instead")
    del seed  # kept for the JAX package's signature
    dur = bank.dur.to(torch.float32).clone()
    dur[:, 0] = float("nan")
    return dataclasses.replace(bank, dur=dur)
