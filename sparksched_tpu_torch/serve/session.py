"""Persistent decision-serving sessions (counterpart of
`sparksched_tpu/serve/session.py`: `SessionStore` with `create`,
`close`, `decide`, `step`, `decide_batch`, `set_params` and health
quarantine, for one slot group).

A `SessionStore` holds one live simulated cluster (`LoopState`) per
tenant in a [capacity]-stacked store on the device, updated in place by
the serve programs (`serve/aot.py`). Session ids are slot indices.
Every served decision carries the health sentinel mask; a non-zero mask
quarantines the session: it is never served again (decide/step raise
`SessionQuarantined`) until `close` frees its id.

Waiting for later slices: the host pager (`hot_capacity`), slot groups
and the pipelined window, the harvester, the dp mesh, record/ring
trajectories, metrics and tracing, the batching fronts, and stochastic
serving; the store serves greedy decisions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .. import prng
from ..config import EnvParams, resolve_device
from ..env import core
from ..env.core import check_knobs
from ..env.flat_loop import init_loop_state, tree_map, write_slot
from ..workload.bank import WorkloadBank
from .aot import SERVE_KNOBS, serve_decide_batch_fn, serve_decide_fn


class SessionError(KeyError):
    """Unknown / closed session id."""


class SessionQuarantined(RuntimeError):
    """The session's health sentinel tripped; it will not be served."""


class ServeResult:
    """Host-side view of one served decision (plain Python scalars).
    `params_version` is the store's parameter version at dispatch."""

    __slots__ = (
        "session_id", "stage_idx", "job_idx", "num_exec", "lgprob",
        "decided", "done", "reward", "dt", "wall_time", "health_mask",
        "batched", "params_version",
    )

    def __init__(self, session_id: int, out: dict[str, np.ndarray], i: int,
                 batched: bool, params_version: int = 0) -> None:
        self.session_id = session_id
        self.stage_idx = int(out["stage_idx"][i])
        self.job_idx = int(out["job_idx"][i])
        self.num_exec = int(out["num_exec"][i])
        self.lgprob = float(out["lgprob"][i])
        self.decided = bool(out["decided"][i])
        self.done = bool(out["done"][i])
        self.reward = float(out["reward"][i])
        self.dt = float(out["dt"][i])
        self.wall_time = float(out["wall_time"][i])
        self.health_mask = int(out["health_mask"][i])
        self.batched = batched
        self.params_version = int(params_version)

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


def _to_host(out) -> dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in vars(out).items()}


class SessionStore:
    """`capacity` sessions on `device` (the card unless the caller asks
    for the CPU), served greedily through two programs: one session at
    a time, or up to `max_batch` in one batched policy evaluation."""

    def __init__(
        self,
        params: EnvParams,
        bank: WorkloadBank,
        scheduler,
        capacity: int = 64,
        *,
        max_batch: int = 8,
        seed: int = 0,
        knobs: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        dev = resolve_device(device)
        self.knobs = SERVE_KNOBS | (knobs or {})
        check_knobs(self.knobs)
        for name, d in (("bank", bank.device), ("scheduler", scheduler.device)):
            if torch.device(d).type != dev.type:
                raise ValueError(f"{name} lives on {d}, the store on {dev}")
        if not 1 <= max_batch <= capacity:
            raise ValueError(
                f"max_batch={max_batch} must be in [1, capacity={capacity}]"
            )
        self.params = params
        self.bank = bank
        self.scheduler = scheduler
        self.device = dev
        self.capacity = int(capacity)
        self.max_batch = int(max_batch)
        self._base_key = prng.PRNGKey(seed, dev)
        # calls served so far: call i runs on fold_in(base key, i). The
        # JAX store's two warm-up calls take keys 1 and 2.
        self._calls = 2
        self.params_version = 0

        pol, bpol = scheduler.serve_param_policies()
        self._decide1 = serve_decide_fn(params, bank, pol, self.knobs)
        self._decidek = serve_decide_batch_fn(
            params, bank, bpol, self.max_batch, self.knobs
        )
        # every slot starts as a copy of one dummy episode; create()
        # overwrites a slot with its own seeded reset
        ls0 = self._reset1(prng.fold_in(self._base_key, 2**19))
        self.store = tree_map(
            lambda a: a.expand((self.capacity,) + a.shape[1:]).clone(), ls0
        )
        self._live = np.zeros(self.capacity, bool)
        self._quarantined = np.zeros(self.capacity, bool)
        # [cap-1 .. 0] so pop() hands out 0, 1, 2, ... on a fresh store
        self._free_sids = list(range(self.capacity - 1, -1, -1))
        self.stats = {
            "serve_decisions": 0,
            "serve_batched_decisions": 0,
            "serve_batch_calls": 0,
            "serve_quarantines": 0,
            "serve_sessions_live": 0,
            "serve_capacity_rejections": 0,
            "serve_param_swaps": 0,
            "serve_param_version": 0,
        }

    def _next_key(self) -> torch.Tensor:
        self._calls += 1
        return prng.fold_in(self._base_key, self._calls)

    def _reset1(self, key: torch.Tensor):
        return init_loop_state(core.reset(self.params, self.bank, key[None]))

    # -- parameters --------------------------------------------------------

    def set_params(self, model_params: dict[str, Any],
                   version: int | None = None) -> int:
        """Swap the serving weights (a state dict of the scheduler's
        net) between calls. Names and shapes must match the live ones."""
        cur = self.scheduler.params
        if set(model_params) != set(cur):
            raise ValueError("set_params: parameter names do not match")
        for k, v in model_params.items():
            if tuple(np.shape(v)) != tuple(cur[k].shape):
                raise ValueError(
                    f"set_params: {k} has shape {tuple(np.shape(v))}, "
                    f"the live one {tuple(cur[k].shape)}"
                )
        self.scheduler.load_params(model_params)
        self.params_version = (
            self.params_version + 1 if version is None else int(version)
        )
        self.stats["serve_param_swaps"] += 1
        self.stats["serve_param_version"] = self.params_version
        return self.params_version

    # -- session lifecycle -------------------------------------------------

    def create(self, seed: int | None = None) -> int:
        """Reset a fresh episode into a free session; returns its id.
        Raises `RuntimeError` when the store is full."""
        if not self._free_sids:
            self.stats["serve_capacity_rejections"] += 1
            raise RuntimeError(
                f"session store full ({self.capacity} sessions live "
                "or quarantined); close sessions first"
            )
        sid = self._free_sids.pop()
        k = (
            prng.fold_in(self._base_key, 2**20 + sid)
            if seed is None else prng.PRNGKey(seed, self.device)
        )
        write_slot(self.store, torch.tensor([sid], device=self.device),
                   self._reset1(k))
        self._live[sid] = True
        self.stats["serve_sessions_live"] = int(self._live.sum())
        return sid

    def close(self, sid: int) -> None:
        self._check_sid(sid, allow_quarantined=True)
        self._live[sid] = False
        self._quarantined[sid] = False
        self._free_sids.append(sid)
        self.stats["serve_sessions_live"] = int(self._live.sum())

    def _check_sid(self, sid: int, allow_quarantined: bool = False) -> None:
        if not 0 <= sid < self.capacity or not self._live[sid]:
            raise SessionError(f"unknown session id {sid}")
        if self._quarantined[sid] and not allow_quarantined:
            raise SessionQuarantined(
                f"session {sid} is quarantined (health sentinel "
                "tripped); close it and create a fresh one"
            )

    def _apply_health(self, sid: int, mask: int) -> None:
        if mask != 0:
            self._quarantined[sid] = True
            self.stats["serve_quarantines"] += 1

    # -- serving -----------------------------------------------------------

    def _one(self, sid: int, stage_idx: int, num_exec: int,
             use_force: bool) -> ServeResult:
        self._check_sid(sid)
        ver = self.params_version
        out = _to_host(self._decide1(self.store, sid, self._next_key(),
                                     stage_idx, num_exec, use_force))
        res = ServeResult(sid, out, 0, batched=False, params_version=ver)
        self._apply_health(sid, res.health_mask)
        self.stats["serve_decisions"] += 1
        return res

    def decide(self, sid: int) -> ServeResult:
        """One policy decision on the single-session path."""
        return self._one(sid, -1, 0, False)

    def step(self, sid: int, stage_idx: int, num_exec: int) -> ServeResult:
        """Apply a CALLER-chosen action through the same program."""
        return self._one(sid, stage_idx, num_exec, True)

    def decide_batch(self, sids: list[int]) -> list[ServeResult]:
        """Up to `max_batch` sessions in ONE batched policy evaluation.
        A single session takes the single-session path."""
        if not sids:
            return []
        if len(sids) > self.max_batch:
            raise ValueError(
                f"{len(sids)} sessions > max_batch={self.max_batch}"
            )
        for sid in sids:
            self._check_sid(sid)
        if len(set(sids)) != len(sids):
            raise ValueError("duplicate session ids in one batch")
        if len(sids) == 1:
            return [self.decide(sids[0])]
        slots = np.full(self.max_batch, self.capacity, np.int64)
        slots[: len(sids)] = sids
        ver = self.params_version
        out = _to_host(self._decidek(
            self.store, torch.from_numpy(slots).to(self.device),
            self._next_key(),
        ))
        results = []
        for i, sid in enumerate(sids):
            res = ServeResult(sid, out, i, batched=True, params_version=ver)
            self._apply_health(sid, res.health_mask)
            results.append(res)
        self.stats["serve_decisions"] += len(sids)
        self.stats["serve_batched_decisions"] += len(sids)
        self.stats["serve_batch_calls"] += 1
        return results
