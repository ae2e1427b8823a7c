"""Heuristic schedulers (counterpart of
`sparksched_tpu/schedulers/heuristics.py`): the reference's fair/FIFO
round robin and uniform-random schedulers as masked selections over a
batch of padded `Observation`s (leading lane axis `[B]`)."""

from __future__ import annotations

from typing import Any

import torch

from .. import prng
from ..env.observe import Observation
from .base import Scheduler

_i32 = torch.int32


def _first(m: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 if none),
    `jnp.argmax` of a bool array."""
    return torch.argmax(m.to(torch.uint8), -1)


def find_stage_per_job(obs: Observation):
    """Per-job stage selection, frontier-preferred: for each job the
    first schedulable frontier stage, else the first schedulable stage.
    Returns (stage i32[B,J] with -1 for none, has bool[B,J])."""
    sched = obs.schedulable
    front = sched & obs.frontier
    has_front = front.any(-1)
    has = sched.any(-1)
    sel = torch.where(has_front, _first(front), _first(sched))
    return torch.where(has, sel, -1).to(_i32), has


def _at(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return x.gather(1, j.long()[:, None])[:, 0]


def round_robin_policy(obs: Observation, num_executors: int,
                       dynamic_partition: bool = True):
    """Fair (dynamic per-job executor cap) or FIFO scheduling. Returns
    (flat stage_idx | -1, num_exec), each i32[B]."""
    b, j_cap, s_cap = obs.schedulable.shape
    n_active = obs.job_mask.sum(-1)
    if dynamic_partition:
        cap = torch.ceil(num_executors / n_active.clamp_min(1)).to(_i32)
    else:
        cap = torch.full((b,), num_executors, dtype=_i32,
                         device=n_active.device)

    sel, has = find_stage_per_job(obs)
    committable = obs.num_committable

    # a stage in the job that is releasing executors
    src = obs.source_job
    src_c = src.clamp_min(0)
    src_ok = (src >= 0) & _at(has, src_c)

    # else jobs in arrival order == job-id order
    j_idx = torch.arange(j_cap, dtype=_i32, device=src.device)
    supplies = obs.exec_supplies
    want = (obs.job_mask & has & (supplies < cap[:, None])
            & (j_idx != src[:, None]))
    any_want = want.any(-1)
    j_pick = _first(want)

    stage_src = src * s_cap + _at(sel, src_c)
    stage_loop = j_pick.to(_i32) * s_cap + _at(sel, j_pick)
    n_loop = torch.minimum(committable, cap - _at(supplies, j_pick))

    stage_idx = torch.where(
        src_ok, stage_src, torch.where(any_want, stage_loop, -1)
    ).to(_i32)
    num_exec = torch.where(src_ok | ~any_want, committable, n_loop).to(_i32)
    return stage_idx, num_exec


def random_policy(rng: torch.Tensor, obs: Observation):
    """Uniform-random job with a schedulable stage, frontier-preferred
    stage within it, uniform executor count in [1, committable]. `rng`
    holds one key per lane; the draws are `jax.random`'s bits."""
    s_cap = obs.schedulable.shape[2]
    sel, has = find_stage_per_job(obs)
    keys = prng.split(rng)
    k_job, k_n = keys[:, 0], keys[:, 1]
    n_has = has.sum(-1)
    p = torch.where(has, 1.0, 0.0) / n_has.clamp_min(1)[:, None]
    j = prng.choice(k_job, has.shape[1], p)
    stage_idx = torch.where(n_has > 0, j * s_cap + _at(sel, j), -1)
    num_exec = prng.randint(k_n, (), 1, obs.num_committable.clamp_min(1) + 1)
    return stage_idx.to(_i32), num_exec


class RoundRobinScheduler(Scheduler):
    """Fair/FIFO heuristic."""

    def __init__(self, num_executors: int, dynamic_partition: bool = True,
                 **_: Any) -> None:
        self.name = "Fair" if dynamic_partition else "FIFO"
        self.num_executors = int(num_executors)
        self.dynamic_partition = bool(dynamic_partition)

    def policy(self, rng: torch.Tensor, obs: Observation):
        stage_idx, num_exec = round_robin_policy(
            obs, self.num_executors, self.dynamic_partition
        )
        return stage_idx, num_exec, {}

    def schedule(self, obs: Observation):
        stage_idx, num_exec = round_robin_policy(
            obs, self.num_executors, self.dynamic_partition
        )
        return {"stage_idx": int(stage_idx[0]),
                "num_exec": int(num_exec[0])}, {}


class RandomScheduler(Scheduler):
    """Uniform-random heuristic. `schedule` draws from its own key
    chain, seeded by `seed`."""

    def __init__(self, seed: int = 42, **_: Any) -> None:
        self.name = "Random"
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        self._rng = prng.PRNGKey(seed)

    def policy(self, rng: torch.Tensor, obs: Observation):
        stage_idx, num_exec = random_policy(rng, obs)
        return stage_idx, num_exec, {}

    def schedule(self, obs: Observation):
        keys = prng.split(self._rng.to(obs.wall_time.device))
        self._rng = keys[0]
        stage_idx, num_exec = random_policy(keys[1][None], obs)
        return {"stage_idx": int(stage_idx[0]),
                "num_exec": int(num_exec[0])}, {}
