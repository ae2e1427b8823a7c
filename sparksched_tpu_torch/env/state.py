"""Struct-of-tensors environment state (counterpart of
`sparksched_tpu/env/state.py`).

`EnvState` is a dataclass of tensors with the JAX package's fields in its
order, each carrying a leading lane axis `[B]` where the JAX package
vmaps an unbatched pytree: a JAX scalar field is a `[B]` tensor here,
`rng` is the lane's key as int64 words `[B,2]` (see `prng`). Encoding
conventions (pool keys, per-owner event arrays, commitment slots) are
the JAX package's; its module docstring explains them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import EnvParams

# event kinds, dispatch order matches reference handler registration
EV_JOB_ARRIVAL, EV_TASK_FINISHED, EV_EXECUTOR_READY = 0, 1, 2

INF = float("inf")
BIG_SEQ = 2**30

_i32 = torch.int32
_f32 = torch.float32


def topo_levels(active: torch.Tensor, adj_act: torch.Tensor) -> torch.Tensor:
    """i32[..., S] topological generation of each active node of the
    masked subgraph (`adj_act[..., p, c]`); padding = S. The iteration
    is a longest-path relaxation, so it stops as soon as a pass changes
    nothing: the JAX package's fixed S passes give the same result."""
    s_cap = active.shape[-1]
    lvl = torch.zeros(active.shape, dtype=_i32, device=active.device)
    for _ in range(s_cap):
        cand = torch.where(adj_act, lvl[..., :, None] + 1, 0).amax(-2)
        nxt = torch.maximum(lvl, cand)
        if torch.equal(nxt, lvl):
            break
        lvl = nxt
    return torch.where(active, lvl, s_cap)


@dataclasses.dataclass
class EnvState:
    # --- rng / time ---
    rng: torch.Tensor  # i64[B,2]
    wall_time: torch.Tensor  # f32[B]
    time_limit: torch.Tensor  # f32[B]; inf if no time limit
    seq_counter: torch.Tensor  # i32[B]
    # --- episode flags ---
    round_ready: torch.Tensor  # bool[B]
    terminated: torch.Tensor  # bool[B]
    truncated: torch.Tensor  # bool[B]
    # --- jobs [B,J] ---
    job_template: torch.Tensor
    job_arrival_time: torch.Tensor
    job_arrival_seq: torch.Tensor
    job_arrived: torch.Tensor
    job_t_completed: torch.Tensor
    job_num_stages: torch.Tensor
    job_saturated_stages: torch.Tensor
    job_supply: torch.Tensor
    num_jobs: torch.Tensor  # i32[B]
    # --- stages [B,J,S] ---
    stage_exists: torch.Tensor
    stage_num_tasks: torch.Tensor
    stage_remaining: torch.Tensor
    stage_executing: torch.Tensor
    stage_completed_tasks: torch.Tensor
    stage_duration: torch.Tensor
    stage_selected: torch.Tensor
    schedulable: torch.Tensor
    adj: torch.Tensor  # bool[B,J,S,S]
    # --- executors [B,N] ---
    exec_at_common: torch.Tensor
    exec_job: torch.Tensor
    exec_stage: torch.Tensor
    exec_moving: torch.Tensor
    exec_dst_job: torch.Tensor
    exec_dst_stage: torch.Tensor
    exec_arrive_time: torch.Tensor
    exec_arrive_seq: torch.Tensor
    exec_executing: torch.Tensor
    exec_task_valid: torch.Tensor
    exec_task_stage: torch.Tensor
    exec_finish_time: torch.Tensor
    exec_finish_seq: torch.Tensor
    # --- incremental caches [B,J,S] ---
    stage_sat: torch.Tensor
    unsat_parent_count: torch.Tensor
    incomplete_parent_count: torch.Tensor
    node_level: torch.Tensor
    commit_count: torch.Tensor
    moving_count: torch.Tensor
    # --- commitment slots [B,N] ---
    cm_valid: torch.Tensor
    cm_src_job: torch.Tensor
    cm_src_stage: torch.Tensor
    cm_dst_job: torch.Tensor
    cm_dst_stage: torch.Tensor
    cm_seq: torch.Tensor
    # --- executor source [B] ---
    source_valid: torch.Tensor
    source_job: torch.Tensor
    source_stage: torch.Tensor

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    # ---------------- derived quantities ----------------

    @property
    def stage_completed(self) -> torch.Tensor:
        return self.stage_exists & (
            self.stage_completed_tasks >= self.stage_num_tasks
        )

    @property
    def job_completed(self) -> torch.Tensor:
        done = torch.where(self.stage_exists, self.stage_completed, True)
        return self.job_arrived & done.all(-1)

    @property
    def job_active(self) -> torch.Tensor:
        return self.job_arrived & ~self.job_completed

    @property
    def job_saturated(self) -> torch.Tensor:
        return self.job_saturated_stages >= self.job_num_stages

    @property
    def frontier(self) -> torch.Tensor:
        return (
            self.stage_exists
            & ~self.stage_completed
            & (self.incomplete_parent_count == 0)
        )

    @property
    def frontier_golden(self) -> torch.Tensor:
        """Recomputed frontier (golden of the incremental one)."""
        incomplete_parent = self.adj & ~self.stage_completed[..., :, None]
        return self.stage_exists & ~self.stage_completed & \
            ~incomplete_parent.any(-2)

    @property
    def node_level_golden(self) -> torch.Tensor:
        """Recomputed per-job generations over existing, incomplete
        stages (golden of the incremental `node_level`)."""
        active = self.stage_exists & ~self.stage_completed
        adj_act = self.adj & active[..., :, None] & active[..., None, :]
        return topo_levels(active, adj_act)

    def _count_to_stage(self, valid, dst_job, dst_stage) -> torch.Tensor:
        b, j_cap, s_cap = self.stage_exists.shape
        flat = torch.zeros((b, j_cap * s_cap + 1), dtype=_i32,
                           device=valid.device)
        idx = torch.where(valid, dst_job * s_cap + dst_stage, j_cap * s_cap)
        flat.scatter_add_(1, idx.long(), torch.ones_like(idx))
        return flat[:, :-1].reshape(b, j_cap, s_cap)

    @property
    def commit_count_to_stage(self) -> torch.Tensor:
        """Slot-derived commitment counts (golden of `commit_count`)."""
        return self._count_to_stage(
            self.cm_valid & (self.cm_dst_job >= 0), self.cm_dst_job,
            self.cm_dst_stage,
        )

    @property
    def moving_count_to_stage(self) -> torch.Tensor:
        """Executor-derived moving counts (golden of `moving_count`)."""
        return self._count_to_stage(
            self.exec_moving, self.exec_dst_job, self.exec_dst_stage
        )

    @property
    def exec_demand(self) -> torch.Tensor:
        return self.stage_remaining - (self.moving_count + self.commit_count)

    @property
    def stage_saturated(self) -> torch.Tensor:
        """Golden of the incremental `stage_sat`."""
        return self.exec_demand <= 0

    @property
    def all_jobs_complete(self) -> torch.Tensor:
        j = torch.arange(self.job_arrived.shape[1], device=self.job_arrived.device)
        return torch.where(
            j[None, :] < self.num_jobs[:, None], self.job_completed, True
        ).all(-1)

    # --- pools ---

    def pool_member_mask(self, job: torch.Tensor, stage: torch.Tensor
                         ) -> torch.Tensor:
        """bool[B,N]; executors residing in pool (job[B], stage[B])."""
        job_c, stage_c = job[:, None], stage[:, None]
        at_job_pool = (self.exec_job == job_c) & (self.exec_stage == -1) & \
            ~self.exec_at_common & ~self.exec_moving
        at_stage_pool = (self.exec_job == job_c) & (self.exec_stage == stage_c)
        return torch.where(
            job_c < 0, self.exec_at_common,
            torch.where(stage_c < 0, at_job_pool, at_stage_pool),
        )

    def source_pool_mask(self) -> torch.Tensor:
        mask = self.pool_member_mask(self.source_job, self.source_stage)
        return mask & self.source_valid[:, None]

    def commitments_from_source(self) -> torch.Tensor:
        match = (
            self.cm_valid
            & (self.cm_src_job == self.source_job[:, None])
            & (self.cm_src_stage == self.source_stage[:, None])
        )
        return torch.where(
            self.source_valid, match.sum(-1), 0
        ).to(_i32)

    def num_committable(self) -> torch.Tensor:
        return (
            self.source_pool_mask().sum(-1).to(_i32)
            - self.commitments_from_source()
        )

    def source_job_id(self) -> torch.Tensor:
        return torch.where(self.source_valid, self.source_job, -1).to(_i32)


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))


def empty_state(params: EnvParams, rng: torch.Tensor) -> EnvState:
    """All-zero template state for `rng.shape[0]` lanes."""
    b = rng.shape[0]
    j, s, n = params.max_jobs, params.max_stages, params.num_executors
    dev = rng.device

    def full(shape, v, dtype):
        return torch.full((b,) + shape, v, dtype=dtype, device=dev)

    bl = torch.bool
    return EnvState(
        rng=rng.clone(),
        wall_time=full((), 0.0, _f32),
        time_limit=full((), INF, _f32),
        seq_counter=full((), 0, _i32),
        round_ready=full((), False, bl),
        terminated=full((), False, bl),
        truncated=full((), False, bl),
        job_template=full((j,), 0, _i32),
        job_arrival_time=full((j,), INF, _f32),
        job_arrival_seq=full((j,), 0, _i32),
        job_arrived=full((j,), False, bl),
        job_t_completed=full((j,), INF, _f32),
        job_num_stages=full((j,), 0, _i32),
        job_saturated_stages=full((j,), 0, _i32),
        job_supply=full((j,), 0, _i32),
        num_jobs=full((), 0, _i32),
        stage_exists=full((j, s), False, bl),
        stage_num_tasks=full((j, s), 0, _i32),
        stage_remaining=full((j, s), 0, _i32),
        stage_executing=full((j, s), 0, _i32),
        stage_completed_tasks=full((j, s), 0, _i32),
        stage_duration=full((j, s), 0.0, _f32),
        stage_selected=full((j, s), False, bl),
        schedulable=full((j, s), False, bl),
        adj=full((j, s, s), False, bl),
        exec_at_common=full((n,), True, bl),
        exec_job=full((n,), -1, _i32),
        exec_stage=full((n,), -1, _i32),
        exec_moving=full((n,), False, bl),
        exec_dst_job=full((n,), -1, _i32),
        exec_dst_stage=full((n,), -1, _i32),
        exec_arrive_time=full((n,), INF, _f32),
        exec_arrive_seq=full((n,), 0, _i32),
        exec_executing=full((n,), False, bl),
        exec_task_valid=full((n,), False, bl),
        exec_task_stage=full((n,), -1, _i32),
        exec_finish_time=full((n,), INF, _f32),
        exec_finish_seq=full((n,), 0, _i32),
        stage_sat=full((j, s), True, bl),
        unsat_parent_count=full((j, s), 0, _i32),
        incomplete_parent_count=full((j, s), 0, _i32),
        node_level=full((j, s), s, _i32),
        commit_count=full((j, s), 0, _i32),
        moving_count=full((j, s), 0, _i32),
        cm_valid=full((n,), False, bl),
        cm_src_job=full((n,), -1, _i32),
        cm_src_stage=full((n,), -1, _i32),
        cm_dst_job=full((n,), -1, _i32),
        cm_dst_stage=full((n,), -1, _i32),
        cm_seq=full((n,), 0, _i32),
        source_valid=full((), False, bl),
        source_job=full((), -1, _i32),
        source_stage=full((), -1, _i32),
    )
