"""Padded observations from the environment state (counterpart of
`sparksched_tpu/env/observe.py`), batched over lanes."""

from __future__ import annotations

import dataclasses

import torch

from ..config import EnvParams
from .state import EnvState

NUM_NODE_FEATURES = 3


@dataclasses.dataclass
class Observation:
    """Raw env observation, padded, with a leading lane axis `[B]`.
    `nodes[..., :]` = (num_remaining_tasks, most_recent_duration,
    is_schedulable)."""

    nodes: torch.Tensor  # f32[B,J,S,3] (bf16 under obs_dtype bfloat16)
    node_mask: torch.Tensor  # bool[B,J,S]
    job_mask: torch.Tensor  # bool[B,J]
    schedulable: torch.Tensor  # bool[B,J,S]
    frontier: torch.Tensor  # bool[B,J,S]
    adj: torch.Tensor  # bool[B,J,S,S]
    node_level: torch.Tensor  # i32[B,J,S]
    exec_supplies: torch.Tensor  # i32[B,J]
    num_committable: torch.Tensor  # i32[B]
    source_job: torch.Tensor  # i32[B]
    wall_time: torch.Tensor  # f32[B]

    @property
    def num_active_jobs(self) -> torch.Tensor:
        return self.job_mask.sum(-1).to(torch.int32)

    @property
    def num_active_nodes(self) -> torch.Tensor:
        return self.node_mask.sum((-2, -1)).to(torch.int32)


def observe(params: EnvParams, state: EnvState, compute_levels: bool = True
            ) -> Observation:
    """`node_level` comes from the state's incremental cache, masked to
    the active nodes. `params.obs_dtype = "bfloat16"` narrows `nodes` (and
    so the recorded `StoredObs.duration` buffers) to bf16; every consumer
    upcasts to f32 at its read site."""
    job_mask = state.job_active
    node_mask = job_mask[:, :, None] & state.stage_exists & \
        ~state.stage_completed
    nodes = torch.stack(
        [
            state.stage_remaining.to(torch.float32),
            state.stage_duration,
            state.schedulable.to(torch.float32),
        ],
        dim=-1,
    )
    nodes = torch.where(node_mask[..., None], nodes, 0.0)
    if params.obs_dtype == "bfloat16":
        nodes = nodes.to(torch.bfloat16)
    s_cap = node_mask.shape[-1]
    if compute_levels:
        node_level = torch.where(node_mask, state.node_level, s_cap)
    else:
        node_level = torch.full_like(state.node_level, s_cap)
    return Observation(
        nodes=nodes,
        node_mask=node_mask,
        job_mask=job_mask,
        schedulable=state.schedulable & node_mask,
        frontier=state.frontier & node_mask,
        adj=state.adj,
        node_level=node_level.to(torch.int32),
        exec_supplies=torch.where(job_mask, state.job_supply, 0),
        num_committable=state.num_committable(),
        source_job=state.source_job_id(),
        wall_time=state.wall_time,
    )
