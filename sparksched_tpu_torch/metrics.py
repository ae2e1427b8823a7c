"""Episode metrics (counterpart of `sparksched_tpu/metrics.py`),
computed per lane from a batched `EnvState` (`[B]` results)."""

from __future__ import annotations

import numpy as np
import torch

from .env.state import EnvState


def job_durations(state: EnvState) -> tuple[torch.Tensor, torch.Tensor]:
    """(durations f32[B,J], mask[B,J]) over arrived jobs: a duration is
    min(t_completed, wall_time) - t_arrival."""
    mask = state.job_arrived
    t_end = torch.minimum(state.job_t_completed, state.wall_time[:, None])
    durations = torch.where(mask, t_end - state.job_arrival_time, 0.0)
    return durations, mask


def avg_job_duration(state: EnvState) -> torch.Tensor:
    d, m = job_durations(state)
    return d.sum(-1) / m.sum(-1).clamp_min(1)


def avg_num_jobs(state: EnvState) -> torch.Tensor:
    """Time-average number of concurrent jobs: total job-time over the
    wall time."""
    d, _ = job_durations(state)
    return d.sum(-1) / state.wall_time.clamp_min(1e-9)


def num_completed_jobs(state: EnvState) -> torch.Tensor:
    return (state.job_arrived & torch.isfinite(state.job_t_completed)).sum(
        -1).to(torch.int32)


def num_job_arrivals(state: EnvState) -> torch.Tensor:
    return state.job_arrived.sum(-1).to(torch.int32)


PERCENTILE_QS = (25, 50, 75, 100)


def masked_percentiles(durations, mask, qs=PERCENTILE_QS):
    """Host-side percentiles over the masked durations, pooled over
    every lane given."""
    d = np.asarray(torch.as_tensor(durations).cpu()).ravel()
    m = np.asarray(torch.as_tensor(mask).cpu()).ravel()
    return np.percentile(d[m], list(qs)) if m.any() else np.zeros(len(qs))


def job_duration_percentiles(state: EnvState, qs=PERCENTILE_QS):
    """Percentiles over the arrived jobs of every lane."""
    return masked_percentiles(*job_durations(state), qs)
