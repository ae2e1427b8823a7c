"""Return computation (counterpart of `sparksched_tpu/trainers/returns.py`)
over padded `[B,T]` rollouts:

- continuously discounted returns R_k = r_k + exp(-beta 1e-3 dt_k) R_{k+1};
- differential (average-reward) returns R_k = r_k + dt_k avg + R_{k+1},
  with `avg` the average number of jobs over a ring buffer of the last
  `cap` step records.

The reverse scans are loops over T on `[B]` columns, in the JAX scan's
order.
"""

from __future__ import annotations

import dataclasses

import torch

_i32 = torch.int32


def step_dts(wall_times: torch.Tensor) -> torch.Tensor:
    """dt[k] = wall_times[k+1] - wall_times[k]."""
    return wall_times[..., 1:] - wall_times[..., :-1]


def _reverse_scan(rewards: torch.Tensor, coef: torch.Tensor,
                  add: torch.Tensor | None) -> torch.Tensor:
    """R_k = r_k (+ add_k) + coef_k R_{k+1} from R_T = 0, per lane."""
    out = torch.empty_like(rewards)
    R = torch.zeros_like(rewards[:, 0])
    for t in range(rewards.shape[1] - 1, -1, -1):
        r = rewards[:, t] if add is None else rewards[:, t] + add[:, t]
        R = r + coef[:, t] * R
        out[:, t] = R
    return out


def discounted_returns(rewards: torch.Tensor, dts: torch.Tensor,
                       beta: float) -> torch.Tensor:
    """[B,T] continuously discounted returns. Invalid (padded) steps
    carry r=0 and dt=0, which keeps the chain intact."""
    return _reverse_scan(rewards, torch.exp(-beta * 1e-3 * dts), None)


def differential_returns(rewards: torch.Tensor, dts: torch.Tensor,
                         avg_num_jobs: torch.Tensor) -> torch.Tensor:
    """[B,T] differential returns: R_k = r_k + dt_k avg + R_{k+1}."""
    return _reverse_scan(rewards, torch.ones_like(dts), dts * avg_num_jobs)


@dataclasses.dataclass
class AvgNumJobsBuffer:
    """Ring buffer over the last `cap` (dt, reward) step records. Unfilled
    slots are zero and add nothing to either sum."""

    dt: torch.Tensor  # f32[cap]
    r: torch.Tensor  # f32[cap]
    ptr: torch.Tensor  # i32 []

    @classmethod
    def create(cls, cap: int, device="cpu") -> "AvgNumJobsBuffer":
        return cls(dt=torch.zeros(cap, device=device),
                   r=torch.zeros(cap, device=device),
                   ptr=torch.zeros((), dtype=_i32, device=device))

    @property
    def cap(self) -> int:
        return self.dt.shape[0]

    def extend(self, dts: torch.Tensor, rewards: torch.Tensor,
               valid: torch.Tensor) -> "AvgNumJobsBuffer":
        """Append flat step records, dropping dt <= 0 steps and keeping
        only the newest `cap` if more arrive at once."""
        cap = self.cap
        dts, rewards, valid = (dts.reshape(-1), rewards.reshape(-1),
                               valid.reshape(-1))
        keep = valid & (dts > 0)
        m = dts.shape[0]
        # kept entries to the front, in order
        order = torch.sort((~keep).to(torch.uint8), stable=True).indices
        dt_c, r_c = dts[order], rewards[order]
        n = keep.sum().to(_i32)
        drop = torch.clamp_min(n - cap, 0)
        idx = torch.arange(m, device=dts.device)
        take = (idx >= drop) & (idx < n)
        pos = torch.where(take, (self.ptr + idx - drop) % cap, cap)
        dt = torch.cat([self.dt, self.dt.new_zeros(1)])
        r = torch.cat([self.r, self.r.new_zeros(1)])
        dt[pos] = dt_c  # index cap (the dropped entries) is scratch
        r[pos] = r_c
        return AvgNumJobsBuffer(dt=dt[:cap], r=r[:cap],
                                ptr=((self.ptr + n - drop) % cap).to(_i32))

    def avg_num_jobs(self) -> torch.Tensor:
        """-sum(rewards) / sum(dt): total job-time per unit time."""
        return -self.r.sum() / torch.clamp_min(self.dt.sum(), 1e-9)
