"""Critic-free baseline (counterpart of
`sparksched_tpu/trainers/baselines.py`).

Lanes are laid out `[num_sequences, num_rollouts]`; the lanes of a group
replay the same job arrival sequence. Each lane's returns curve is
interpolated linearly onto the union of the group's wall-time points, the
baseline is the mean over the group's lanes at each point, and each lane
reads it back at its own times. Padded steps go to far-future sentinel
times with their return forward-filled from the last valid step (the
constant right extension of `jnp.interp`)."""

from __future__ import annotations

import numpy as np
import torch

_SENTINEL = 1e12
# jnp.interp's threshold below which an interval counts as empty
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _lane_curves(ts: torch.Tensor, ys: torch.Tensor, valid: torch.Tensor):
    """Per lane: sentinel times for padding, forward-filled returns."""
    t_cap = ts.shape[-1]
    n_valid = valid.sum(-1, keepdim=True)
    last_idx = torch.clamp_min(n_valid - 1, 0)
    last_val = torch.gather(ys, -1, last_idx)
    ys_f = torch.where(valid, ys, last_val)
    ts_f = torch.where(
        valid, ts,
        _SENTINEL + torch.arange(t_cap, dtype=ts.dtype, device=ts.device))
    return ts_f, ys_f


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)` per row of the leading axes (xp sorted):
    constant extension left and right, empty intervals give fp[i-1]."""
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    f_lo, f_hi = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    x_lo, x_hi = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    df, dx, delta = f_hi - f_lo, x_hi - x_lo, x - x_lo
    dx0 = dx.abs() <= _DX_EPS
    f = torch.where(dx0, f_lo,
                    f_lo + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def group_baselines(wall_times: torch.Tensor, returns: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """f32[G,R,T] baselines from observation times (not the final time),
    returns and the valid mask, all `[G,R,T]`."""
    g, r, t = wall_times.shape
    ts_f, ys_f = _lane_curves(wall_times, returns, valid)
    union = torch.sort(ts_f.reshape(g, r * t), -1).values  # [G, R*T]
    y_hats = interp(union[:, None].expand(g, r, r * t), ts_f, ys_f)
    mean = y_hats.mean(1)  # [G, R*T]
    return interp(ts_f, union[:, None].expand(g, r, r * t),
                  mean[:, None].expand(g, r, r * t))
