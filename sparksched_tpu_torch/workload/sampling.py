"""Workload sampling on the device: Poisson job sequences and task
durations (counterpart of `sparksched_tpu/workload/sampling.py`).

Every function takes a leading lane axis `[B]`: where the JAX package
vmaps a per-lane function, these take per-lane tensors."""

from __future__ import annotations

import torch

from .. import prng
from ..config import EnvParams
from .bank import WAVE_FIRST, WAVE_FRESH, WAVE_REST, WorkloadBank


def sample_job_sequence(
    params: EnvParams, bank: WorkloadBank, rng: torch.Tensor,
    time_limit: torch.Tensor,
):
    """Up to `max_jobs` Poisson arrivals per lane: the first job at t=0,
    later gaps Exponential(1/rate), stopping at the time limit or the cap.
    `rng` is `[B,2]`, `time_limit` f32[B]. Returns (arrival_times[B,J]
    with inf padding, templates i32[B,J], num_jobs i32[B], mask[B,J]).
    The cumulative sum may be associated differently from XLA's."""
    j_cap = params.max_jobs
    keys = prng.split(rng)
    k_gap, k_tpl = keys[..., 0, :], keys[..., 1, :]
    mean_gap = 1.0 / params.job_arrival_rate
    gaps = prng.exponential(k_gap, (j_cap,)) * mean_gap
    zero = torch.zeros_like(gaps[:, :1])
    arrivals = torch.cat([zero, torch.cumsum(gaps, 1)[:, : j_cap - 1]], 1)
    mask = arrivals < time_limit[:, None]
    mask[:, 0] = True
    mask = torch.cumprod(mask.to(torch.int32), 1).bool()
    templates = prng.randint(k_tpl, (j_cap,), 0, bank.num_templates)
    num_jobs = mask.sum(1).to(torch.int32)
    arrivals = torch.where(mask, arrivals, torch.inf)
    return arrivals, templates, num_jobs, mask


def sample_executor_key(
    bank: WorkloadBank, u: torch.Tensor, template: torch.Tensor,
    stage: torch.Tensor, num_local: torch.Tensor,
) -> torch.Tensor:
    """Trace executor-level index per draw: random interpolation between
    the two levels bracketing `num_local`, falling back to the stage's
    highest present level. `u` holds pre-drawn uniforms; all arguments
    share one shape (`[B]` lanes, or `[B,K]` candidates). `num_local`
    is clamped into the interval tables, as the JAX package's gathers
    clamp: a bulk pass samples for candidates it then discards, whose
    counts may lie outside them."""
    nl = num_local.long().clamp(0, bank.itv_left_val.shape[0] - 1)
    left_v = bank.itv_left_val[nl]
    right_v = bank.itv_right_val[nl]
    left_i = bank.itv_left_idx[nl]
    right_i = bank.itv_right_idx[nl]
    rand_pt = 1 + (u * (right_v - left_v)).to(torch.int32)
    use_left = (left_v == right_v) | (rand_pt <= num_local - left_v)
    key_idx = torch.where(use_left, left_i, right_i)
    key_val = torch.where(use_left, left_v, right_v)
    t, s = template.long(), stage.long()
    present = bank.level_present[t, s, key_idx.long()] & (key_val > 0)
    return torch.where(present, key_idx, bank.max_present[t, s])


def sample_task_duration(
    params: EnvParams, bank: WorkloadBank, u2: torch.Tensor,
    template: torch.Tensor, stage: torch.Tensor, num_local: torch.Tensor,
    task_valid, same_stage,
) -> torch.Tensor:
    """One task duration per draw with the reference's wave logic and
    fallback chains (see the JAX package's docstring). `u2` is
    f32[..., 2]: u2[..., 0] drives the level interpolation, u2[..., 1]
    the bucket pick. The other arguments broadcast against `u2[..., 0]`
    — one draw per lane (`[B]`), or per lane and candidate (`[B,K]`, the
    JAX package's vmap over a pass's candidates) — and the bank is
    gathered once per draw."""
    template, stage, num_local, task_valid, same_stage = (
        torch.broadcast_tensors(
            template, stage, num_local, torch.as_tensor(task_valid,
                                                        device=u2.device),
            torch.as_tensor(same_stage, device=u2.device), u2[..., 0],
        )[:5]
    )
    li = sample_executor_key(bank, u2[..., 0], template, stage, num_local)
    t, s, l = template.long(), stage.long(), li.long()
    cnt = bank.cnt[t, s, :, l]  # i32[..., 3]
    has = cnt > 0
    idle_wave = torch.where(has[..., WAVE_FRESH], WAVE_FRESH, WAVE_FIRST)
    idle_warm = ~has[..., WAVE_FRESH]
    same_wave = torch.where(
        has[..., WAVE_REST], WAVE_REST,
        torch.where(has[..., WAVE_FIRST], WAVE_FIRST, WAVE_FRESH),
    )
    diff_wave = torch.where(has[..., WAVE_FIRST], WAVE_FIRST, WAVE_FRESH)
    wave = torch.where(
        ~task_valid, idle_wave, torch.where(same_stage, same_wave, diff_wave)
    )
    warm = ~task_valid & idle_warm
    c = cnt.gather(-1, wave[..., None].long())[..., 0]
    n = torch.clamp_min(c, 1)
    pick = torch.minimum((u2[..., 1] * n).to(torch.int32), n - 1)
    dur = bank.dur[t, s, wave, l, pick.long()]
    if dur.dtype != torch.float32:
        # a narrow table (`quantize_bank`): the gather stays narrow, the
        # value is f32 from here on (int codes through their template's
        # log-domain scale, bf16 by the cast)
        dur = dur.to(torch.float32)
        if bank.dur_scale is not None:
            dur = torch.expm1(dur * bank.dur_scale[t])
    dur = torch.where(c > 0, dur, bank.rough_duration[t, s])
    return dur + torch.where(warm, params.warmup_delay, 0.0)
