"""Corner cases of the fused bulk event pass (`core._bulk_events_fused`)
for its kernel's warp-level event minimum and its stage overlay, built on
the port alone (numpy, torch, `sparksched_tpu_torch`), so that the CPU
tests and `chip_smoke.py` (which loads this file by path) hold the kernel
to the plain version on the same inputs.

The lanes come from a fair-policy run of the port's flat engine on the
CPU at `n` executors (8 job slots, the TPC-H bank), every pass input
captured. `corner_batch(case, n, impl)` takes four of them: lane 0 is
the case, made from a mid-run lane with a numpy generator seeded by the
case, lanes 1-3 are captured lanes left as they are. The cases:

- `captured`: four captured lanes, unmodified.
- `tie`: two finishes at the same time, the later executor (another warp
  lane's) with the lower seq: it goes first. `tie_same_warp_lane`: the
  same with executors 1 and 33, one warp lane's (n > 33 only).
- `finish_arrival_same`: a finish and an arrival at the same (time, seq):
  the arrival goes first.
- `nan_finish`: a NaN finish time: the lane consumes nothing.
  `nan_job`: a NaN arrival time of a job still to arrive: nothing.
- `all_inf`: every finish and arrival time inf: nothing.
- `big_seq`: the earliest event's seq above BIG_SEQ: no event is chosen,
  the run ends. (A finite time never carries BIG_SEQ itself in the
  engine; the dense plain version would take such an event, the serial
  rule would not. Stage (0, 0) has nothing left, so the plain version's
  empty one-hot, which reads that stage, stops too.)
- `signed_zero_pos_first` / `signed_zero_neg_first`: finishes at +0.0
  and -0.0 (executor 1 and executor n - 1, the later with the lower
  seq), the time limit below both: one event, and the wall time's bits
  are the first executor's. Only at n <= 64: torch's float32 `amin` on
  the CPU keeps the first of two equal zeros there, not beyond.
- `launch_and_arrival`: a finish relaunches at a stage that a moving
  executor then arrives at: one stage touched by a launch and an arrival.
- `ragged_bank`: four captured lanes on a bank whose counts are cut at
  random per (template, stage, wave, level), with random presence rows
  and fallback levels: the level, the wave and the bucket picked from
  the rows all matter.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

BIG_SEQ = 1 << 30
EXECUTORS = (5, 50, 70)  # the executor counts the cases are built at
JOBS = 8
GROUPS = 60
CASES = ("captured", "tie", "tie_same_warp_lane", "finish_arrival_same",
         "nan_finish", "nan_job", "all_inf", "big_seq", "signed_zero_pos_first",
         "signed_zero_neg_first", "launch_and_arrival", "ragged_bank")


def applies(case: str, n: int) -> bool:
    if case == "tie_same_warp_lane":
        return n > 33
    if case.startswith("signed_zero"):
        return n <= 64
    return True


@functools.lru_cache(maxsize=None)
def captured(n: int):
    """(params, bank, [(pass input state, events consumed a lane)]) of a
    fair-policy run of the port's flat engine on the CPU at n executors,
    4 lanes, GROUPS micro-step groups with bulk fulfilment."""
    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.env import core, flat_loop
    from sparksched_tpu_torch.schedulers import round_robin_policy
    from sparksched_tpu_torch.workload import make_workload_bank

    bank = make_workload_bank(n, 20, device="cpu")
    s_cap = bank.adj.shape[1]
    params = EnvParams(num_executors=n, max_jobs=JOBS, max_stages=s_cap,
                       max_levels=s_cap)
    states = []

    def capture(p, b, state, enabled, stop_at_limit=False, max_events=8):
        kept = state.replace(**{f.name: getattr(state, f.name).clone()
                                for f in dataclasses.fields(state)})
        out = core._bulk_events_fused_ref(p, b, state, enabled,
                                          stop_at_limit=stop_at_limit,
                                          max_events=max_events)
        states.append((kept, (out[1] + out[2]).tolist()))
        return out

    def policy(rng, obs):
        stage, num = round_robin_policy(obs, n, True)
        return stage, num, {}

    keys = prng.split(prng.PRNGKey(n, "cpu")[None], 4)[0]
    state = core.reset(params, bank, keys)
    orig = flat_loop._bulk_events_fused
    flat_loop._bulk_events_fused = capture
    try:
        flat_loop.run_flat(params, bank, policy, prng.fold_in(keys, 7),
                           GROUPS, state=state, auto_reset=False,
                           fulfill_bulk=True)
    finally:
        flat_loop._bulk_events_fused = orig
    return params, bank, states


def _lane(state, b: int) -> dict:
    return {f.name: getattr(state, f.name)[b].numpy().copy()
            for f in dataclasses.fields(state)}


def _stack(template, lanes: list[dict]):
    return template.replace(**{
        name: torch.from_numpy(np.stack([ln[name] for ln in lanes]))
        for name in lanes[0]})


def _finite_finishes(ln: dict) -> int:
    return int(np.isfinite(ln["exec_finish_time"]).sum())


def _target(ln: dict) -> tuple[int, int]:
    """An existing stage of an arrived job that an executor executes."""
    j_cap, s_cap = ln["stage_remaining"].shape
    for e in np.flatnonzero(np.isfinite(ln["exec_finish_time"])):
        j, s = int(ln["exec_job"][e]), int(ln["exec_task_stage"][e])
        if 0 <= j < j_cap and 0 <= s < s_cap and ln["stage_exists"][j, s]:
            return j, s
    raise AssertionError("no executing executor on a live stage")


def _first_time(ln: dict) -> float:
    """Just before the lane's earliest pending event of any kind."""
    t = np.concatenate([ln["exec_finish_time"], ln["exec_arrive_time"],
                        np.where(ln["job_arrived"], np.inf,
                                 ln["job_arrival_time"])])
    t = t[np.isfinite(t)]
    return float(t.min()) - 1.0 if len(t) else 1.0


def _seqs(ln: dict, k: int) -> list[int]:
    """k fresh seqs (the counter moves past them)."""
    s0 = int(ln["seq_counter"])
    ln["seq_counter"] = np.int32(s0 + k)
    return list(range(s0, s0 + k))


def _executing(ln: dict, e: int, js: tuple[int, int], t: float, seq: int):
    j, s = js
    ln["exec_job"][e], ln["exec_stage"][e] = j, s
    ln["exec_task_stage"][e] = s
    ln["exec_task_valid"][e] = ln["exec_executing"][e] = True
    ln["exec_moving"][e] = ln["exec_at_common"][e] = False
    ln["exec_finish_time"][e], ln["exec_finish_seq"][e] = t, seq
    ln["exec_arrive_time"][e], ln["exec_arrive_seq"][e] = np.inf, BIG_SEQ
    ln["stage_remaining"][j, s] = max(int(ln["stage_remaining"][j, s]), 3)


def _moving(ln: dict, e: int, js: tuple[int, int], t: float, seq: int):
    j, s = js
    ln["exec_moving"][e] = True
    ln["exec_executing"][e] = ln["exec_at_common"][e] = False
    ln["exec_finish_time"][e], ln["exec_finish_seq"][e] = np.inf, BIG_SEQ
    ln["exec_dst_job"][e], ln["exec_dst_stage"][e] = j, s
    ln["exec_arrive_time"][e], ln["exec_arrive_seq"][e] = t, seq
    ln["moving_count"][j, s] += 1
    ln["stage_remaining"][j, s] = max(int(ln["stage_remaining"][j, s]), 3)


def _other(n: int, e1: int) -> int:
    """An executor after e1 on another warp lane (past 32 where n is)."""
    e2 = n - 1
    return e2 if e2 % 32 != e1 % 32 else e2 - 1


def corner_batch(case: str, n: int, impl: str = "threefry2x32"):
    """(params, bank, state, enabled, stop_at_limit, check) of a case on
    the CPU: `check(got)` returns what the kernel's output (the pass's
    (state, k_rel, k_rdy), compared bit for bit with the plain version
    elsewhere) says against the case, or None when the case happened."""
    if not applies(case, n):
        raise ValueError(f"case {case} does not apply at n = {n}")
    params, bank, states = captured(n)
    rs = np.random.default_rng(CASES.index(case) * 1000 + n)
    # lanes on which the run's pass consumed events, and the mid-run ones
    # with two executors or more executing
    lanes = [(s, b, k[b]) for s, k in states for b in range(len(k))
             if k[b] > 0]
    busy = [(s, b) for s, b, _ in lanes[len(lanes) // 3:]
            if _finite_finishes(_lane(s, b)) >= 2]
    context = [lanes[i][:2]
               for i in rs.choice(len(lanes), 3, replace=False)]
    s0, b0 = busy[int(rs.integers(len(busy)))]
    ln = _lane(s0, b0)
    stop = False
    e1, e2 = 1, _other(n, 1)

    def lane0(got):
        return int(got[1][0]), int(got[2][0])

    if case in ("captured", "ragged_bank"):  # the run's longest pass first
        ln = _lane(*max(lanes, key=lambda x: x[2])[:2])
        if case == "ragged_bank":
            cnt = bank.cnt.numpy()
            bl = cnt.shape[-1]
            bank = dataclasses.replace(
                bank,
                cnt=torch.from_numpy(rs.integers(0, cnt + 1).astype(
                    np.int32)),
                level_present=torch.from_numpy(
                    rs.random(bank.level_present.shape) < 0.7),
                max_present=torch.from_numpy(rs.integers(
                    0, bl, bank.max_present.shape).astype(np.int32)))

        def check(got):
            k = got[1] + got[2]
            return None if int(k.sum()) > 0 else "no event consumed"
    elif case in ("tie", "tie_same_warp_lane"):
        if case == "tie_same_warp_lane":
            e2 = e1 + 32
        js, t = _target(ln), _first_time(ln)
        lo, hi = _seqs(ln, 2)
        first = int(ln["seq_counter"])
        _executing(ln, e1, js, t, hi)
        _executing(ln, e2, js, t, lo)

        def check(got):
            if lane0(got)[0] < 2:
                return f"{lane0(got)[0]} finishes consumed, want >= 2"
            if int(got[0].exec_finish_seq[0, e2]) != first:
                return f"executor {e2} (the lower seq) did not launch first"
            return None
    elif case == "finish_arrival_same":
        js, t = _target(ln), _first_time(ln)
        (seq,) = _seqs(ln, 1)
        _executing(ln, e1, js, t, seq)
        _moving(ln, e2, js, t, seq)

        def check(got):
            rel, rdy = lane0(got)
            if rel < 1 or rdy < 1:
                return f"k_rel {rel}, k_rdy {rdy}: want both"
            return None
    elif case in ("nan_finish", "nan_job", "all_inf"):
        if case == "nan_finish":
            ln["exec_finish_time"][e2] = np.nan
        elif case == "nan_job":
            ln["job_arrived"][-1] = False
            ln["job_arrival_time"][-1] = np.nan
        else:
            ln["exec_finish_time"][:] = np.inf
            ln["exec_arrive_time"][:] = np.inf

        def check(got):
            return None if lane0(got) == (0, 0) else f"consumed {lane0(got)}"
    elif case == "big_seq":
        js, t = _target(ln), _first_time(ln)
        _executing(ln, e2, js, t, BIG_SEQ + 1 + int(rs.integers(100)))
        ln["stage_remaining"][0, 0] = 0

        def check(got):
            return None if lane0(got) == (0, 0) else f"consumed {lane0(got)}"
    elif case.startswith("signed_zero"):
        js = _target(ln)
        lo, hi = _seqs(ln, 2)
        z1, z2 = (0.0, -0.0) if case.endswith("pos_first") else (-0.0, 0.0)
        for key in ("exec_finish_time", "exec_arrive_time"):
            ln[key] = np.where(ln[key] <= 1.0, np.float32(1.0), ln[key])
        late = ~ln["job_arrived"]
        ln["job_arrival_time"][late] = np.maximum(
            ln["job_arrival_time"][late], 1.0)
        _executing(ln, e1, js, z1, hi)
        _executing(ln, e2, js, z2, lo)
        ln["time_limit"] = np.float32(-1.0)
        stop = True

        def check(got):
            if lane0(got) != (1, 0):
                return f"consumed {lane0(got)}, want one finish"
            if bool(torch.signbit(got[0].wall_time[0])) != np.signbit(z1):
                return "the wall time's sign is not the first executor's"
            return None
    elif case == "launch_and_arrival":
        js, t = _target(ln), _first_time(ln)
        sf, sa = _seqs(ln, 2)
        _executing(ln, e1, js, t, sf)
        _moving(ln, e2, js, t + 0.5, sa)
        moving0 = int(ln["moving_count"][js])

        def check(got):
            rel, rdy = lane0(got)
            if rel < 1 or rdy < 1:
                return f"k_rel {rel}, k_rdy {rdy}: want both"
            if int(got[0].moving_count[0][js]) != moving0 - 1:
                return "the arrival's stage kept its moving count"
            return None
    else:
        raise ValueError(f"unknown case {case}")

    batch = [ln] + [_lane(s, b) for s, b in context]
    if stop:
        for other in batch[1:]:
            other["time_limit"] = np.float32(np.inf)
    state = _stack(s0, batch)
    if impl == "rbg":
        extra = rs.integers(0, 2**32, (len(batch), 2), dtype=np.uint64)
        state = state.replace(rng=torch.cat([
            state.rng, torch.from_numpy(extra.astype(np.int64))], 1))
    enabled = torch.ones(len(batch), dtype=torch.bool)
    return params, bank, state, enabled, stop, check


def to_device(params, bank, state, enabled, device):
    """The batch's tensors on `device`."""
    def move(x):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to(device)
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})

    return params, move(bank), move(state), enabled.to(device)
