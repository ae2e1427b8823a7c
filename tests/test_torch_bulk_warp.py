"""The fused bulk event kernel's warp-level pieces against the serial
rules they replace, on the CPU, through the g++ build of
`csrc/engine_core.cuh` (its host warp: 32 lanes as an array, run
through the same butterfly as the card's shuffles).

- The event minimum (`lane_event_arg`, the xor butterfly of `combine`,
  `event_result`) against the serial two-pass scan it replaced, on
  seeded arrays drawn from a few values so that ties are common: equal
  times with different seqs on different and on the same warp lane,
  +0.0 beside -0.0, inf and -inf, NaN, seqs at and above BIG_SEQ; at
  n from 1 to 130 (up to five executors a lane). The time's bits, the
  seq, the index and the NaN flag must all agree.
- The whole pass on the corner cases of `tests/_bulk_corners.py` (lanes
  of the port's own engine at 5, 50 and 70 executors, one modified a
  case) against `core._bulk_events_fused_ref`, under both key impls:
  every EnvState field, k_rel and k_rdy bit-equal, and each case's own
  check that it happened (who went first, what the wall time's sign
  is, that nothing was consumed).
- The wrapper refuses a bank of more executor levels than the kernel
  reads.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.kernels import bulk_events as bk

from . import _bulk_corners as corners
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_bulk_kernel import SHIM, _unequal, build_engine, run_engine

EVENT_MIN = r"""
extern "C" void shim_event_min(const float* t, const int32_t* sq, int n,
                               float* tmin, int* smin, int* at, int* nan) {
  Lanes<EventArg> m;
  Lanes<bool> bad;
  each_lane([&](int l) {
    bool b = false;
    m[l] = lane_event_arg(t, sq, n, l, b);
    bad[l] = b;
  });
  *nan = any_lane(bad);
  butterfly(m);
  event_result(m.uniform(), *tmin, *smin, *at);
}
"""


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    so = build_engine(tmp_path_factory.mktemp("engine_warp"),
                      SHIM + EVENT_MIN)
    vp = ctypes.c_void_p
    so.shim_event_min.argtypes = [vp, vp, ctypes.c_int, vp, vp, vp, vp]
    return so


def serial_event_min(t: np.ndarray, sq: np.ndarray):
    """The serial scan the warp minimum replaced: None on a NaN, else
    (tmin, smin, at) with tmin the first least time."""
    if np.isnan(t).any():
        return None
    tmin = np.float32(np.inf)
    for x in t:
        if x < tmin:
            tmin = x
    smin, at = corners.BIG_SEQ, -1
    for e, x in enumerate(t):
        if x == tmin and sq[e] < smin:
            smin, at = int(sq[e]), e
    return tmin, smin, at


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 50, 64, 65, 70, 100, 130])
def test_event_min_matches_the_serial_scan(engine, n):
    rs = np.random.default_rng(n)
    times = np.array([0.0, -0.0, 1.5, 2.0, np.inf, -np.inf], np.float32)
    seqs = np.array([3, 7, 9, corners.BIG_SEQ, corners.BIG_SEQ + 1],
                    np.int32)
    out_t = np.zeros(1, np.float32)
    out_i = np.zeros(3, np.int32)
    seen = set()
    for trial in range(300):
        t = times[rs.integers(0, len(times) - (trial % 3 == 0), n)]
        # every fifth array's seqs all at or above BIG_SEQ: no event
        sq = seqs[rs.integers(3 if trial % 5 == 1 else 0, len(seqs), n)]
        if trial % 7 == 0:
            t[rs.integers(n)] = np.nan
        t, sq = np.ascontiguousarray(t), np.ascontiguousarray(sq)
        engine.shim_event_min(t.ctypes.data, sq.ctypes.data, n,
                              out_t.ctypes.data, out_i[0:].ctypes.data,
                              out_i[1:].ctypes.data, out_i[2:].ctypes.data)
        want = serial_event_min(t, sq)
        if want is None:
            assert out_i[2] == 1, f"trial {trial}: a NaN not flagged"
            seen.add("nan")
            continue
        assert out_i[2] == 0, f"trial {trial}: a NaN flagged"
        got = (out_t[0].view(np.int32), int(out_i[0]), int(out_i[1]))
        assert got == (np.float32(want[0]).view(np.int32), want[1],
                       want[2]), f"trial {trial}: {got} != {want}"
        seen.add("none" if want[2] < 0 else "event")
        if want[0] == 0 and (t == 0).sum() > 1 and len(set(
                np.signbit(t[t == 0]))) == 2:
            seen.add("signed_zero")
    assert {"nan", "none", "event"} <= seen
    if n > 1:
        assert "signed_zero" in seen


CORNERS = [(c, n) for c in corners.CASES for n in corners.EXECUTORS
           if corners.applies(c, n)]


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("case,n", CORNERS)
def test_engine_core_corner_cases(engine, case, n, impl):
    tp, tb, env, on, stop, check = corners.corner_batch(case, n, impl)
    want = core._bulk_events_fused_ref(tp, tb, env, on, stop_at_limit=stop,
                                       max_events=8)
    got = run_engine(engine, tp, tb, env, on, stop)
    bad = _unequal(got, want)
    assert not bad, f"{case} at n = {n}: engine_core differs at {bad}"
    what = check(got)
    assert what is None, f"{case} at n = {n}: {what}"


def test_pack_refuses_more_levels_than_the_kernel_reads():
    """A bank of more executor levels than a presence row's 32 bits: the
    wrapper refuses it before any launch (the kernel would too)."""
    tp, tb, env, on, stop, _ = corners.corner_batch("captured", 5)
    t, s, _, _, k = tb.dur.shape
    wide = dataclasses.replace(tb, dur=torch.zeros(
        (t, s, 3, bk.MAX_LEVELS + 1, k), dtype=torch.float32))
    with pytest.raises(ValueError, match="executor levels"):
        bk.pack(tp, wide, env, on, stop, 8)
