"""The fused bulk event kernel's own source against the plain torch pass,
bit for bit, on the CPU.

- `csrc/engine_core.cuh` (the arithmetic `csrc/bulk_events.cu` runs: the
  lane's setup, its scan with the duration model and the uniforms
  derived one pair a step, the copy of the written fields, the overlay
  and sparse epilogue) built with g++ (`-std=c++17 -O2
  -ffp-contract=off`, the card's kernel has no FMA contraction either)
  behind a C shim that runs each part of a lane's block in turn: the
  setup's loads on 3 strided "threads", its keys and jobs on the
  header's host warp (32 lanes as an array, through the same butterfly
  and shuffle picks as the card's warp), the slots' election, the scan
  on the host warp (making each row of uniforms as it needs it), the
  copy (after the scan: on the card they run at once, so a scan that
  read or wrote an output would show), then its outputs on 3 "threads".
  It reads the very argument arrays the wrapper packs for the card
  (`kernels/bulk_events.py:pack`), here on CPU tensors, and is held
  against `core._bulk_events_fused_ref` on mid-episode lanes of
  `test_torch_bulk.py:_snapshots` (the reference fixtures and the
  synthetic bank), in its `plain`, `limit` and `join` variants, under
  both key impls (2-word threefry keys, and 4-word rbg
  keys whose uniforms are ONE stream of lane 0's second key), on the
  f32 bank, its int16 codes, its bf16 cast and a skewed copy that makes
  the duration model's rarer branches common (the warm-up fallback, the
  level picked by the live job-local count): every EnvState field,
  k_rel and k_rdy bit-equal. The int16 codes go through expm1; the shim
  takes it from torch (`ENGINE_HOST_EXPM1F`), the plain version's own,
  since the C library's float32 expm1 parts from torch's in the last
  ulp (on the card both sides use CUDA's expm1f: `chip_smoke.py`'s
  `bulk_kernel`).
- One case against the JAX pass itself (the plain version is held
  against it by `test_torch_bulk.py:test_bulk_event_pass_matches_jax`).
- The wrapper: a CPU state takes the plain version (counted), another
  device raises, and `pack` refuses a wrong dtype or shape or a
  non-contiguous field.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.kernels import build
from sparksched_tpu_torch.kernels import bulk_events as bk
from sparksched_tpu_torch.workload.bank import quantize_bank

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from ._torch_parity import port_from_jax
from .test_torch_bulk import (
    _assert_same,
    _enabled,
    _event_lanes,
    _pick,
    _snapshots,
    _with_limits,
    _with_source_join,
)

SHIM = r"""
#include <cmath>
#include <vector>
typedef float (*expm1_fn)(float);
static expm1_fn g_expm1 = nullptr;
static int g_expm1_calls = 0;
static float shim_expm1(float x) {
  ++g_expm1_calls;
  return g_expm1 ? g_expm1(x) : std::expm1(x);
}
#define ENGINE_HOST_EXPM1F(x) shim_expm1(x)
#include "engine_core.cuh"
using namespace engine_core;
extern "C" {
void shim_set_expm1(expm1_fn f) { g_expm1 = f; }
int shim_expm1_calls() { return g_expm1_calls; }
void shim_arg_counts(int* p, int* d) { *p = kNumPointers; *d = kNumDims; }
int shim_bulk_events(const int64_t* ptrs, const int64_t* dims, float warmup,
                     int nthreads) {
  const BulkArgs a = bulk_args_from(ptrs, dims, warmup);
  if (!bulk_args_valid(a)) return -1;
  std::vector<int32_t> buf((lane_work_bytes(a) + 3) / 4 + 1);
  for (int b = 0; b < a.B; ++b) {
    const LaneWork w = carve_lane_work(buf.data(), a);
    for (int t = 0; t < nthreads; ++t)
      bulk_events_lane_init(a, b, w, t, nthreads);
    bulk_events_lane_keys(a, b, w);
    for (int t = 0; t < nthreads; ++t) bulk_events_lane_elect(a, w, t, nthreads);
    bulk_events_lane_jobs(a, w);
    for (int t = 0; t < nthreads; ++t) bulk_events_lane_slots(a, w, t, nthreads);
    // the scan before the copy that runs beside it on the card: a scan
    // that wrote an output, or read one, would show
    switch (a.dur_kind) {
      case 0: bulk_events_scan<DurF32>(a, b, w); break;
      case 1: bulk_events_scan<DurBf16>(a, b, w); break;
      case 2: bulk_events_scan<DurInt<int16_t>>(a, b, w); break;
      case 3: bulk_events_scan<DurInt<int8_t>>(a, b, w); break;
      default: return -1;
    }
    for (int t = 0; t < nthreads; ++t) bulk_events_copy(a, b, t, nthreads);
    for (int t = 0; t < nthreads; ++t)
      bulk_events_lane_finish(a, b, w, t, nthreads);
  }
  return 0;
}
}
"""
EXPM1 = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


def build_engine(d, src: str) -> ctypes.CDLL:
    """`src` (the C shim over `csrc/engine_core.cuh`, or more) built with
    g++ in the directory `d` and loaded, torch's expm1 handed to it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: engine_core.cuh's host build needs it")
    (d / "shim.cpp").write_text(src)
    lib = d / "libengine_core.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-Wall", "-I", build.CSRC, "-o", str(lib),
                    str(d / "shim.cpp")], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    so.shim_bulk_events.argtypes = [vp, vp, ctypes.c_float, ctypes.c_int]
    so.shim_bulk_events.restype = ctypes.c_int
    so.shim_set_expm1.argtypes = [EXPM1]
    so.shim_expm1_calls.restype = ctypes.c_int

    def torch_expm1(x: float) -> float:
        return torch.expm1(torch.tensor([x], dtype=torch.float32)).item()

    so.expm1_cb = EXPM1(torch_expm1)  # kept alive with the library
    so.shim_set_expm1(so.expm1_cb)
    n_ptr, n_dim = ctypes.c_int(), ctypes.c_int()
    so.shim_arg_counts(ctypes.byref(n_ptr), ctypes.byref(n_dim))
    assert (n_ptr.value, n_dim.value) == (bk.NUM_POINTERS, bk.NUM_DIMS)
    return so


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """`csrc/engine_core.cuh` behind the C shim, built with g++."""
    return build_engine(tmp_path_factory.mktemp("engine_core"), SHIM)


def run_engine(engine, params, bank, env, on, stop_at_limit, max_events=8):
    """The g++ build over every lane, on the wrapper's packed arrays."""
    outs, ptrs, dims, warmup = bk.pack(params, bank, env, on, stop_at_limit,
                                       max_events)
    rc = engine.shim_bulk_events((ctypes.c_int64 * len(ptrs))(*ptrs),
                                 (ctypes.c_int64 * len(dims))(*dims),
                                 warmup, 3)
    assert rc == 0
    return bk.unpack(env, outs)


def _lanes(source: str, variant: str):
    """(jp, jb, tp, tb, JAX LoopState [B], port LoopState) of a case."""
    jp, jb, tp, tb, _, states = _snapshots(source)
    if variant == "join":
        jls = _with_source_join(_pick(states, lambda l: (
            (l.mode == jfl.M_EVENT) & l.env.exec_moving.any())))
    else:
        jls = _event_lanes(states)
        if variant == "limit":
            jls = _with_limits(jls)
    return jp, jb, tp, tb, jls, port_from_jax(jls)


def _rbg_keys(rng: torch.Tensor, seed: int) -> torch.Tensor:
    """4-word rbg keys: each lane's threefry words, then two more, as
    rows of a wider buffer (a view, as the split's `keys[:, 0]` is)."""
    rs = np.random.default_rng(seed)
    buf = torch.from_numpy(rs.integers(0, 2**32, (rng.shape[0], 6),
                                       dtype=np.uint64).astype(np.int64))
    buf[:, :2] = rng
    return buf[:, :4]


def _skewed(tb):
    """The bank with the duration model's rarer branches made common:
    no fresh-wave samples on even templates (an idle executor's task
    falls back a wave and pays the warm-up delay), and interval tables
    that interpolate between level 0 (count 0: the stage's highest
    present level) and level 1 at 8 executors, so the live job-local
    count decides the level."""
    cnt = tb.cnt.clone()
    cnt[::2, :, 0] = 0
    m = tb.itv_left_val.shape[0]
    full = torch.full((m,), 1, dtype=torch.int32)
    return dataclasses.replace(
        tb, cnt=cnt, itv_left_val=full * 0, itv_right_val=full * 8,
        itv_left_idx=full * 0, itv_right_idx=full)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _unequal(a, b) -> list[str]:
    """The EnvState fields (and counts) that are not bit-equal."""
    sa, sb = a[0], b[0]
    bad = [f.name for f in dataclasses.fields(sa)
           if not torch.equal(_bits(getattr(sa, f.name)),
                              _bits(getattr(sb, f.name)))]
    return bad + [n for n, x, y in (("k_rel", a[1], b[1]),
                                    ("k_rdy", a[2], b[2]))
                  if not torch.equal(x, y)]


@pytest.mark.parametrize("bank_dtype", ["f32", "int16", "bf16",
                                        "skewed"])
@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("variant", ["plain", "limit", "join"])
@pytest.mark.parametrize("source", ["fixture", "synthetic"])
def test_engine_core_matches_plain_pass(engine, source, variant, impl,
                                        bank_dtype):
    _, _, tp, tb, jls, tls = _lanes(source, variant)
    env = tls.env
    if impl == "rbg":
        env = env.replace(rng=_rbg_keys(env.rng, len(source) + len(variant)))
    if bank_dtype in ("int16", "bf16"):
        tb = quantize_bank(tb, bank_dtype)
    elif bank_dtype == "skewed":
        tb = _skewed(tb)
    _, on = _enabled(env.rng.shape[0])
    stop = variant == "limit"
    calls0 = engine.shim_expm1_calls()
    want = core._bulk_events_fused_ref(tp, tb, env, on, stop_at_limit=stop,
                                       max_events=8)
    got = run_engine(engine, tp, tb, env, on, stop)
    bad = _unequal(got, want)
    assert not bad, f"engine_core differs from the plain pass at {bad}"
    k = got[1] + got[2]
    assert int(k.sum()) > 0, "the pass consumed no event on any lane"
    assert not k[~on].any()
    if bank_dtype == "int16":
        assert engine.shim_expm1_calls() > calls0, "no int16 code decoded"
    if stop:
        crossed = (k > 0) & (got[0].wall_time >= got[0].time_limit)
        assert bool(crossed.any()), "no pass crossed its time limit"


def test_engine_core_matches_jax(engine):
    """The g++ build against `jax.vmap(jcore._bulk_events_fused)` on the
    fixture lanes (the plain variant, threefry keys, f32 bank): every
    LoopState leaf and both counts."""
    jp, jb, tp, tb, jls, tls = _lanes("fixture", "plain")
    jon, ton = _enabled(jls.mode.shape[0])
    jout = jax.jit(jax.vmap(lambda e, on: jcore._bulk_events_fused(
        jp, jb, e, on, max_events=8)))(jls.env, jon)
    got = run_engine(engine, tp, tb, tls.env, ton, False)
    for a, b in zip(jout[1:], got[1:]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int((got[1] + got[2]).sum()) > 0
    _assert_same(jls.replace(env=jout[0]), tls.replace(env=got[0]), 0.0,
                 "engine_core vs JAX")


def test_wrapper_dispatch_and_refusals():
    """A CPU state runs the plain version (counted, no launch); another
    device raises; `pack` refuses what the kernel cannot read."""
    _, _, tp, tb, _, tls = _lanes("fixture", "plain")
    env = tls.env
    _, on = _enabled(env.rng.shape[0])
    plain0, launches0 = bk.bulk_events_fused.plain_calls, \
        bk.bulk_events_fused.launches
    got = core._bulk_events_fused(tp, tb, env, on, max_events=8)
    want = core._bulk_events_fused_ref(tp, tb, env, on, max_events=8)
    assert not _unequal(got, want)
    assert bk.bulk_events_fused.plain_calls == plain0 + 1
    assert bk.bulk_events_fused.launches == launches0
    meta = env.replace(rng=env.rng.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        core._bulk_events_fused(tp, tb, meta, on)
    with pytest.raises(ValueError, match="exec_job is torch.int64"):
        bk.pack(tp, tb, env.replace(exec_job=env.exec_job.long()), on,
                False, 8)
    strided = env.stage_remaining.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="stage_remaining is not contiguous"):
        bk.pack(tp, tb, env.replace(stage_remaining=strided), on, False, 8)
    with pytest.raises(ValueError, match="words are not adjacent"):
        bk.pack(tp, tb, env.replace(rng=env.rng.t().contiguous().t()), on,
                False, 8)
    with pytest.raises(ValueError, match=r"exec_finish_time is \(.*want"):
        bk.pack(tp, tb, env.replace(exec_finish_time=env.exec_finish_time[
            :, :-1].contiguous()), on, False, 8)
    with pytest.raises(ValueError, match="keys of 3 words"):
        bk.pack(tp, tb, env.replace(rng=env.rng[:, :1].repeat(1, 3)), on,
                False, 8)
