#!/usr/bin/env python3
"""Where the fused bulk event kernel's time goes, on one CUDA card.

    python3 scripts_torch_bulk_phases.py [--reps 20] [--out PATH]

Builds, in a temporary directory, a copy of the checkout's
`csrc/bulk_events.cu` whose `engine_core.cuh` adds clock64 counters. In
the scan (warp 0, lane 0's clock): its setup (`setup`: its scalars from
shared memory), then per step the wait for the step's uniforms
(`await`), the lanes' partial minima (`partials`), their own least
events' targets and launch durations (`cands`), the NaN vote (`vote`),
the butterfly (`min`), the winner's candidate by shuffle and the step's
checks (`target`) and the step's writes (`update`), then the consumed
arrivals' slots (`arrivals`). For the block, the clock at its start,
when warp 0 is past its share of the setup's loads and of the slots'
election, warp 4 past the keys, warp 3 past the jobs, after the setup
warps' last barrier, at the scan's end (thread 0) and the copy's end
(thread 128), after the block's barrier and at its end. Runs it on
`chip_smoke.py`'s `train` captures (the flagship config, 2 iterations
at rollout_steps 128, rbg keys), each `--reps` times, checks its
outputs against the checkout's kernel (the counters change no result),
and prints per capture the counts of the block whose lane took the
most steps: cycles per step of each part, and the block's segments.
Each counter adds its own cycles to the scan, so the parts add up to
more than an uncounted step. Prints the card's name, power limit and SM
clock beside them and writes them to --out. Needs a CUDA card; imports
no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "sparksched_tpu_torch", "csrc")
MARKS = ("setup", "await", "partials", "cands", "vote", "min", "target",
         "update", "arrivals")
BLOCK = ("start", "init_w0", "keys", "elect_w0", "jobs", "setup_done",
         "scan_done", "copy_done", "barrier_done", "end")
LANES = 64  # blocks counted

COUNTERS = r"""
__device__ unsigned long long g_ph[%(lanes)d][%(marks)d];
__device__ unsigned long long g_blk[%(lanes)d][%(block)d];
__device__ unsigned long long g_steps[%(lanes)d];
__device__ __forceinline__ long long& ph_last() {
  static __shared__ long long t;
  return t;
}
#define PH_START() \
  if ((threadIdx.x & 31) == 0) ph_last() = clock64()
#define PH(i)                                                        \
  do {                                                               \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < %(lanes)d) {         \
      const long long t_ = clock64();                                \
      atomicAdd(&g_ph[blockIdx.x][i],                                \
                (unsigned long long)(t_ - ph_last()));               \
      ph_last() = t_;                                                \
    }                                                                \
  } while (0)
#define BLK(tid, i)                                                  \
  if (threadIdx.x == (tid) && blockIdx.x < %(lanes)d)                \
  engine_core::g_blk[blockIdx.x][i] = (unsigned long long)clock64()
"""


def instrumented(core: str, kernel: str) -> tuple[str, str]:
    """The two sources with the counters added at their anchors."""
    def put(src, anchor, text, after=True):
        assert src.count(anchor) == 1, anchor
        return src.replace(anchor, anchor + text if after else text + anchor)

    core = put(core, "namespace engine_core {\n", COUNTERS % {
        "lanes": LANES, "marks": len(MARKS), "block": len(BLOCK)})
    core = put(core, "  const int N = a.N, S = a.S;\n  const int32_t* s = w.scal;\n",
               "  PH_START();\n", after=False)
    for anchor, mark in (
            ("  const bool active = s[kEnabled] && !s[kJobNan];\n", "setup"),
            ("    await_row(a, b, w, i);\n", "await"),
            ("      nan[l] = bad;\n", "partials"),
            ("      ca[l] = lane_cand<Dur>(a, w, i, false, m[l].a.at);\n"
             "    });\n", "cands"),
            ("    const bool nan_any = any_lane(nan);\n", "vote"),
            ("    event_result(m.uniform().a, atmin, asmin, ae);\n", "min"),
            ("    if (!ok) break;\n", "target")):
        core = put(core, anchor, f"  PH({MARKS.index(mark)});\n")
    core = put(core, "    sync_lanes();  // the step's writes before the "
                     "next step's reads\n",
               f"    PH({MARKS.index('update')});\n"
               "    if ((threadIdx.x & 31) == 0 && blockIdx.x < "
               f"{LANES}) atomicAdd(&g_steps[blockIdx.x], 1ull);\n")
    end = ("      atomic_or(&w.ov_flags[k], kTouched);\n"
           "    }\n  });\n")
    core = put(core, end, f"  PH({MARKS.index('arrivals')});\n")
    for anchor, tid, mark, after in (
            ("  const int b = blockIdx.x;\n", 0, "start", True),
            ("    engine_core::bulk_events_lane_init(a, b, w, threadIdx.x, "
             "kSetupThreads);\n", 0, "init_w0", True),
            ("      engine_core::bulk_events_lane_keys(a, b, w);\n", 128,
             "keys", True),
            ("      engine_core::bulk_events_lane_elect(a, w, threadIdx.x, "
             "kLoadThreads);\n", 0, "elect_w0", True),
            ("      engine_core::bulk_events_lane_jobs(a, w);\n", 96, "jobs",
             True),
            ("    if (threadIdx.x < engine_core::kWarp) {\n", 0, "setup_done",
             False),
            ("      engine_core::bulk_events_scan<Dur>(a, b, w);\n", 0,
             "scan_done", True),
            ("                                  blockDim.x - kSetupThreads);\n",
             128, "copy_done", True),
            ("  __syncthreads();\n", 0, "barrier_done", True),
            ("  engine_core::bulk_events_lane_finish(a, b, w, threadIdx.x, "
             "blockDim.x);\n", 0, "end", True)):
        kernel = put(kernel, anchor, f"  BLK({tid}, {BLOCK.index(mark)});\n",
                     after)
    kernel += r"""
extern "C" int bulk_phases_read(unsigned long long* ph,
                                unsigned long long* blk,
                                unsigned long long* steps, int reset) {
  int rc = (int)cudaMemcpyFromSymbol(ph, engine_core::g_ph,
                                     sizeof(engine_core::g_ph));
  rc |= (int)cudaMemcpyFromSymbol(blk, engine_core::g_blk,
                                  sizeof(engine_core::g_blk));
  rc |= (int)cudaMemcpyFromSymbol(steps, engine_core::g_steps,
                                  sizeof(engine_core::g_steps));
  if (reset) {
    static unsigned long long zeros[sizeof(engine_core::g_ph) / 8 + 1];
    rc |= (int)cudaMemcpyToSymbol(engine_core::g_ph, zeros,
                                  sizeof(engine_core::g_ph));
    rc |= (int)cudaMemcpyToSymbol(engine_core::g_steps, zeros,
                                  sizeof(engine_core::g_steps));
  }
  return rc;
}
"""
    return core, kernel


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(
        HERE, "artifacts", "port", "bulk_phases.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from sparksched_tpu_torch.kernels import build as kb
    from sparksched_tpu_torch.kernels import bulk_events as bk

    with tempfile.TemporaryDirectory(prefix="bulk_phases_") as tmp:
        cs.TMP_ROOT = tmp
        cs.phase_build()
        with open(os.path.join(CSRC, "engine_core.cuh")) as f:
            core = f.read()
        with open(os.path.join(CSRC, "bulk_events.cu")) as f:
            kern = f.read()
        core, kern = instrumented(core, kern)
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        shutil.copy(os.path.join(CSRC, "prng_core.cuh"), src)
        for name, text in (("engine_core.cuh", core),
                           ("bulk_events.cu", kern)):
            with open(os.path.join(src, name), "w") as f:
                f.write(text)
        lib = os.path.join(tmp, "libbulk_phases.so")
        proc = subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", lib,
                               os.path.join(src, "bulk_events.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
        so = ctypes.CDLL(lib)
        launch = so.bulk_events_fused_launch
        vp = ctypes.c_void_p
        launch.argtypes = [vp, vp, ctypes.c_float, vp]
        so.bulk_phases_read.argtypes = [vp, vp, vp, ctypes.c_int]
        cs.phase_train()
        rows = []
        for i, (p, b, st, on, stop, me) in enumerate(
                cs.BULK_CAPTURES["train"]):
            want = bk.bulk_events_fused(p, b, st, on, stop, me)
            outs, ptrs, dims, warm = bk.pack(p, b, st, on, stop, me)
            cp = (ctypes.c_int64 * len(ptrs))(*ptrs)
            cd = (ctypes.c_int64 * len(dims))(*dims)
            ph = (ctypes.c_ulonglong * (LANES * len(MARKS)))()
            blk = (ctypes.c_ulonglong * (LANES * len(BLOCK)))()
            steps = (ctypes.c_ulonglong * LANES)()
            stream = torch.cuda.current_stream().cuda_stream
            launch(cp, cd, warm, stream)
            torch.cuda.synchronize()
            so.bulk_phases_read(ph, blk, steps, 1)
            for _ in range(args.reps):
                if launch(cp, cd, warm, stream) != 0:
                    raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            if so.bulk_phases_read(ph, blk, steps, 1) != 0:
                raise RuntimeError("reading the counters failed")
            bad = cs._bulk_unequal(bk.unpack(st, outs), want)
            if bad:
                raise AssertionError(f"capture {i}: the counted copy "
                                     f"differs at {bad}")
            lanes = int(st.rng.shape[0])
            top = max(range(min(lanes, LANES)), key=lambda x: steps[x])
            n = steps[top] / args.reps
            per = {m: ph[top * len(MARKS) + j] / args.reps
                   for j, m in enumerate(MARKS)}
            t = [blk[top * len(BLOCK) + j] for j in range(len(BLOCK))]
            rows.append({
                "capture": i, "lanes": lanes,
                "events": int((want[1] + want[2]).sum()),
                "lane": top, "steps": n,
                "cycles": per,
                "cycles_per_step": {m: per[m] / n for m in MARKS[1:8]}
                if n else {},
                "block_cycles": {BLOCK[j]: t[j] - t[0]
                                 for j in range(1, len(BLOCK))}})
            print(json.dumps(rows[-1]), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": cs.card_line(), "sm_clock": clocks.strip(),
           "reps": args.reps, "captures": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": out["card"], "sm_clock": out["sm_clock"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
