#!/usr/bin/env python3
"""The NodeEncoder kernel beside earlier versions of it, on one CUDA card.

    git show 7743228:sparksched_tpu_torch/csrc/decima_encoder.cu \\
        > test_artifacts/encoder_baseline.cu
    python3 scripts_torch_encoder_ab.py \\
        --baseline-cu test_artifacts/encoder_baseline.cu [--cu NAME=PATH ...]

`--baseline-cu` is a `decima_encoder.cu` that reads its weights
row-major (each layer's W as out x in, then b), the layout of the
kernel's first version; each `--cu` is a source with the checkout's
weight layout and C entry point. The script builds them and the
checkout's kernel (`current`) with the package's nvcc flags into a
temporary directory, one nvcc each, in parallel. It feeds each the
serve path's inputs of `chip_smoke.py` (flagship config, 8 sessions
three decisions in; [8,32] compacted and [8,200] full width), checks
each against the plain version (1e-5) and times each kernel alone with
`chip_smoke.kernel_ms` (torch.profiler), in rounds whose order
alternates. Prints one JSON line per version and shape, the ptxas
report of every build and the card's name and power limit; writes all
of it to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import chip_smoke


def build_all(sources: dict, tmp: str) -> tuple[dict, dict]:
    """name -> loaded library and name -> ptxas lines, one nvcc each."""
    from sparksched_tpu_torch.kernels import build

    procs = {}
    for name, cu in sources.items():
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(so)
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln or "smem" in ln]
    return libs, ptxas


def row_major(w) -> "torch.Tensor":
    """The baseline's layout: each layer's W (out x in) then b."""
    import torch

    return torch.cat([t.reshape(-1) for ls in (w.prep, w.msg, w.update)
                      for pair in ls for t in pair]).contiguous()


def launcher(lib, f, w, packed, nl: int, slope: float):
    """A call of one version's C entry point on features `f` (the output
    and the edgeless flags allocated once, outside the call)."""
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import edgeless_per_lane

    fn = lib.decima_node_encoder_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 6 + [ctypes.c_float, ctypes.POINTER(ci),
                                         vp]
    fn.restype = ci
    b, k, s, nf = f.x.shape
    d = int(w.prep[-1][0].shape[0])
    el = edgeless_per_lane(f.adj).contiguous()
    out = torch.empty((b, k, s, d), device=f.x.device)
    spec = w.spec.ctypes.data_as(ctypes.POINTER(ci))
    stream = torch.cuda.current_stream().cuda_stream
    args = [f.x.data_ptr(), f.adj.data_ptr(), f.node_level.data_ptr(),
            f.node_mask.data_ptr(), el.data_ptr(), packed.data_ptr(),
            out.data_ptr(), b, k, s, nf, d, nl, float(slope), spec, stream]

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return out

    return call


def profiled_ms(call, reps: int, tries: int = 3) -> float:
    """The kernel's own time per call (chip_smoke.kernel_ms), taking a
    new profiler session when one recorded no kernel at all."""
    for i in range(tries):
        try:
            return chip_smoke.kernel_ms(call, reps, "decima_node_encoder")[0]
        except AssertionError:
            if i == tries - 1:
                raise


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-cu", required=True)
    ap.add_argument("--cu", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="test_artifacts/encoder_ab.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from sparksched_tpu_torch.env.observe import observe
    from sparksched_tpu_torch.kernels import build
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder_ref,
    )
    from sparksched_tpu_torch.schedulers.decima import compact_features
    from sparksched_tpu_torch.serve import SessionStore

    sources = {"baseline": a.baseline_cu,
               "current": os.path.join(build.CSRC, "decima_encoder.cu")}
    for spec in a.cu:
        name, _, path = spec.partition("=")
        sources[name] = path
    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas = build_all(sources, tmp)
        params, bank, agent = chip_smoke.flagship("cuda")
        sched = chip_smoke.make_scheduler(params, agent, "cuda")
        store = SessionStore(params, bank, sched, capacity=8, max_batch=8,
                             seed=7, device="cuda")
        sids = [store.create() for _ in range(8)]
        for _ in range(3):
            store.decide_batch(sids)
        f_full = sched.features(observe(params, store.store.env))
        f_k, _ = compact_features(f_full, sched.job_bucket)
        net = sched.net
        w = net.encoder_weights()
        s = f_k.x.shape[2]
        nl = min(net.num_levels, s) if net.num_levels else s
        results, rows = {"card": chip_smoke.card_line(), "ptxas": ptxas}, []
        for shape, f in (("B8_K32", f_k), ("B8_K200", f_full)):
            ins = (f.x, f.adj, f.node_level, f.node_mask)
            ref = decima_node_encoder_ref(*ins, w, net.num_levels, net.slope)
            calls, per = {}, {}
            for name, lib in libs.items():
                packed = row_major(w) if name == "baseline" else w.packed
                calls[name] = launcher(lib, f, w, packed, nl, net.slope)
                err = float((calls[name]() - ref).abs().max())
                if not err <= chip_smoke.TOL:
                    raise AssertionError(f"{name} {shape}: err {err}")
                per[name] = {"max_abs_err": err, "ms_rounds": []}
            order = list(libs)
            for r in range(a.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    per[name]["ms_rounds"].append(
                        profiled_ms(calls[name], a.reps))
            for name, v in per.items():
                v["ms"] = sum(v["ms_rounds"]) / len(v["ms_rounds"])
                row = {"shape": shape, "version": name, **v}
                rows.append(row)
                print(json.dumps(row), flush=True)
            results[shape] = per
    results["rows"] = rows
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(json.dumps({"ptxas": ptxas}))
    print(results["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
