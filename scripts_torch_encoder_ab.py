#!/usr/bin/env python3
"""The NodeEncoder kernels beside earlier versions of them, on one CUDA card.

    git show 7743228:sparksched_tpu_torch/csrc/decima_encoder.cu \\
        > test_artifacts/encoder_baseline.cu
    git show 9c87f80:sparksched_tpu_torch/csrc/decima_encoder_bwd.cu \\
        > test_artifacts/bwd_baseline.cu
    python3 scripts_torch_encoder_ab.py \\
        [--baseline-cu test_artifacts/encoder_baseline.cu [--cu NAME=PATH ...]]
        [--bwd-baseline-cu test_artifacts/bwd_baseline.cu \\
         [--bwd-cu NAME=PATH ...]]

The forward: `--baseline-cu` is a `decima_encoder.cu` that reads its
weights row-major (each layer's W as out x in, then b), the layout of the
kernel's first version; each `--cu` is a source with the checkout's
weight layout and C entry point. The script builds them and the
checkout's kernel (`current`) with the package's nvcc flags into a
temporary directory, one nvcc each, in parallel. It feeds each the
serve path's inputs of `chip_smoke.py` (flagship config, 8 sessions
three decisions in; [8,32] compacted and [8,200] full width), checks
each against the plain version (1e-5) and times each kernel alone with
`chip_smoke.kernel_ms` (torch.profiler), in rounds whose order
alternates.

The backward: `--bwd-baseline-cu` is a `decima_encoder_bwd.cu` with the
C entry point of its first version (per-block partials, a `blocks`
argument); it is built beside the checkout's and each `--bwd-cu` (a
source with the checkout's C entry points). All get update chunks of
real rollout features (the flagship config trained on the card for two
iterations of `--steps` rows, as chip_smoke.py's `train` does; the first
256 and 1,024 valid observations of the last rollout, which continues
the first one's episodes, as the PPO update builds them) with a seeded
dL/dh, are checked against the plain
backward in float64 with each LeakyReLU on the branch of the new
kernel's float32 forward (`bwd_ref64_pinned`; the error against the
plain float64 backward on its own branches is reported beside) (1e-4 *
max|ref| + 1e-6 per gradient tensor; a
version outside it is reported, and the script exits 1 after the
timings) and timed alone (every kernel of a call, torch.profiler) in
alternating rounds.

Prints one JSON line per version and shape, the ptxas report of every
build and the card's name and power limit; writes all of it to --out.
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
                       if "entry function" in ln or "registers" in ln
                       or "spill" in ln or "smem" in ln]
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

    call.keep = (el,)  # the launch reads these by pointer: keep them alive
    return call


def profiled_ms(call, reps: int, kernels) -> float:
    """The kernels' own time per call (chip_smoke.kernel_ms, which takes a
    new profiler session when one recorded no kernel at all). Raises
    rather than set a CUDA-events time beside the profiler's."""
    ms, _, source = chip_smoke.kernel_ms(call, reps, kernels)
    if source != "profiler":
        raise RuntimeError(f"torch.profiler recorded no device work for "
                           f"{kernels}")
    return ms


def fwd_ab(a, tmp, results, rows) -> None:
    """The forward kernel beside `--baseline-cu` and each `--cu`."""
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
    libs, ptxas = build_all(sources, tmp)
    results["ptxas"] = ptxas
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
        alternate(calls, per, a, "decima_node_encoder")
        for name, v in per.items():
            row = {"shape": shape, "version": name, **v}
            rows.append(row)
            print(json.dumps(row), flush=True)
        results[shape] = per


def bwd_launcher(lib, f, w, g, nl: int, slope: float, baseline: bool):
    """A call of one backward version's C entry point on features `f` and
    dL/dh `g` (the gradient, the scratch and the edgeless flags allocated
    once, outside the call): the first version's (per-block partials,
    three blocks per SM) or the checkout's (scratch from its query).
    Returns (call, scratch bytes)."""
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        edgeless_per_lane,
        unpack_grad,
    )

    vp, ci = ctypes.c_void_p, ctypes.c_int
    b, k, s, nf = f.x.shape
    d = int(w.prep[-1][0].shape[0])
    el = edgeless_per_lane(f.adj).contiguous()
    spec = w.spec.ctypes.data_as(ctypes.POINTER(ci))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grad = torch.empty(w.packed.numel(), device=f.x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ins = [f.x.data_ptr(), f.adj.data_ptr(), f.node_level.data_ptr(),
           f.node_mask.data_ptr(), el.data_ptr(), w.packed.data_ptr(),
           g.data_ptr()]
    fn = lib.decima_node_encoder_bwd_launch
    fn.restype = ci
    if baseline:
        blocks = min(b * k, 3 * sms)
        scratch = torch.empty((max(blocks, 1), w.packed.numel()),
                              device=f.x.device)
        fn.argtypes = [vp] * 9 + [ci] * 6 + [ctypes.c_float,
                                             ctypes.POINTER(ci), ci, vp]
        args = ins + [scratch.data_ptr(), grad.data_ptr(), b, k, s, nf, d,
                      nl, float(slope), spec, blocks, stream]
        nbytes = scratch.numel() * 4
    else:
        q = lib.decima_node_encoder_bwd_scratch
        q.argtypes = [ci] * 5 + [ctypes.POINTER(ci), ci,
                                 ctypes.POINTER(ctypes.c_longlong)]
        q.restype = ci
        nb = ctypes.c_longlong()
        if q(b, k, s, nf, d, spec, sms, ctypes.byref(nb)) != 0:
            raise RuntimeError("scratch query refused the dims")
        scratch = torch.empty(nb.value, dtype=torch.uint8, device=f.x.device)
        fn.argtypes = [vp] * 8 + [ctypes.c_longlong, vp] + [ci] * 6 + [
            ctypes.c_float, ctypes.POINTER(ci), ci, vp]
        args = ins + [scratch.data_ptr(), nb.value, grad.data_ptr(), b, k,
                      s, nf, d, nl, float(slope), spec, sms, stream]
        nbytes = nb.value

    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return unpack_grad(w, grad)

    call.keep = (el, scratch, grad)  # read and written by pointer
    return call, nbytes


BWD_KERNELS = ("live_count_kernel", "live_list_kernel",
               "decima_node_encoder_bwd_kernel", "reduce_partials_kernel",
               "reduce_warps_kernel", "reduce_groups_kernel")


def bwd_ab(a, tmp, results, rows) -> None:
    """The backward kernel beside `--bwd-baseline-cu` on update chunks."""
    import torch

    from sparksched_tpu_torch.kernels import build
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder_bwd_ref,
    )
    from sparksched_tpu_torch.trainers import make_trainer

    sources = {"bwd_baseline": a.bwd_baseline_cu,
               "bwd_current": os.path.join(build.CSRC,
                                           "decima_encoder_bwd.cu")}
    for spec in a.bwd_cu:
        name, _, path = spec.partition("=")
        sources[name] = path
    libs, ptxas = build_all(sources, tmp)
    results["bwd_ptxas"] = ptxas
    print(json.dumps({"bwd_ptxas": ptxas}), flush=True)
    # two iterations, as chip_smoke's `train`: the second rollout continues
    # the episodes, so its observations hold mid-episode job counts
    cfg = chip_smoke.train_cfg(num_iterations=2, rollout_steps=a.steps)
    trainer = make_trainer(cfg, device="cuda")
    trainer.train()
    ro = trainer.last_rollout
    net = trainer.scheduler.net
    w = net.encoder_weights()
    d = net.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    helpers = chip_smoke.parity_helpers()
    for items in (256, 1024):
        f = chip_smoke.update_chunk_features(trainer, ro, items)
        shape = f"update_chunk_{int(f.x.shape[0])}"
        s = f.x.shape[2]
        nl = min(net.num_levels, s) if net.num_levels else s
        g = torch.randn(tuple(f.x.shape[:3]) + (d,), device="cuda",
                        generator=gen)
        ins = (f.x, f.adj, f.node_level, f.node_mask)
        ref = helpers.bwd_ref64_pinned(*ins, w, net.num_levels, net.slope, g)
        ref_plain = helpers.bwd_ref64(*ins, w, net.num_levels, net.slope, g,
                                      lanes=64)
        calls, per = {}, {}
        for name, lib in libs.items():
            calls[name], nbytes = bwd_launcher(
                lib, f, w, g, nl, net.slope, name == "bwd_baseline")
            got = calls[name]()
            again = calls[name]()
            torch.cuda.synchronize()
            err, ratio = chip_smoke.bwd_err(got, ref)
            per[name] = {"max_abs_err": err, "err_over_tol": ratio,
                         "plain64_err_over_tol":
                             chip_smoke.bwd_err(got, ref_plain)[1],
                         "within_tol": ratio <= 1.0,
                         "same_bits": all(torch.equal(x, y)
                                          for x, y in zip(got, again)),
                         "scratch_bytes": nbytes, "ms_rounds": []}
        _, plain32 = chip_smoke.bwd_err(
            decima_node_encoder_bwd_ref(*ins, w, net.num_levels, net.slope,
                                        g), ref_plain)
        alternate(calls, per, a, BWD_KERNELS, reps=a.bwd_reps)
        bound = chip_smoke.bound(*chip_smoke.bwd_work(f, net))
        for name, v in per.items():
            row = {"shape": shape, "dims": list(f.x.shape), "version": name,
                   "live_jobs": int(f.node_mask.any(-1).sum()),
                   **v, "plain32_err_over_tol": plain32, **bound}
            rows.append(row)
            print(json.dumps(row), flush=True)
        results[shape] = per


def alternate(calls: dict, per: dict, a, kernels, reps=None) -> None:
    """Each call's kernel time, in rounds whose order alternates."""
    order = list(calls)
    for r in range(a.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            per[name]["ms_rounds"].append(
                profiled_ms(calls[name], reps or a.reps, kernels))
    for v in per.values():
        v["ms"] = sum(v["ms_rounds"]) / len(v["ms_rounds"])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-cu")
    ap.add_argument("--cu", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--bwd-baseline-cu")
    ap.add_argument("--bwd-cu", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--steps", type=int, default=128,
                    help="rollout_steps of the two training iterations "
                    "whose last rollout gives the backward's update chunks")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--bwd-reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="test_artifacts/encoder_ab.json")
    a = ap.parse_args()
    if not (a.baseline_cu or a.bwd_baseline_cu):
        ap.error("give --baseline-cu and/or --bwd-baseline-cu")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    results, rows = {"card": chip_smoke.card_line()}, []
    with tempfile.TemporaryDirectory() as tmp:
        if a.baseline_cu:
            fwd_ab(a, tmp, results, rows)
        if a.bwd_baseline_cu:
            bwd_ab(a, tmp, results, rows)
    results["rows"] = rows
    bad = [r for r in rows if r.get("within_tol") is False]
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(json.dumps({k: v for k, v in results.items()
                      if k.endswith("ptxas")}))
    print(results["card"])
    if bad:
        print("outside tolerance: " + ", ".join(
            f"{r['version']} {r['shape']}" for r in bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
