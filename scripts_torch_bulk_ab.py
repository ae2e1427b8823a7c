#!/usr/bin/env python3
"""The fused bulk event kernel against an earlier version of it, in one
process on the card, on the inputs `chip_smoke.py` captures.

    python3 scripts_torch_bulk_ab.py [--baseline-rev 75e977f] [--reps 5]
        [--parent DIR] [--tag TAG] [--out-dir artifacts/port]

1. The baseline: `sparksched_tpu_torch/csrc/bulk_events.cu`,
   `engine_core.cuh` and `prng_core.cuh` at `--baseline-rev`, written by
   `git show` into `test_artifacts/bulk_ab_<rev>/` (gitignored) where the
   checkout has git; a copy of the checkout without `.git` must bring
   them there. The baseline and this tree's `bulk_events.cu` are built
   with `kernels/build.py`'s nvcc flags into a temporary directory and
   loaded side by side (the same C entry point and argument layout).
2. The captures: `chip_smoke.py`'s `train` phase (the flagship config,
   2 iterations at rollout_steps 128 under rbg keys, the pass's inputs
   at calls 0, 1, 3, 7, ..., the last 6 kept), the same states with
   their threefry words, and one 48-row `lowprec` iteration (the int16
   bank, rbg).
3. For each capture: the two builds' outputs bit-equal, then each
   build's device time from torch.profiler (`chip_smoke.kernel_ms`) in
   turns, baseline, new, new, baseline, `--reps` times over; the
   capture's events and its longest lane's scan steps beside them; per
   version and impl the least-squares fit ms = fixed + per_step x steps
   over the `train` captures; and the ratio baseline / new at the
   `train` capture that consumed the most events (the smoke's timed
   one).
4. With `--parent DIR` (the parent commit unpacked by `git archive`):
   one pair of `scripts_torch_train_profile.py --steps 64 --split-rows 64`
   per impl (rbg, threefry2x32), the parent's script run from DIR, then
   this tree's, each in a process of its own (rows 24-39 profiled).

Writes `<out-dir>/bulk_ab_<tag>_captures.json` and, with `--parent`,
`<out-dir>/train_profile_<tag>_<impl>_{parent,change}.json`; every file
holds the card's name and power limit. Needs a CUDA card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "sparksched_tpu_torch", "csrc")
FILES = ("bulk_events.cu", "engine_core.cuh", "prng_core.cuh")
LOWPREC_ROWS = 48


def smoke():
    """`chip_smoke.py`, loaded by path (its phases and timers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def baseline_sources(rev: str) -> str:
    """The directory holding the baseline's three files, written from
    git where the checkout has it."""
    d = os.path.join(HERE, "test_artifacts", f"bulk_ab_{rev}")
    if os.path.isdir(os.path.join(HERE, ".git")):
        os.makedirs(d, exist_ok=True)
        for f in FILES:
            src = subprocess.run(
                ["git", "show", f"{rev}:sparksched_tpu_torch/csrc/{f}"],
                cwd=HERE, capture_output=True, check=True).stdout
            with open(os.path.join(d, f), "wb") as fh:
                fh.write(src)
    missing = [f for f in FILES if not os.path.exists(os.path.join(d, f))]
    if missing:
        raise SystemExit(f"baseline sources missing from {d}: {missing}")
    return d


def build(src_dir: str, out_dir: str, name: str):
    """`src_dir/bulk_events.cu` built with build.py's flags; its C entry
    point with its argument types."""
    from sparksched_tpu_torch.kernels import build as kb

    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", lib,
                           os.path.join(src_dir, "bulk_events.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    so = ctypes.CDLL(lib)
    fn = so.bulk_events_fused_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def launcher(fn, args):
    """A call of `fn` on the capture's packed arguments (outputs
    allocated once: every launch writes all of them)."""
    import torch

    from sparksched_tpu_torch.kernels import bulk_events as bk

    p, b, st, on, stop, me = args
    outs, ptrs, dims, warm = bk.pack(p, b, st, on, stop, me)
    cp = (ctypes.c_int64 * len(ptrs))(*ptrs)
    cd = (ctypes.c_int64 * len(dims))(*dims)

    def call():
        rc = fn(cp, cd, warm, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed (rc={rc})")
        return outs

    return call


def captures(cs) -> dict:
    """name -> [(params, bank, state, enabled, stop, max_events)]."""
    import torch

    from sparksched_tpu_torch.trainers import make_trainer

    cs.phase_train()
    rows = cs.BULK_CAPTURES["train"]
    out = {"train_rbg": list(rows),
           "train_threefry": [(p, b, st.replace(
               rng=st.rng[:, :2].contiguous()), on, stop, me)
               for p, b, st, on, stop, me in rows]}
    cfg = cs.train_cfg(num_iterations=1, rollout_steps=LOWPREC_ROWS)
    cfg["env"] = cfg["env"] | cs.LOWPREC_ENV
    trainer = make_trainer(cfg, device="cuda")
    with cs.BulkCapture("lowprec"):
        trainer.train()
    torch.cuda.synchronize()
    out["lowprec_int16_rbg"] = list(cs.BULK_CAPTURES["lowprec"])
    return out


def ab(cs, fns: dict, caps: dict, reps: int) -> dict:
    import torch

    from sparksched_tpu_torch.env.core import _bulk_events_fused_ref
    from sparksched_tpu_torch.kernels import bulk_events as bk

    res = {}
    for key, rows in caps.items():
        res[key] = []
        for i, args in enumerate(rows):
            calls = {v: launcher(fn, args) for v, fn in fns.items()}
            outs = {v: c() for v, c in calls.items()}
            torch.cuda.synchronize()
            st = args[2]
            got = {v: bk.unpack(st, o) for v, o in outs.items()}
            want = _bulk_events_fused_ref(args[0], args[1], st, args[3],
                                          stop_at_limit=args[4],
                                          max_events=args[5])
            for v, g in got.items():
                bad = cs._bulk_unequal(g, want)
                if bad:
                    raise AssertionError(f"{key}[{i}] {v}: differs from the "
                                         f"plain version at {bad}")
            ms = {v: [] for v in fns}
            for _ in range(reps):
                for v in ("baseline", "new", "new", "baseline"):
                    ms[v].append(cs.kernel_ms(calls[v], 20,
                                              "bulk_events_fused_kernel")[0])
            g = got["new"]
            res[key].append({
                "events": int((g[1] + g[2]).sum()),
                "steps": cs.bulk_steps(args[3], g),
                "lanes": int(st.rng.shape[0]),
                "ms": {v: statistics.median(x) for v, x in ms.items()},
                "ms_all": ms,
                "ratio": statistics.median(ms["baseline"])
                / statistics.median(ms["new"])})
            print(json.dumps({"capture": key, "i": i,
                              **{k: res[key][-1][k] for k in (
                                  "events", "steps", "ms", "ratio")}}),
                  flush=True)
    return res


def profile_pair(parent: str, tag: str, out_dir: str) -> dict:
    """One parent / change pair of the training profile per impl."""
    done = {}
    for impl in ("rbg", "threefry2x32"):
        for which, root in (("parent", parent), ("change", HERE)):
            out = os.path.join(out_dir, f"train_profile_{tag}_{impl}_"
                                        f"{which}.json")
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable,
                 os.path.join(root, "scripts_torch_train_profile.py"),
                 "--steps", "64", "--split-rows", "64", "--impls", impl,
                 "--out", out], cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{which} profile ({impl}) failed:\n"
                                   f"{proc.stderr[-4000:]}")
            done[f"{impl}_{which}"] = {
                "file": os.path.relpath(out, HERE),
                "seconds": time.perf_counter() - t}
            print(json.dumps({"profile": impl, "tree": which,
                              **done[f"{impl}_{which}"]}), flush=True)
    return done


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-rev", default="75e977f")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--tag", default=None,
                    help="output name part (default: vs_<baseline-rev>)")
    ap.add_argument("--out-dir", default=os.path.join(HERE, "artifacts",
                                                      "port"))
    args = ap.parse_args()
    args.tag = args.tag or f"vs_{args.baseline_rev}"
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    args.out_dir = os.path.abspath(args.out_dir)  # the parent runs elsewhere
    os.makedirs(args.out_dir, exist_ok=True)
    base_dir = baseline_sources(args.baseline_rev)
    cs = smoke()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bulk_ab_") as tmp:
        cs.TMP_ROOT = tmp
        cs.phase_build()
        fns, ptxas = {}, {}
        fns["baseline"], ptxas["baseline"] = build(base_dir, tmp, "base")
        fns["new"], ptxas["new"] = build(CSRC, tmp, "new")
        caps = captures(cs)
        res = ab(cs, fns, caps, args.reps)
    fit = {}
    for key in ("train_rbg", "train_threefry"):
        xs = [r["steps"] for r in res[key]]
        fit[key] = {v: dict(zip(("fixed_ms", "per_step_ms"), cs._line_fit(
            xs, [r["ms"][v] for r in res[key]]))) for v in fns}
    timed = max(range(len(res["train_rbg"])),
                key=lambda i: res["train_rbg"][i]["events"])
    out = {"card": cs.card_line(), "device": torch.cuda.get_device_name(0),
           "baseline_rev": args.baseline_rev, "reps": args.reps,
           "order": "baseline, new, new, baseline",
           "ptxas": ptxas, "captures": res, "fit": fit,
           "timed": {k: {"capture": timed, **res[k][timed]}
                     for k in ("train_rbg", "train_threefry")},
           "seconds": time.perf_counter() - t0}
    path = os.path.join(args.out_dir, f"bulk_ab_{args.tag}_captures.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "fit", "timed")}),
          flush=True)
    if args.parent:
        out["profiles"] = profile_pair(os.path.abspath(args.parent),
                                       args.tag, args.out_dir)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
