#!/usr/bin/env python3
"""Where a training iteration of the PyTorch port goes on the card.

    python3 scripts_torch_train_profile.py [--steps 9600] [--split-rows 256]
        [--window 16] [--out artifacts/port/train_profile.json]

Builds `config/decima_tpch.yaml`'s trainer on the card (16 lanes, the
config's widths, its own weights from seed 42) with `rollout_steps`
cut to `--steps` (9600 is the config's own) and measures:

1. one iteration as `Trainer.train` runs it: collection seconds, rows
   and valid decisions, decisions/s, rows left early; update seconds,
   minibatches applied, update chunks and the peak memory of the update;
   each encoder kernel's launches over the iteration;
2. the split per row over a collection of `--split-rows` rows, each part
   timed between `torch.cuda.synchronize()` calls: the policy
   (features, net, sampling), the engine (`decide_micro_step` and
   `drain_to_decision`) and the rest (observe, the in-place record
   writes, health, the key chain);
3. torch.profiler over `--window` rows taken from the middle of that
   collection: torch ops and kernel launches per row, device busy time
   and the device's idle share of the window's wall;
4. torch.profiler over the update of that collection: each encoder
   kernel's launches and mean device time there.

Prints one JSON object (also written to `--out`) with the card's name and
power limit. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "config", "decima_tpch.yaml")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def save(path: str, out: dict) -> None:
    """Write what is measured so far (each phase adds to it)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def cuda_events(prof):
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=9600)
    ap.add_argument("--split-rows", type=int, default=256)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(
        HERE, "artifacts", "port", "train_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from torch.profiler import ProfilerActivity, profile

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.config import load
    from sparksched_tpu_torch.kernels import build
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.trainers import make_trainer
    from sparksched_tpu_torch.trainers import rollout as tro
    from sparksched_tpu_torch.trainers.ppo import UPDATE_CHUNK

    build.build_all()
    cfg = load(CONFIG)
    cfg["trainer"] |= {"num_iterations": 1, "rollout_steps": args.steps}
    trainer = make_trainer(cfg, device="cuda")
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0),
           "lanes": trainer.num_envs, "rollout_steps": args.steps,
           "update_chunk": UPDATE_CHUNK}

    # 1. one iteration as train() runs it
    decima_node_encoder.launches = decima_node_encoder_bwd.launches = 0
    stats = {}
    trainer.train(callback=lambda i, st, s: stats.update(s))
    out["iteration"] = {k: stats[k] for k in (
        "collect_seconds", "rows", "decisions", "update_seconds",
        "minibatches_applied", "kl_stopped", "update_chunks",
        "max_memory_allocated", "episode_length", "health_mask")}
    out["iteration"]["decisions_per_s"] = (stats["decisions"]
                                           / stats["collect_seconds"])
    out["iteration"]["rows_per_s"] = stats["rows"] / stats["collect_seconds"]
    out["iteration"]["encoder_launches"] = decima_node_encoder.launches
    out["iteration"]["encoder_bwd_launches"] = decima_node_encoder_bwd.launches
    print(json.dumps({"phase": "iteration", **out["iteration"]}), flush=True)
    save(args.out, out)

    # 2. the split per row, 3. a profiled window of rows
    split = {"policy_s": 0.0, "engine_s": 0.0}
    sched = trainer.scheduler
    orig = (sched.batch_policy, tro.decide_micro_step, tro.drain_to_decision)
    mid = max(0, args.split_rows // 2 - args.window // 2)
    calls = {"rows": 0}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def timed(key, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t
            return r
        return wrapper

    def policy(*a, **k):
        n = calls["rows"]
        if n == mid:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        if n == mid + args.window:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()
        calls["rows"] += 1
        return timed("policy_s", orig[0])(*a, **k)

    sched.batch_policy = policy
    tro.decide_micro_step = timed("engine_s", orig[1])
    tro.drain_to_decision = timed("engine_s", orig[2])
    trainer.rollout_steps = args.split_rows
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ro, _ = trainer._collect(0, prng.PRNGKey(7, "cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sched.batch_policy = orig[0]
        tro.decide_micro_step, tro.drain_to_decision = orig[1], orig[2]
    rows = calls["rows"]
    out["split"] = {
        "rows": rows, "wall_s": wall, "ms_per_row": wall / rows * 1e3,
        "policy_ms_per_row": split["policy_s"] / rows * 1e3,
        "engine_ms_per_row": split["engine_s"] / rows * 1e3,
        "rest_ms_per_row": (wall - split["policy_s"] - split["engine_s"])
        / rows * 1e3,
        "decisions": int(ro.valid.sum()),
    }
    if "wall" in window:
        ev = cuda_events(prof)
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("aten::")]
        launches = [e for e in prof.events()
                    if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchKernelExC")]
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        n = args.window
        out["window"] = {
            "rows": n, "first_row": mid, "wall_ms": window["wall"] * 1e3,
            "aten_ops_per_row": len(ops) / n,
            "kernel_launches_per_row": len(launches) / n,
            "device_kernels_per_row": len(ev) / n,
            "device_busy_ms_per_row": busy / n,
            "device_idle_share": 1 - busy / (window["wall"] * 1e3),
        }
    print(json.dumps({"phase": "split", **out["split"],
                      **out.get("window", {})}), flush=True)
    save(args.out, out)

    # 4. the update of that collection, profiled
    state = trainer.init_state()
    state.rng = prng.PRNGKey(3, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as uprof:
        _, ustats = trainer._update(state, ro)
        torch.cuda.synchronize()
    upd = {"seconds_profiled": time.perf_counter() - t,
           "minibatches_applied": ustats["minibatches_applied"],
           "update_chunks": ustats["update_chunks"],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    ev = cuda_events(uprof)
    for key, names in (("encoder_fwd", ("decima_node_encoder_kernel",)),
                       ("encoder_bwd", ("live_count_kernel",
                                        "live_list_kernel",
                                        "decima_node_encoder_bwd_kernel",
                                        "reduce_warps_kernel",
                                        "reduce_groups_kernel"))):
        for nm in names:
            ts = [e.time_range.elapsed_us() for e in ev if nm in e.name]
            upd[f"{key}:{nm}"] = {
                "records": len(ts),
                "mean_ms": sum(ts) / len(ts) / 1e3 if ts else None}
    upd["device_busy_ms"] = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    out["update"] = upd
    print(json.dumps({"phase": "update", **upd}), flush=True)
    save(args.out, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
