#!/usr/bin/env python3
"""Where a training iteration of the PyTorch port goes on the card.

    python3 scripts_torch_train_profile.py [--steps 9600] [--split-rows 256]
        [--window 16] [--impls rbg threefry2x32] [--memory]
        [--out artifacts/port/train_profile.json]

Builds `config/decima_tpch.yaml`'s trainer on the card (16 lanes, the
config's widths, its own weights from seed 42) with `rollout_steps`
cut to `--steps` (9600 is the config's own) and, for each PRNG impl of
`--impls` in turn (`rbg` is the config's `fast_prng: True`,
`threefry2x32` the same config with `fast_prng: False`), measures:

1. one iteration as `Trainer.train` runs it: collection seconds, rows
   and valid decisions, decisions/s, rows left early; update seconds,
   minibatches applied, update chunks and the peak memory of the update;
   each encoder kernel's and each PRNG kernel's launches over the
   iteration;
2. the split per row over a collection of `--split-rows` rows, each part
   timed between `torch.cuda.synchronize()` calls: the policy
   (features, net, sampling), the engine (`decide_micro_step` and
   `drain_to_decision`) and the rest (observe, the in-place record
   writes, health, the key chain);
3. torch.profiler over `--window` rows taken from the middle of that
   collection: torch ops and kernel launches per row, device busy time
   and the device's idle share of the window's wall, and the host time
   per row inside the PRNG's functions (`split`, `fold_in` and
   `derive`, the key chain: the threefry path kernel under both impls,
   `derive` a call site's whole chain in one launch (absent on trees
   before it, counted 0 there); `random_bits` and `uniform`, the draws:
   the rbg kernel or the threefry path kernel;
   `split_uniform`, the engine's split-then-draw kernel), each counted
   once at its outermost call, and each PRNG kernel's device records
   and device ms per row; and the fused bulk event pass, each call
   inside a `record_function` range `engine.bulk_events_fused` (its
   callers' name, `flat_loop._bulk_events_fused`): calls, host ms, torch
   ops and kernel launches inside the ranges per row, and the
   `bulk_events_fused` kernel's device records and ms per row;
4. torch.profiler over the update of that collection: each encoder
   kernel's launches and mean device time there.

With `--memory`, then the peak device memory of one collection and one
update at `--steps` under the f32 layouts and under `bank_dtype: int16`
with `obs_dtype: bfloat16` (the same config, seed and keys).

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
    """The device's kernel records. A `record_function` range also shows
    on the device timeline (a user annotation spanning its kernels); it
    is no device work, so it is left out."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


PRNG_FNS = ("split", "fold_in", "derive", "random_bits", "uniform",
            "split_uniform")
KEY_CHAIN_FNS = ("split", "fold_in", "derive")
PRNG_KERNELS = ("threefry2x32_kernel", "split_uniform_kernel",
                "rbg_philox_kernel", "bulk_events_fused_kernel")
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
BULK_RANGE = "engine.bulk_events_fused"
LOWPREC_ENV = {"bank_dtype": "int16", "obs_dtype": "bfloat16"}


class PrngRanges:
    """While installed: each outermost call of the PRNG's functions runs
    inside a `torch.profiler.record_function` range named `prng.<fn>`
    (a function the tree's `prng` lacks is left out)."""

    def __init__(self):
        from sparksched_tpu_torch import prng

        self.prng, self.orig, self.depth = prng, {}, 0

    def install(self):
        from torch.profiler import record_function

        for name in PRNG_FNS:
            if not hasattr(self.prng, name):
                continue
            fn = self.orig[name] = getattr(self.prng, name)

            def ranged(*a, _fn=fn, _name=name, **k):
                if self.depth:
                    return _fn(*a, **k)
                self.depth += 1
                try:
                    with record_function(f"prng.{_name}"):
                        return _fn(*a, **k)
                finally:
                    self.depth -= 1

            setattr(self.prng, name, ranged)

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.prng, name, fn)
        self.orig = {}


class BulkRange:
    """While installed: each call of the fused bulk pass through its
    callers' name (`flat_loop._bulk_events_fused`) runs inside a
    `record_function` range BULK_RANGE."""

    def install(self):
        from torch.profiler import record_function

        from sparksched_tpu_torch.env import flat_loop

        self.flat_loop, self.orig = flat_loop, flat_loop._bulk_events_fused

        def ranged(*a, **k):
            with record_function(BULK_RANGE):
                return self.orig(*a, **k)

        flat_loop._bulk_events_fused = ranged

    def remove(self):
        if getattr(self, "orig", None) is not None:
            self.flat_loop._bulk_events_fused = self.orig
            self.orig = None


def inside(events, ranges) -> list:
    """The events whose start lies inside one of `ranges` (CPU events)."""
    import bisect

    spans = sorted((r.time_range.start, r.time_range.end) for r in ranges)
    starts = [a for a, _ in spans]
    out = []
    for e in events:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= spans[i][1]:
            out.append(e)
    return out


def bulk_counter():
    """The fused bulk kernel's wrapper (its `launches`), or None on a tree
    without it (the parent of an A/B pair, where the plain pass runs)."""
    try:
        from sparksched_tpu_torch.kernels.bulk_events import (
            bulk_events_fused,
        )
    except ImportError:
        return None
    return bulk_events_fused


def build_trainer(steps: int, impl: str, env: dict | None = None):
    from sparksched_tpu_torch.config import load
    from sparksched_tpu_torch.trainers import make_trainer

    cfg = load(CONFIG)
    cfg["trainer"] |= {"num_iterations": 1, "rollout_steps": steps,
                       "fast_prng": impl == "rbg"}
    cfg["env"] |= env or {}
    trainer = make_trainer(cfg, device="cuda")
    assert trainer.prng_impl == impl
    return trainer


def profile_impl(args, impl: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.kernels.rbg import rbg_random_bits, split_uniform
    from sparksched_tpu_torch.kernels.threefry import threefry2x32
    from sparksched_tpu_torch.trainers import rollout as tro

    trainer = build_trainer(args.steps, impl)
    out = {"prng_impl": impl, "lanes": trainer.num_envs}

    # 1. one iteration as train() runs it
    decima_node_encoder.launches = decima_node_encoder_bwd.launches = 0
    rbg_random_bits.launches = threefry2x32.launches = 0
    split_uniform.launches = 0
    bulk = bulk_counter()
    if bulk is not None:
        bulk.launches = 0
    stats = {}
    trainer.train(callback=lambda i, st, s: stats.update(s))
    it = {k: stats[k] for k in (
        "collect_seconds", "rows", "decisions", "update_seconds",
        "minibatches_applied", "kl_stopped", "update_chunks",
        "max_memory_allocated", "episode_length", "health_mask")}
    it["decisions_per_s"] = stats["decisions"] / stats["collect_seconds"]
    it["rows_per_s"] = stats["rows"] / stats["collect_seconds"]
    it["encoder_launches"] = decima_node_encoder.launches
    it["encoder_bwd_launches"] = decima_node_encoder_bwd.launches
    it["rbg_launches"] = rbg_random_bits.launches
    it["threefry_launches"] = threefry2x32.launches
    it["split_uniform_launches"] = split_uniform.launches
    it["bulk_events_fused_launches"] = bulk.launches if bulk else 0
    out["iteration"] = it
    print(json.dumps({"phase": "iteration", "prng_impl": impl, **it}),
          flush=True)

    # 2. the split per row, 3. a profiled window of rows
    split = {"policy_s": 0.0, "engine_s": 0.0}
    sched = trainer.scheduler
    orig = (sched.lane_policy, tro.decide_micro_step, tro.drain_to_decision)
    mid = max(0, args.split_rows // 2 - args.window // 2)
    calls = {"rows": 0}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    ranges, bulk_range = PrngRanges(), BulkRange()
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
            ranges.install()
            bulk_range.install()
            prof.start()
            window["t0"] = time.perf_counter()
        if n == mid + args.window:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()
            ranges.remove()
            bulk_range.remove()
        calls["rows"] += 1
        return timed("policy_s", orig[0])(*a, **k)

    sched.lane_policy = policy
    tro.decide_micro_step = timed("engine_s", orig[1])
    tro.drain_to_decision = timed("engine_s", orig[2])
    trainer.rollout_steps = args.split_rows
    key = prng.PRNGKey(7, "cuda", impl=impl)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ro, _ = trainer._collect(0, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sched.lane_policy = orig[0]
        tro.decide_micro_step, tro.drain_to_decision = orig[1], orig[2]
        ranges.remove()
        bulk_range.remove()
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
        cpu = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU]
        ops = [e for e in cpu if e.name.startswith("aten::")]
        launches = [e for e in prof.events() if e.name in LAUNCH_NAMES]
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        n = args.window
        host = {}
        for name in PRNG_FNS:
            rs = [e for e in cpu if e.name == f"prng.{name}"]
            host[name] = {"calls_per_row": len(rs) / n,
                          "host_ms_per_row": sum(
                              e.time_range.elapsed_us() for e in rs)
                          / 1e3 / n}
        out["window"] = {
            "rows": n, "first_row": mid, "wall_ms": window["wall"] * 1e3,
            "aten_ops_per_row": len(ops) / n,
            "kernel_launches_per_row": len(launches) / n,
            "device_kernels_per_row": len(ev) / n,
            "device_busy_ms_per_row": busy / n,
            "device_idle_share": 1 - busy / (window["wall"] * 1e3),
            "prng_host": host,
            "key_chain_host_ms_per_row": sum(
                host[k]["host_ms_per_row"] for k in KEY_CHAIN_FNS),
            "key_chain_calls_per_row": sum(
                host[k]["calls_per_row"] for k in KEY_CHAIN_FNS),
            "draws_host_ms_per_row": host["random_bits"]["host_ms_per_row"]
            + host["uniform"]["host_ms_per_row"],
            "split_uniform_host_ms_per_row":
                host["split_uniform"]["host_ms_per_row"],
            "prng_kernels": {k: {
                "records_per_row": len([e for e in ev if k in e.name]) / n,
                "device_ms_per_row": sum(e.time_range.elapsed_us()
                                         for e in ev if k in e.name)
                / 1e3 / n} for k in PRNG_KERNELS},
        }
        passes = [e for e in cpu if e.name == BULK_RANGE]
        out["window"]["bulk_events_fused"] = {
            "calls_per_row": len(passes) / n,
            "host_ms_per_row": sum(e.time_range.elapsed_us()
                                   for e in passes) / 1e3 / n,
            "aten_ops_per_row": len(inside(ops, passes)) / n,
            "kernel_launches_per_row": len(inside(launches, passes)) / n,
        }
    print(json.dumps({"phase": "split", "prng_impl": impl, **out["split"],
                      "window": out.get("window")}), flush=True)

    # 4. the update of that collection, profiled
    state = trainer.init_state()
    state.rng = prng.PRNGKey(3, "cuda", impl=impl)
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
    print(json.dumps({"phase": "update", "prng_impl": impl, **upd}),
          flush=True)
    return out


def memory_layout(steps: int, layout: str) -> dict:
    """Peak device memory of one collection and one update at `steps`
    rows under the f32 layouts or LOWPREC_ENV, from the same keys."""
    import torch

    from sparksched_tpu_torch import prng

    trainer = build_trainer(steps, "rbg",
                            LOWPREC_ENV if layout == "bf16" else None)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ro, _ = trainer._collect(0, prng.PRNGKey(7, "cuda", impl="rbg"))
    torch.cuda.synchronize()
    collect_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    trainer._update(state, ro)
    torch.cuda.synchronize()
    out = {"layout": layout, "env": LOWPREC_ENV if layout == "bf16" else {},
           "rollout_steps": steps, "decisions": int(ro.valid.sum()),
           "allocated_before": base, "collect_peak": collect_peak,
           "update_peak": torch.cuda.max_memory_allocated(),
           "duration_buffer_bytes": ro.obs.duration.numel()
           * ro.obs.duration.element_size(),
           "bank_dur_bytes": trainer.bank.dur.numel()
           * trainer.bank.dur.element_size()}
    print(json.dumps({"phase": "memory", **out}), flush=True)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=9600)
    ap.add_argument("--split-rows", type=int, default=256)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--impls", nargs="+", default=["rbg"],
                    choices=["rbg", "threefry2x32"])
    ap.add_argument("--memory", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        HERE, "artifacts", "port", "train_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sparksched_tpu_torch.kernels import build
    from sparksched_tpu_torch.trainers.ppo import UPDATE_CHUNK

    build.build_all()
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0),
           "rollout_steps": args.steps, "update_chunk": UPDATE_CHUNK,
           "by_impl": []}
    for impl in args.impls:
        out["by_impl"].append(profile_impl(args, impl))
        save(args.out, out)
    if args.memory:
        out["memory"] = [memory_layout(args.steps, lay)
                         for lay in ("f32", "bf16")]
        save(args.out, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
