#!/usr/bin/env python3
"""Where a served decision's time goes in the PyTorch port, on one card.

    python3 scripts_torch_serve_profile.py [--calls 8] [--trace DIR]
                                           [--knobs serve|off]
                                           [--device cuda]

Builds the flagship-shape `SessionStore(device="cuda")` exactly as
`chip_smoke.py` does (64 sessions, max_batch 8, seeded weights) at the
store's default engine knobs (`--knobs serve`: `SERVE_KNOBS`, the bulk
event passes on) or with the bulk knobs off (`--knobs off`: the
sequential engine), warms it up, then times `--calls` `decide_batch`
calls three ways and prints one JSON line each:

- `split`: wall time per call, split into the policy (observe, features,
  Decima net with the NodeEncoder kernel, greedy head) and the engine
  (`apply_and_drain`), each closed by a device synchronize; plus the
  event-drain iterations per call.
- `profile`: `torch.profiler` over the same calls: device-busy time (sum
  of kernel durations), the device's idle share of the wall time, kernel
  launches per call, and the top kernels and host ops; and the fused
  bulk event pass, each call inside a `record_function` range
  `engine.bulk_events_fused` (through `flat_loop._bulk_events_fused`):
  its calls, host ms, torch ops and kernel launches per call; and the
  host time per call inside the PRNG's functions (`prng_host`, each
  outermost call in a range `prng.<fn>` as the train profile script
  counts them; the key chain `split`, `fold_in` and `derive`), with the
  `threefry2x32` wrapper's launches per call.
- `launches`: host-dispatched torch ops per drain iteration, counted
  with a dispatch mode on one call.

With `--trace DIR` the profiler's chrome trace is written there.
Runs on the card; `--device cpu` rehearses the script on the CPU (its
times are then the CPU's, not the card's). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from scripts_torch_train_profile import (
        BULK_RANGE,
        KEY_CHAIN_FNS,
        LAUNCH_NAMES,
        PRNG_FNS,
        PrngRanges,
        inside,
    )
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode

    from sparksched_tpu_torch.env import flat_loop
    from sparksched_tpu_torch.kernels.threefry import threefry2x32
    from sparksched_tpu_torch.serve import SessionStore, aot

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--knobs", choices=("serve", "off"), default="serve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    knobs = None if args.knobs == "serve" else cs.KNOBS_OFF
    dev = args.device
    on_card = dev == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    params, bank, agent = cs.flagship(dev)
    sched = cs.make_scheduler(params, agent, dev)
    store = SessionStore(params, bank, sched, capacity=cs.CAPACITY,
                         max_batch=cs.MAX_BATCH, seed=0, knobs=knobs,
                         device=dev)
    sids = [store.create() for _ in range(cs.CAPACITY)]
    groups = [sids[i:i + cs.MAX_BATCH]
              for i in range(0, cs.CAPACITY, cs.MAX_BATCH)]
    for g in groups:  # warm-up: one call per group
        store.decide_batch(g)

    # --- split: policy vs engine, and drain iterations ---------------------
    timers = {"policy_s": 0.0, "engine_s": 0.0}
    iters = [0]
    orig_policy, orig_aad = sched.batch_policy, aot.apply_and_drain
    orig_drain = flat_loop.drain_micro_step

    def timed(key, fn):
        def run(*a, **k):
            sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            timers[key] += time.perf_counter() - t
            return out
        return run

    def counted(*a, **k):
        iters[0] += 1
        return orig_drain(*a, **k)

    sched.batch_policy = timed("policy_s", orig_policy)
    aot.apply_and_drain = timed("engine_s", orig_aad)
    flat_loop.drain_micro_step = counted
    t0 = time.perf_counter()
    for i in range(args.calls):
        store.decide_batch(groups[i % len(groups)])
    wall = time.perf_counter() - t0
    sched.batch_policy, aot.apply_and_drain = orig_policy, orig_aad
    flat_loop.drain_micro_step = orig_drain
    card = cs.card_line() if on_card else "cpu"
    print(json.dumps({
        "phase": "split", "knobs": store.knobs, "calls": args.calls,
        "wall_ms_per_call": wall / args.calls * 1e3,
        "policy_ms_per_call": timers["policy_s"] / args.calls * 1e3,
        "engine_ms_per_call": timers["engine_s"] / args.calls * 1e3,
        "drain_iters_per_call": iters[0] / args.calls,
        "engine_ms_per_drain_iter": timers["engine_s"] / max(iters[0], 1) * 1e3,
        "card": card,
    }), flush=True)

    # --- profile: device busy share and kernel launches --------------------
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    orig_bulk = flat_loop._bulk_events_fused

    def ranged(*a, **k):
        with record_function(BULK_RANGE):
            return orig_bulk(*a, **k)

    flat_loop._bulk_events_fused = ranged
    ranges = PrngRanges()
    ranges.install()
    tf0 = threefry2x32.launches + threefry2x32.plain_calls
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.calls):
                store.decide_batch(groups[i % len(groups)])
            sync()
            wall = time.perf_counter() - t0
    finally:
        flat_loop._bulk_events_fused = orig_bulk
        ranges.remove()
    tf_calls = threefry2x32.launches + threefry2x32.plain_calls - tf0
    # the device's kernel records, without the `record_function` range's
    # annotation on the device timeline (no device work)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_kernel: dict[str, list[float]] = {}
    for e in kernels:
        s = by_kernel.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.elapsed_us()
    top_dev = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    host = prof.key_averages()
    top_host = sorted(host, key=lambda a: -a.cpu_time_total)[:8]
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    passes = [e for e in cpu if e.name == BULK_RANGE]
    n = args.calls
    prng_host = {}
    for name in PRNG_FNS:
        rs = [e for e in cpu if e.name == f"prng.{name}"]
        prng_host[name] = {
            "calls_per_call": len(rs) / n,
            "host_ms_per_call": sum(e.time_range.elapsed_us()
                                    for e in rs) / 1e3 / n}
    print(json.dumps({
        "phase": "profile", "knobs": args.knobs, "calls": args.calls,
        "wall_ms_per_call": wall / args.calls * 1e3,
        "device_busy_ms_per_call": busy_us / 1e3 / args.calls,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_call": len(kernels) / args.calls,
        "top_kernels": [{"name": n[:80], "launches": c, "us": us}
                        for n, (c, us) in top_dev],
        "top_host_ops": [{"name": a.key, "calls": a.count,
                          "cpu_ms": a.cpu_time_total / 1e3}
                         for a in top_host],
        "bulk_events_fused": {
            "calls_per_call": len(passes) / n,
            "host_ms_per_call": sum(e.time_range.elapsed_us()
                                    for e in passes) / 1e3 / n,
            "aten_ops_per_call": len(inside(
                [e for e in cpu if e.name.startswith("aten::")], passes)) / n,
            "kernel_launches_per_call": len(inside(
                [e for e in cpu if e.name in LAUNCH_NAMES], passes)) / n},
        "prng_host": prng_host,
        "key_chain_host_ms_per_call": sum(
            prng_host[k]["host_ms_per_call"] for k in KEY_CHAIN_FNS),
        "key_chain_calls_per_call": sum(
            prng_host[k]["calls_per_call"] for k in KEY_CHAIN_FNS),
        "threefry2x32_calls_per_call": tf_calls / n,
        "card": card,
    }), flush=True)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "serve_trace.json"))

    # --- launches: host-dispatched ops per drain iteration -----------------
    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.n += 1
            return func(*a, **(kw or {}))

    iters[0] = 0
    flat_loop.drain_micro_step = counted
    with Count() as c:
        store.decide_batch(groups[0])
    flat_loop.drain_micro_step = orig_drain
    print(json.dumps({
        "phase": "launches", "knobs": args.knobs, "torch_ops_per_call": c.n,
        "drain_iters": iters[0],
        "torch_ops_per_drain_iter": c.n / max(iters[0], 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
