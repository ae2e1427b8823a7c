#!/usr/bin/env python3
"""Open-loop serving load on the card: the `serve:` block of
`config/decima_tpch.yaml` as documented there (capacity 64, max_batch 8,
hot_capacity 32, groups 2), built by `store_from_config` at the flagship
shape, driven by `run_open_loop` with seeded Poisson arrivals from 64
tenants at each offered rate through each front. Prints one JSON row per
(rate, front) and the card's name and power limit.

    python3 scripts_torch_serve_load.py --rps 40 80 \\
        --fronts continuous pipelined --requests 480

The weights are the port's seed-42 init scaled by 0.3, as in
`chip_smoke.py`. Each run gets a fresh store; runs alternate fronts
within a rate so drift hits them alike."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = {"capacity": 64, "max_batch": 8, "hot_capacity": 32, "groups": 2,
         "pager_aware": True, "deterministic": True, "seed": 0}
FRONTS = {"continuous": {"front": "continuous"},
          "pipelined": {"front": "pipelined", "depth": 2, "prefetch": True},
          "linger": {"front": "linger", "linger_ms": 2}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rps", type=float, nargs="+", default=[40.0, 80.0])
    ap.add_argument("--fronts", nargs="+", default=["continuous",
                                                    "pipelined"],
                    choices=sorted(FRONTS))
    ap.add_argument("--requests", type=int, default=480)
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    from sparksched_tpu_torch.config import env_params_from_cfg, load
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.serve import (
        front_from_config,
        generate_arrivals,
        run_open_loop,
        store_from_config,
    )
    from sparksched_tpu_torch.workload import make_workload_bank

    cfg = load(os.path.join(HERE, "config", "decima_tpch.yaml"))
    params = env_params_from_cfg(cfg["env"])
    bank = make_workload_bank(params.num_executors, params.max_stages,
                              device="cuda")
    params = params.replace(max_stages=bank.max_stages,
                            max_levels=bank.max_stages)
    agent = {k: v for k, v in cfg["agent"].items() if k != "agent_cls"}
    sched = DecimaScheduler(params.num_executors, seed=args.seed,
                            device="cuda", **agent)
    sched.load_params({k: v.cpu() * 0.3 for k, v in sched.params.items()})
    for rps in args.rps:
        arrivals = generate_arrivals(rps, args.requests, args.tenants,
                                     seed=args.seed)
        for rep in range(args.reps):
            order = args.fronts if rep % 2 == 0 else args.fronts[::-1]
            for name in order:
                block = BLOCK | FRONTS[name]
                store = store_from_config(block, params, bank, sched,
                                          device="cuda")
                front = front_from_config(block, store)
                torch.cuda.synchronize()
                out = run_open_loop(store, front, arrivals,
                                    session_seed=20_000)
                lat = np.array(out["samples_ms"])
                print(json.dumps({
                    "rps_offered": out["offered_rps"], "front": name,
                    "rep": rep, "achieved_rps": out["achieved_rps"],
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "completed": out["completed"],
                    "rejected": out["capacity_rejections"],
                    "makespan_s": out["makespan_s"],
                    "batch_calls": store.stats["serve_batch_calls"],
                    "decisions": store.stats["serve_decisions"],
                    "page_ins": store.stats["serve_page_ins"],
                    "prefetches": store.stats["serve_prefetches"],
                    "inflight_peak": store.stats["serve_inflight_peak"],
                    "wall_split": store.wall_split,
                }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
