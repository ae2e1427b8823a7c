#!/usr/bin/env python3
"""Open-loop serving load on the card: the `serve:` block of
`config/decima_tpch.yaml` as documented there (capacity 64, max_batch 8,
hot_capacity 32, groups 2), built by `store_from_config` at the flagship
shape, driven by `run_open_loop` with seeded Poisson arrivals from 64
tenants at each offered rate through each front. Prints one JSON row per
(rate, front) and the card's name and power limit.

    python3 scripts_torch_serve_load.py --rps 40 80 \\
        --fronts continuous pipelined --requests 480

With `--replicas N` it pairs the in-process store against a fleet of N
replica processes (`serve/router.py`, every replica on the card, each
the same block behind the continuous front), both traced: the runs
alternate in-process / fleet within a rate and swap order every rep,
each row carries the critical-path split at p50 and p99 (for the fleet
from the replicas' span stamps re-anchored on the router's submit, the
rest of the wall in `wire_reply`: the pipe hops and the router loop),
and the rows go to `artifacts/port/serve_fleet.json` (`--out`):

    python3 scripts_torch_serve_load.py --replicas 2 --rps 40 80 \\
        --reps 2 --requests 960

The flagship setup, the weights (the port's seed-42 init scaled by 0.3)
and the replicas' builder are `chip_smoke.py`'s (`flagship`,
`make_scheduler`, `fleet_builder`). Each run gets a fresh store (a fresh fleet for the
replica runs); runs alternate within a rate so drift hits them alike."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = {"capacity": 64, "max_batch": 8, "hot_capacity": 32, "groups": 2,
         "pager_aware": True, "deterministic": True, "seed": 0}
FRONTS = {"continuous": {"front": "continuous"},
          "pipelined": {"front": "pipelined", "depth": 2, "prefetch": True},
          "linger": {"front": "linger", "linger_ms": 2}}
FLEET_OUT = os.path.join(HERE, "artifacts", "port", "serve_fleet.json")


def _row(out: dict, **extra) -> dict:
    lat = np.array(out["samples_ms"])
    return {"rps_offered": out["offered_rps"],
            "achieved_rps": out["achieved_rps"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "completed": out["completed"],
            "rejected": out["capacity_rejections"],
            "errors": out["errors"], "makespan_s": out["makespan_s"],
            **extra}


def _split(crit) -> dict:
    """The critical-path split at p50 and p99 (segment -> ms of the
    requests near that quantile)."""
    snap = crit.snapshot()
    return {q: snap.get(q) for q in ("at_p50", "at_p99")} | {
        "dominant_tail_segment": snap.get("dominant_tail_segment")}


def run_in_process(block, params, bank, sched, arrivals):
    from sparksched_tpu_torch.serve import (
        front_from_config,
        run_open_loop,
        store_from_config,
    )
    import torch

    store = store_from_config(block, params, bank, sched, device="cuda")
    front = front_from_config(block, store, metrics=store.metrics,
                              trace=bool(block.get("trace")))
    torch.cuda.synchronize()
    out = run_open_loop(store, front, arrivals, session_seed=20_000)
    return out, store, front


def run_fleet(block, weights, replicas: int, arrivals, device="cuda",
              builder="chip_smoke:fleet_builder"):
    """One fresh fleet: boot, the open loop through the router (each
    ticket's submit and ready times stamped on the router's thread), the
    critical path re-anchored per request, stop."""
    from sparksched_tpu_torch.obs.critpath import CritPathAnalyzer
    from sparksched_tpu_torch.obs.metrics import MetricsRegistry
    from sparksched_tpu_torch.serve import ReplicaSpec, Router, run_open_loop

    spec = ReplicaSpec(builder=builder, builder_kwargs={"weights": weights},
                       serve_cfg=block, trace=True, device=device)
    t = time.perf_counter()
    router = Router(spec, replicas=replicas, metrics=MetricsRegistry())
    boot_s = time.perf_counter() - t
    try:
        stamped: list = []  # [ticket, t_submit, t_ready]
        open_: list = []
        submit, poll = router.submit, router.poll

        def stamped_submit(gsid):
            tk = submit(gsid)
            rec = [tk, time.perf_counter(), None]
            stamped.append(rec)
            open_.append(rec)
            return tk

        def stamped_poll():
            moved = poll()
            now = time.perf_counter()
            for rec in [r for r in open_ if r[0].ready]:
                rec[2] = now
                open_.remove(rec)
            return moved

        router.submit, router.poll = stamped_submit, stamped_poll
        out = run_open_loop(router, router, arrivals, session_seed=20_000)
        crit = CritPathAnalyzer()
        for tk, t_sub, t_ready in stamped:
            res = tk.result
            if res is None or not res.spans_ms or t_ready is None:
                continue
            spans = {k: t_sub + v / 1e3 for k, v in res.spans_ms.items()}
            spans["wire_submit"] = t_sub
            spans["wire_reply"] = t_ready
            crit.observe(spans, replica=res.replica)
        samples = router.replica_samples()
        info = router.replica_info()
    finally:
        router.stop()
    return out, crit, samples, info, boot_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rps", type=float, nargs="+", default=[40.0, 80.0])
    ap.add_argument("--fronts", nargs="+", default=["continuous",
                                                    "pipelined"],
                    choices=sorted(FRONTS))
    ap.add_argument("--requests", type=int, default=480)
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42,
                    help="seeds the arrivals")
    ap.add_argument("--replicas", type=int, default=0,
                    help="pair the in-process store against a fleet of "
                         "this many replica processes")
    ap.add_argument("--out", default=FLEET_OUT,
                    help="where --replicas writes its rows")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    from chip_smoke import flagship, make_scheduler
    from sparksched_tpu_torch.serve import generate_arrivals

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    params, bank, agent = flagship("cuda")
    sched = make_scheduler(params, agent, "cuda")
    if args.replicas > 0:
        from sparksched_tpu_torch.kernels import build

        build.build_all()  # once, before any replica loads the kernels
        weights = {k: v.detach().cpu().numpy()
                   for k, v in sched.params.items()}
        block = BLOCK | FRONTS["continuous"] | {"trace": True}
        rows = []
        for rps in args.rps:
            arrivals = generate_arrivals(rps, args.requests, args.tenants,
                                         seed=args.seed)
            for rep in range(args.reps):
                arms = ("in_process", "fleet")
                for arm in (arms if rep % 2 == 0 else arms[::-1]):
                    if arm == "fleet":
                        out, crit, samples, info, boot_s = run_fleet(
                            block, weights, args.replicas, arrivals)
                        row = _row(out, arm=f"fleet{args.replicas}",
                                   rep=rep, critpath=_split(crit),
                                   boot_s=boot_s,
                                   decisions_per_replica=[
                                       s["stats"]["serve_decisions"]
                                       for s in samples],
                                   replica_boot_s=[i["boot_s"]
                                                   for i in info])
                    else:
                        out, store, front = run_in_process(
                            block, params, bank, sched, arrivals)
                        row = _row(out, arm="in_process", rep=rep,
                                   critpath=_split(front.critpath),
                                   batch_calls=store.stats[
                                       "serve_batch_calls"],
                                   wall_split=store.wall_split)
                    row["card"] = card
                    rows.append(row)
                    print(json.dumps(row), flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump({"script": "scripts_torch_serve_load.py",
                       "argv": sys.argv[1:], "card": card,
                       "torch": torch.__version__, "block": block,
                       "replicas": args.replicas, "tenants": args.tenants,
                       "requests": args.requests, "rows": rows}, fp,
                      indent=1)
        print(card, flush=True)
        return 0
    for rps in args.rps:
        arrivals = generate_arrivals(rps, args.requests, args.tenants,
                                     seed=args.seed)
        for rep in range(args.reps):
            order = args.fronts if rep % 2 == 0 else args.fronts[::-1]
            for name in order:
                out, store, _front = run_in_process(
                    BLOCK | FRONTS[name], params, bank, sched, arrivals)
                print(json.dumps(_row(
                    out, front=name, rep=rep,
                    batch_calls=store.stats["serve_batch_calls"],
                    decisions=store.stats["serve_decisions"],
                    page_ins=store.stats["serve_page_ins"],
                    prefetches=store.stats["serve_prefetches"],
                    inflight_peak=store.stats["serve_inflight_peak"],
                    wall_split=store.wall_split)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
