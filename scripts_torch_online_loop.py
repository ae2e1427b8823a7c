#!/usr/bin/env python3
"""The online learning loop on the card, and what recording costs the
serving path: the `serve:` block of `config/decima_tpch.yaml` (capacity
64, max_batch 8, hot_capacity 32, groups 2, the continuous front) at the
flagship shape, driven by `run_open_loop` at one offered rate with
seeded Poisson arrivals, in three arms interleaved repetition by
repetition (the order rotates each repetition, so drift hits all three
alike):

- `off`: the record-off store;
- `record`: the per-decision record path (`record: true`, `ring: 0`),
  the learner live: the config's `online:` block built by
  `online_from_config`, stepping in the background on its own stream,
  swaps applied between calls (`on_poll=bus.pump`);
- `ring`: the device ring (`record: true`, `ring: 32`, the default
  cadence 16), the learner live as above.

Then the queueing-free companion: full-batch `decide_batch` calls on a
warm store of each arm (no learner), interleaved call by call. The
record overhead is the paired per-repetition change of the mean latency
against `off` (`obs.metrics.paired_ab_pct`), and the median change of
the warm call's time.

    python3 scripts_torch_online_loop.py --rps 40 --requests 960 --reps 3

Writes `artifacts/port/online_loop.json` (`--out`) and prints one JSON
line per run, the summary, and the card's name and power limit. The
weights are the port's seed-42 init scaled by 0.3, as in
`chip_smoke.py`; every run starts from them on a fresh store."""

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
         "pager_aware": True, "deterministic": True, "seed": 0,
         "front": "continuous"}
ARMS = {"off": {}, "record": {"record": True},
        "ring": {"record": True, "ring": 32},
        # diagnostic arms: the ring with the buffer but no learner, and
        # with the learner live but its versions never applied
        "ring_nolearner": {"record": True, "ring": 32},
        "ring_noswap": {"record": True, "ring": 32}}
# the config's documented online: block
ONLINE = {"max_trajectories": 64, "max_steps": 32, "batch_trajectories": 4,
          "min_decisions": 2, "max_param_lag": 4, "swap_every": 1,
          "probation_decisions": 32, "max_quarantine_rate": 0.5,
          "learner": {"num_epochs": 2, "num_batches": 2}, "seed": 0}


def card_line(device: str) -> str:
    if device != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rps", type=float, default=40.0)
    ap.add_argument("--requests", type=int, default=960)
    ap.add_argument("--tenants", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--window-calls", type=int, default=40,
                    help="warm decide_batch calls per arm")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--arms", nargs="+", default=["off", "record", "ring"],
                    choices=sorted(ARMS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=os.path.join(HERE, "config",
                                                     "decima_tpch.yaml"))
    ap.add_argument("--out", default=os.path.join(HERE, "artifacts", "port",
                                                  "online_loop.json"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    from sparksched_tpu_torch.config import env_params_from_cfg, load
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.obs.metrics import paired_ab_pct
    from sparksched_tpu_torch.online import online_from_config
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.serve import (
        front_from_config,
        generate_arrivals,
        run_open_loop,
        store_from_config,
    )
    from sparksched_tpu_torch.workload import make_workload_bank

    dev = args.device
    cfg = load(args.config)
    params = env_params_from_cfg(cfg["env"])
    bank = make_workload_bank(params.num_executors, params.max_stages,
                              device=dev)
    params = params.replace(max_stages=bank.max_stages,
                            max_levels=bank.max_stages)
    agent = {k: v for k, v in cfg["agent"].items() if k != "agent_cls"}
    weights = {k: v.cpu() * 0.3 for k, v in DecimaScheduler(
        params.num_executors, seed=args.seed, device=dev,
        **agent).params.items()}

    def sched():
        s = DecimaScheduler(params.num_executors, seed=args.seed,
                            device=dev, **agent)
        s.load_params(weights)
        return s

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    arrivals = generate_arrivals(args.rps, args.requests, args.tenants,
                                 seed=args.seed)
    rows, names = [], list(args.arms)
    t_all = time.perf_counter()
    for rep in range(args.reps):
        k = rep % len(names)
        order = names[k:] + names[:k]
        for name in order:
            block = BLOCK | ARMS[name]
            store = store_from_config(block, params, bank, sched(),
                                      device=dev)
            front = front_from_config(block, store)
            loop = None
            if store.record:
                loop = online_from_config(
                    ONLINE, store,
                    {"agent_cls": "DecimaScheduler"} | agent)
                loop[1].warmup()
            live = loop and name != "ring_nolearner"
            calls = []  # (version, batch size, call ms) of each call
            recs: dict = {}  # version -> what its decisions looked like
            if loop:
                ingest, add = loop[0].ingest_chunk, loop[0].add

                def tally(v, jobs, dt, nexec):
                    r = recs.setdefault(int(v), [0, 0.0, 0.0, 0.0])
                    r[0] += 1
                    r[1] += float(jobs)
                    r[2] += float(dt)
                    r[3] += float(nexec)

                def ingest_chunk(c, _ingest=ingest):
                    for i in range(len(c.sid)):
                        tally(c.params_version[i], c.obs.job_mask[i].sum(),
                              c.dt[i], c.num_exec[i])
                    _ingest(c)

                def add_result(r, _add=add):
                    if r.decided:
                        tally(r.params_version, r.obs.job_mask.sum(), r.dt,
                              r.num_exec)
                    _add(r)

                loop[0].ingest_chunk, loop[0].add = ingest_chunk, add_result
            serve_batch = store.decide_batch

            def timed(sids, _serve=serve_batch, _calls=calls, _st=store):
                t = time.perf_counter()
                rs = _serve(sids)
                _calls.append((_st.params_version, len(sids),
                               (time.perf_counter() - t) * 1e3))
                return rs

            store.decide_batch = timed
            sync()
            decima_node_encoder.launches = 0
            decima_node_encoder_bwd.launches = 0
            if live:
                loop[1].start_background()
            try:
                out = run_open_loop(
                    store, front, arrivals, session_seed=20_000,
                    on_poll=(loop[2].pump if live and name != "ring_noswap"
                             else None))
            finally:
                if live:
                    loop[1].stop()
            t = time.perf_counter()
            store.drain_ring(wait=True)
            drain_ms = (time.perf_counter() - t) * 1e3
            lat = np.array(out["samples_ms"])
            row = {
                "arm": name, "rep": rep, "offered_rps": out["offered_rps"],
                "achieved_rps": out["achieved_rps"],
                "mean_ms": float(lat.mean()),
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "completed": out["completed"],
                "makespan_s": out["makespan_s"],
                "batch_calls": store.stats["serve_batch_calls"],
                "decisions": store.stats["serve_decisions"],
                "wall_split": dict(store.wall_split),
                "encoder_launches": decima_node_encoder.launches,
                "encoder_bwd_launches": decima_node_encoder_bwd.launches,
                "ring": {k: v for k, v in store.stats.items()
                         if k.startswith("serve_ring")},
                "final_drain_ms": drain_ms,
                "calls_by_version": {
                    v: {"calls": len(c), "mean_batch": float(np.mean(
                        [x[1] for x in c])), "mean_call_ms": float(
                        np.mean([x[2] for x in c]))}
                    for v in sorted({x[0] for x in calls})
                    for c in [[x for x in calls if x[0] == v]]},
                # per version: the active jobs a decision saw, the sim
                # time it advanced, the executors it committed
                "records_by_version": {
                    v: {"records": n, "mean_active_jobs": j / n,
                        "mean_dt": d / n, "mean_num_exec": e / n}
                    for v, (n, j, d, e) in sorted(recs.items())},
            }
            if loop:
                buf, learner, bus = loop
                if learner.error is not None:
                    raise RuntimeError(f"learner thread: {learner.error!r}")
                ms = [h["update_s"] * 1e3 for h in learner.history]
                row.update({
                    "learner": dict(learner.stats), "bus": dict(bus.stats),
                    "buffer": dict(buf.stats),
                    "learner_step_ms": (float(np.mean(ms)) if ms
                                        else None),
                    "params_version": store.params_version,
                })
            rows.append(row)
            print(json.dumps(row), flush=True)

    # the queueing-free companion: warm full-batch calls, interleaved
    # (the store kinds only: the diagnostic arms' store is the ring's)
    wnames = [n for n in ("off", "record", "ring") if n in names]
    stores, sids = {}, {}
    for name in wnames:
        block = BLOCK | ARMS[name]
        stores[name] = store_from_config(block, params, bank, sched(),
                                         device=dev)
        made = [stores[name].create(seed=70_000 + i)
                for i in range(2 * BLOCK["max_batch"])]
        sids[name] = [s for s in made
                      if stores[name].session_group(s) == 0]
    window = {n: [] for n in wnames}
    for i in range(args.window_calls + 3):
        k = i % len(wnames)
        for name in wnames[k:] + wnames[:k]:
            st = stores[name]
            sync()
            t = time.perf_counter()
            rs = st.decide_batch(sids[name])
            sync()
            if i >= 3:  # warm-up calls
                window[name].append((time.perf_counter() - t) * 1e3)
            for j, r in enumerate(rs):
                if r.done or r.health_mask:
                    # the freed slot is group 0's: the new session's
                    st.close(r.session_id)
                    sids[name][j] = st.create(seed=71_000 + 100 * i + j)
    for st in stores.values():
        st.drain_ring(wait=True)

    def arm(name, key):
        return [r[key] for r in rows if r["arm"] == name]

    names = [n for n in ARMS if n in names]
    summary = {
        "open_loop": {name: {
            "achieved_rps_median": float(np.median(arm(name,
                                                       "achieved_rps"))),
            "mean_ms_median": float(np.median(arm(name, "mean_ms"))),
            "p50_ms_median": float(np.median(arm(name, "p50_ms"))),
            "p99_ms_median": float(np.median(arm(name, "p99_ms"))),
        } for name in names},
        "record_overhead_pct": {
            name: paired_ab_pct(arm("off", "mean_ms"), arm(name, "mean_ms"))
            for name in names if name != "off" and "off" in names},
        "window_call_ms": {name: {
            "median": float(np.median(window[name])),
            "p90": float(np.percentile(window[name], 90)),
            "n": len(window[name])} for name in wnames},
        "window_overhead_pct": {
            name: 100.0 * (np.median(window[name])
                           / np.median(window["off"]) - 1.0)
            for name in wnames if name != "off" and "off" in wnames},
        "seconds": time.perf_counter() - t_all,
    }
    card = card_line(dev)
    doc = {"protocol": {"block": BLOCK, "arms": ARMS, "online": ONLINE,
                        "offered_rps": args.rps, "requests": args.requests,
                        "tenants": args.tenants, "reps": args.reps,
                        "window_calls": args.window_calls,
                        "seed": args.seed, "device": dev,
                        "torch": torch.__version__},
           "card": card, "runs": rows, "window_ms": window,
           "summary": summary}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(doc, fp, indent=1)
    print(json.dumps({"summary": summary}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
