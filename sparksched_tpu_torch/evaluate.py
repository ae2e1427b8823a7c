"""Trained-Decima vs fair-scheduler evaluation on held-out seeds (the port's
counterpart of `scripts_eval_decima.py`):

    python -m sparksched_tpu_torch.evaluate [--model PATH] [--seeds N]
        [--steps T] [--device cpu] [--out result.json]

Both schedulers play the same episodes: lane i starts from
`core.reset(PRNGKey(10_000 + i))`, so each seed's job arrivals are the
same for both. Episodes run through the single-eval flat collector
(`collect_flat_sync_batch`, the engine's default knobs, no auto-reset)
for at most `--steps` decisions per lane; Decima decides greedily from a
model file (the JAX package's flax-msgpack `model.msgpack` or a
reference `.pt`). The environment is the script's: 10 executors, 20 job
slots, moving delay 2000, warmup delay 1000, arrival rate 4e-5, on the
workload bank the port builds for it. Reported: each seed's average job
completion time (seconds) under both, the means, Decima's wins, and the
near-tied greedy choices among Decima's recorded decisions: the top two
valid scores of its stage or its executor head less than `TIE_GAP`
apart, where two float32 evaluations (the card's and the CPU's) may
choose differently; the exact ties (equal scores on the evaluating
device) among them are counted too. Runs on the card unless `--device
cpu`.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import time
from typing import Any

import numpy as np
import torch

from . import metrics, prng
from .config import EnvParams, resolve_device
from .env import core
from .schedulers import DecimaScheduler, RoundRobinScheduler
from .schedulers.decima import NEG_INF
from .trainers.rollout import (
    Rollout,
    collect_flat_sync_batch,
    stored_to_observation,
)
from .workload import make_workload_bank

ENV = dict(num_executors=10, max_jobs=20, moving_delay=2000.0,
           warmup_delay=1000.0, job_arrival_rate=4.0e-5)
STEPS = 600  # decisions per episode at most (3 x jobs x executors)
HELD_OUT_BASE = 10_000  # disjoint from training's iteration-indexed seeds
# the model the JAX package trained on the TPU, shipped in the checkout
MODEL = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "models",
                 "decima", "model_tpu.msgpack")
AGENT = dict(embed_dim=16,
             gnn_mlp_kwargs={"hid_dims": [32, 16], "act_cls": "LeakyReLU",
                             "act_kwargs": {"negative_slope": 0.2}},
             policy_mlp_kwargs={"hid_dims": [64, 64], "act_cls": "Tanh"})
TIE_GAP = 1e-4  # a greedy choice whose top two scores differ by less


def eval_env(device) -> tuple[EnvParams, Any]:
    """The evaluation's env params and workload bank."""
    params = EnvParams(**ENV)
    bank = make_workload_bank(params.num_executors, params.max_stages,
                              device=device)
    if bank.max_stages != params.max_stages:
        params = params.replace(max_stages=bank.max_stages,
                                max_levels=bank.max_stages)
    return params, bank


def make_decima(model: str, params: EnvParams, device) -> DecimaScheduler:
    """Decima at the script's widths from a model file, full width (the
    JAX script's scheduler has no job bucket)."""
    return DecimaScheduler(params.num_executors, state_dict_path=model,
                           device=device, **AGENT)


def run_episodes(params, bank, policy_fn, seeds, steps: int,
                 device) -> Rollout:
    """One episode per seed through the single-eval collector: the
    `Rollout`."""
    keys = torch.stack([prng.PRNGKey(int(s)) for s in seeds]).to(device)
    states = core.reset(params, bank, keys)
    return collect_flat_sync_batch(
        params, bank, policy_fn, prng.PRNGKey(HELD_OUT_BASE, device), steps,
        states)


def greedy_gaps(sched: DecimaScheduler, bank, ro) -> np.ndarray:
    """For each recorded decision (lane-major order) the gaps between the
    top two valid scores of the stage head and of the executor head
    ([n, 2]; inf where a head had one valid choice), from the stored
    observations."""
    so = ro.obs.map(lambda a: a[ro.valid])
    if so.node_mask.shape[0] == 0:
        return np.zeros((0, 2))
    with torch.no_grad():
        f = sched.features(stored_to_observation(bank, so))
        ss, es = sched.score(f)
        n = ss.shape[0]
        stage = torch.where(f.stage_mask.reshape(n, -1), ss.reshape(n, -1),
                            NEG_INF)
        job = ro.job_idx[ro.valid].clamp_min(0).long()
        rows = torch.arange(n, device=ss.device)
        exe = torch.where(f.exec_mask[rows, job], es[rows, job], NEG_INF)
        gaps = []
        for x in (stage, exe):
            top = torch.topk(x, 2, dim=1).values
            gap = top[:, 0] - top[:, 1]
            gaps.append(torch.where(top[:, 1] > NEG_INF / 2, gap, torch.inf))
    return torch.stack(gaps, 1).cpu().numpy()


def evaluate(model: str = MODEL, num_seeds: int = 24, steps: int = STEPS,
             device="cuda", seeds=None) -> dict:
    """Fair and greedy Decima on the held-out seeds (`seeds`, default
    `HELD_OUT_BASE + range(num_seeds)`). Returns per-seed avg JCT in
    seconds, the means, Decima's wins, the near ties and the rollouts
    (`"rollouts"`, not JSON)."""
    dev = resolve_device(device)
    params, bank = eval_env(dev)
    if seeds is None:
        seeds = list(range(HELD_OUT_BASE, HELD_OUT_BASE + int(num_seeds)))
    fair = RoundRobinScheduler(params.num_executors, dynamic_partition=True)
    dec = make_decima(model, params, dev)
    out: dict[str, Any] = {"model": model, "seeds": [int(s) for s in seeds],
                           "steps": int(steps), "env": ENV,
                           "device": str(dev), "rollouts": {}}
    policies = {
        "fair": fair.policy,
        "decima": lambda k, o: dec.batch_policy(k, o, deterministic=True),
    }
    for name, pol in policies.items():
        t0 = time.perf_counter()
        ro = run_episodes(params, bank, pol, seeds, steps, dev)
        fs = ro.final_state
        ajd = metrics.avg_job_duration(fs).cpu().numpy().astype(np.float64)
        out[name] = {
            "avg_jct_s": (ajd * 1e-3).tolist(),
            "mean_avg_jct_s": float(ajd.mean() * 1e-3),
            "all_done": bool(fs.all_jobs_complete.all()),
            "done": fs.all_jobs_complete.cpu().tolist(),
            "decisions": int(ro.valid.sum()),
            "seconds": time.perf_counter() - t0,
        }
        out["rollouts"][name] = ro
    heads = greedy_gaps(dec, bank, out["rollouts"]["decima"])
    near = heads < TIE_GAP
    gaps = heads.min(1)
    out["decima"]["near_ties"] = int(near.any(1).sum())
    out["decima"]["near_ties_by_head"] = {"stage": int(near[:, 0].sum()),
                                          "exec": int(near[:, 1].sum())}
    out["decima"]["exact_ties"] = int((heads == 0).any(1).sum())
    out["decima"]["tie_gap"] = TIE_GAP
    pos = gaps[gaps > 0]
    out["decima"]["min_gap"] = float(pos.min()) if pos.size else None
    a, b = np.array(out["decima"]["avg_jct_s"]), np.array(
        out["fair"]["avg_jct_s"])
    out["decima_wins"] = int((a < b).sum())
    out["decima_vs_fair"] = float(a.mean() / b.mean() - 1.0)
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args(argv)
    res = evaluate(args.model, args.seeds, args.steps, args.device)
    res.pop("rollouts")
    for i, s in enumerate(res["seeds"]):
        print(f"seed {s}: fair {res['fair']['avg_jct_s'][i]:.1f} s, "
              f"decima {res['decima']['avg_jct_s'][i]:.1f} s")
    print(f"mean avg JCT: fair {res['fair']['mean_avg_jct_s']:.1f} s, "
          f"decima {res['decima']['mean_avg_jct_s']:.1f} s "
          f"({res['decima_vs_fair'] * 100:+.1f}%), decima wins "
          f"{res['decima_wins']}/{len(res['seeds'])}; near-tied greedy "
          f"choices {res['decima']['near_ties']} of "
          f"{res['decima']['decisions']} (gap < {TIE_GAP}; exact ties "
          f"{res['decima']['exact_ties']}); "
          f"{res['fair']['seconds']:.1f} + {res['decima']['seconds']:.1f} s")
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(res, fp, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
