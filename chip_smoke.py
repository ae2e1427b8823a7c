#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`sparksched_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sparksched_tpu_torch/csrc/` with
nvcc, holds each against its plain PyTorch version on the card, then
drives the port's paths at the flagship shape of `config/decima_tpch.yaml`
(50 executors, 200-job cap, 20 stage slots; Decima embed 16, GNN [32,16],
policy [64,64], job_bucket 32) and checks them. The main path is PPO
training as the config runs it (16 lanes, the flat single-eval collector,
3 epochs x 10 minibatches, `fast_prng: True`: every key an rbg key), 2
iterations with `rollout_steps` cut to 128, through
`make_trainer(...).train()`: health 0, parameters finite and changed,
both encoder kernels launched (forward in collection and update,
backward in the update), the three PRNG kernels (the rbg draws, the
threefry path kernel of every key chain, one launch a collection row,
the engine's split_uniform) and the fused bulk event pass (`bulk_events_fused`, one launch a pass,
its uniforms drawn inside), no plain version called, the train state
stamped "rbg". The earlier paths
stay: Decima decisions served by `SessionStore(device="cuda")` at its
default engine knobs (`SERVE_KNOBS`) and with the bulk knobs off
(capacity 64 and max_batch 8 from the config's documented `serve:`
block), the card's decisions against the CPU port's, and whole
fair-policy episodes through `run_flat` (16 lanes, auto-reset) with the
card's lanes held against the CPU port's. Training on 2 lanes is held
against the CPU port too. Training also runs with the config's `obs:`
block and its checkpoints (cadences cut to fire within the 2
iterations), its artifacts in a temporary directory, never the
checkout's `artifacts/`; a 2-lane run resumed from its train state is
compared with an uninterrupted one; the JAX package's trained
`models/decima/model_tpu.msgpack` is evaluated on held-out seeds
against the fair heuristic (the first trained-weights check, the card
against the CPU port); and the telemetry's cost is measured.

The forward kernel is held against its plain version on the serve
path's inputs, on training's (a collection row of the trained rollout
at full width and compacted, update chunks of up to `UPDATE_CHUNK`
observations, with the trained weights; there against the plain
forward in float64, relative to the outputs' scale) and on the seeded
adversarial inputs of `make_case` in
`tests/_torch_parity.py`, loaded by path (levels that are no
topological order, edges into nodes outside node_mask, jobs with no
valid node but with edges, `num_levels` 3, job counts from a single
job to more blocks than the card holds at once); the backward kernel on
the same cases and on update chunks of 16, 256 and 1,024 real rollout
observations, against the plain backward evaluated in float64 with each
LeakyReLU on the branch of the kernel's float32 forward (the error
against the plain float64 backward on its own branches reported beside),
and the same bits on a rerun at the timed chunks. The rbg kernel is held
bit for bit against its plain version on 4,096 keys at odd counts (wrap
keys among them) and at every draw shape training made; the threefry
path kernel and split_uniform likewise under both impls, on 4,096 keys
with counters past 2^32, random path tables, every path table that
training, `serve_front` and `online` used, and every split-then-draw
shape training made. The fused bulk event kernel is held bit for bit against
its plain version on every EnvState field of the pass's inputs captured
on the card from `train` (rbg keys, and the same states with threefry
keys), `lowprec` (the int16 bank) and `serve_front` (a serving store's
gathered slots); every path that runs the engine must launch it and
call no plain version of it.

Phases, in order: `build`, `kernel_vs_plain`, `serve` (4 x 64 decisions
at SERVE_KNOBS), `serve_knobs_off` (2 x 64), `serve_front` (the config's
documented `serve:` block, 64 sessions over 32 device slots in 2 groups,
built by `store_from_config`, driven by `run_open_loop` at 40 requests/s
from 64 tenants, 480 requests through each of the continuous, pipelined
and linger fronts; then the page round trip on the card and two
closed-loop replays held bit-equal: paged grouped against unpaged
one-group, pipelined against synchronous), `serve_http` (a `ServeServer`
on 127.0.0.1 in front of the paged store; a `ServeClient`'s 8 x 16
decisions bit-equal to an in-process store's), `online` (the config's
documented `online:` block over the `serve:` block with the record path
and a 32-record device ring, 960 requests at 40 requests/s from 16
tenants, the learner in the background on its own stream and swaps on
`on_poll`: at least 3 updates accepted and published, one version a
call and never going back, every decided record through the ring and
none dropped; then a replay through a ring store and a per-decision
store giving bit-equal trajectories, and one learner update on the card
against the same update on the CPU), `serve_fleet` (the replica fleet
of `serve/router.py`: 2 replica processes on the one card, each the
`serve:` block with the record path and a 32-record ring, rebuilt from
`fleet_builder`; 8 sessions x 8 decisions through the router equal to an
in-process store's per replica; `run_open_loop` through the router at
80 requests/s from 64 tenants, 960 requests, with the fleet collector
and a quarantine-rate SLO monitor scraping on the loop: every request
reconciled, health 0; every decided result through the rings to one
parent `TrajectoryBuffer`, none dropped; one learner update on the
card accepted and swapped onto both replicas; a poisoned session on
each replica firing exactly one alert that rolls the fleet back; `/fleet`
and the replica-labeled `/metrics` of a `ServeServer` over the router,
with the host profiler's role table; replica 1 killed, its sessions
raising `ReplicaDied` while replica 0 serves on; the forward kernel
launched in each replica, counted there), `card_vs_cpu` (4 sessions x
16 decisions), `run_flat_fair` (16 lanes x 128 groups, two lanes
replayed on the CPU), `train` (the main path; a `train_iteration` line
per iteration), `train_update_profile` (torch.profiler over an update:
both kernels recorded), `kernel_vs_plain_train` (the forward at
training's shapes), `bwd_kernel_vs_plain`, `kernel_alone`,
`rbg` (the rbg kernel against its plain version, then timed at the
train phase's most launched draw shapes against its bound, its plain
version and the threefry draw of the same shape), `prng` (the threefry
path kernel and split_uniform against their plain versions under both
impls, then timed at the train phase's most launched calls),
`train_parity` (one
collection per device, updated at the config's Adam and at a linear
Adam; 2 lanes, T = 64), `train_resume` (2 lanes, T = 32: 2 iterations
against 1 + a resume), `lowprec` (`bank_dtype: int16` and `obs_dtype: bfloat16`: one
iteration at T = 128, its peak memory beside the f32 layout's, and a
2-lane collection on the card against the CPU), `chaos` (the `chaos:`
block's nan_grad, bank_row, straggler and oom on 2 lanes, a real
out-of-memory error from the update, and sigkill in a child process
with the resume held against an uninterrupted run), `eval_trained` (2
held-out seeds on the card, both on the CPU; the forward kernel at
trained weights against the float64 plain forward) and `telemetry_cost`
(16 lanes x 8 rows, telemetry off and on: launches per row and rows
per second); `bulk_kernel` (the fused bulk event kernel against its
plain version on the captured inputs and on the corner cases of
`tests/_bulk_corners.py`, then timed against its bound and the plain
version, each `train` capture's time beside its longest lane's scan
steps with the fit ms = fixed + per_step x steps, a launch with every
lane disabled, and the wrapper's host cost) runs after
`eval_trained`.

Each phase prints one JSON line. Before the last line come the
`{"kernels": [...]}` line (per kernel: launches on the main path and
on each path of this script that runs it (`launches_by_path`), max
abs error against the plain version, the kernel's own time from
torch.profiler at an update chunk, taken after the main path, the plain
version's time and the least time the card could take; for the
backward also its time, bound and scratch bytes at both timed chunks;
for the rbg kernel its time, plain time, threefry time and bound at
each timed draw shape; for the threefry path kernel, split_uniform and
bulk_events_fused their time, wrapper-call time, plain time and bound
at each timed shape)
and the card's
name and power limit from nvidia-smi; the last line is
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero
without that line, as does a run with no CUDA card or without the
package next to this script. Imports no JAX.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "config", "decima_tpch.yaml")
CAPACITY, MAX_BATCH = 64, 8  # the config's documented serve: block
ROUNDS = 4  # ROUNDS x CAPACITY decisions through decide_batch
ROUNDS_OFF = 2  # the same with the bulk knobs off (the earlier path)
KNOBS_OFF = {"event_bulk": False, "fulfill_bulk": False}
PARITY_SESSIONS, PARITY_DECISIONS = 4, 16
FLAT_GROUPS = 128  # run_flat micro-step groups (event_burst 1)
FLAT_CPU_LANES = 2  # lanes of the run_flat phase replayed on the CPU
FLAT_RTOL = 1e-6
# Random-init weights are scaled by 0.3: at flax's init scale the Tanh
# policy heads saturate at the flagship's feature magnitudes and some
# greedy choices tie below float32 resolution, which would make the
# card-vs-CPU decision comparison a coin flip.
WEIGHT_SCALE = 0.3
SEED = 42
TOL = 1e-5
# stress cases: (B, K) per `make_case` case, each at num_levels 0 and 3
STRESS_SHAPES = ((1, 1), (1, 3), (3, 86), (7, 229))
TIMED = ("B8_K32", "B8_K200")  # the serve path's shapes
# the training phases: the flagship config, rollout_steps cut to 128
# (256 until PR 6, cut to keep the whole run near its earlier length)
TRAIN_ITERS, TRAIN_STEPS = 2, 128
# card vs CPU training (at T = 32 the linear Adam's zero-gradient output
# bias of the stage head missed its per-tensor bound, 1.18x; ROADMAP
# queue C)
PARITY_LANES, PARITY_STEPS = 2, 64
# the train phase's checkpoint cadences, cut so that they fire within its
# TRAIN_ITERS iterations (the config: checkpointing_freq 50,
# health.checkpoint_every 25)
TRAIN_CKPT_FREQ, TRAIN_STATE_EVERY = 2, 1
# 2 iterations against 1 + resume 1 (T = 64 until PR 10)
RESUME_LANES, RESUME_STEPS = 2, 32
# trained weights: the JAX package's TPU-trained model, greedy on the
# held-out seeds of `python -m sparksched_tpu_torch.evaluate` (full
# 600-decision episodes), the first EVAL_CPU_SEEDS replayed on the CPU
EVAL_MODEL = os.path.join(HERE, "models", "decima", "model_tpu.msgpack")
# (cut from 8 seeds to 4 with the serving phases added, to 2 with the
# rbg, lowprec and chaos phases, and to 1 with the key-path checks: the
# phase took 206 s of an 891 s run at 2 seeds, 110 s on the card and 88 s
# replaying both on the CPU)
EVAL_SEEDS, EVAL_CPU_SEEDS = 1, 1
# telemetry's cost: lanes and rows of the flagship collection, off and
# on, and the rows whose launches torch.profiler counts (its processing
# of ~25k records a row stalls a window much longer than this)
# 8 rows (32 before the `online` phase took their time, 16 before the
# rbg, lowprec and chaos phases)
TELEMETRY_LANES, TELEMETRY_ROWS, PROFILED_ROWS = 16, 8, 4
# trainer artifacts (checkpoints, train states, run logs) go below this
# temporary directory, never into the checkout's artifacts/
TMP_ROOT: str | None = None
# the backward kernel: per gradient tensor, max abs error against the
# float64 plain backward <= BWD_RTOL * max|ref| + BWD_ATOL
BWD_RTOL, BWD_ATOL = 1e-4, 1e-6
# the forward at training's shapes and weights: max abs error against the
# float64 plain forward <= FWD_RTOL * max|ref| + FWD_ATOL. Training runs
# the net at its init scale, where outputs reach the hundreds and a
# float32 ulp is ~1e-5, so TOL (absolute) holds only the serve and
# stress cases (weights x WEIGHT_SCALE).
FWD_RTOL, FWD_ATOL = 1e-6, 1e-6
BWD_CHUNKS = (16, 256, 1024)  # update-chunk features: observations per chunk
CHUNK_TIMED = "update_chunk_256"  # the forward's and the kernels line's shape
BWD_TIMED = ("update_chunk_256", "update_chunk_1024")
# every kernel a backward call launches (the live list, the warps, the
# two fixed-order reductions)
BWD_KERNELS = ("live_count_kernel", "live_list_kernel",
               "decima_node_encoder_bwd_kernel", "reduce_warps_kernel",
               "reduce_groups_kernel")
# the float64 plain backward runs this many items at a time, and the
# float32 plain backward (one call) only up to this many: at [1024, 200,
# 20] its autograd graph holds ~50 GB
REF_LANES, PLAIN_MAX_ITEMS = 64, 256
# the rbg kernel against its plain version: this many single keys, each
# with an odd count of 1 to 2 * RBG_MAX_ODD - 1 words
RBG_CHECK_KEYS, RBG_MAX_ODD = 4096, 67
RBG_TIMED = 4  # the main path's most launched draw shapes that are timed
# Philox4x32-10 integer work per block of 4 words (10 rounds of 2 wide
# multiplies, 2 three-input xors and 2 key adds), counted low: a bound
RBG_OPS_PER_BLOCK = 60
# the threefry path kernel and split_uniform against their plain
# versions: this many random keys of each impl (non-contiguous views);
# counts and counter bases that cross 2^32; random path tables; the
# timed shapes per kernel
PRNG_CHECK_KEYS = 4096
PRNG_COUNTS = ((3, 0), (67, 2**32 - 33), (2, 2**32 - 1), (1, 2**40 + 5))
PRNG_TABLES = 6  # random path tables, depths 1 to 3
PRNG_TIMED = 2
# threefry2x32's integer work per hash (20 rounds of an add, a rotate and
# a xor, 5 key injections of 2 adds and the counter's words), counted low
TF_OPS_PER_HASH = 80
# the fused bulk event pass: inputs captured at calls 0, 1, 3, 7, ...
# of a path, the last BULK_KEEP kept per path; its integer work per
# executor of a scan step (two passes over the finishes and two over the
# arrivals), and the bank bytes one duration sample gathers besides its
# `dur` entry (4 interval words, a presence byte, the level fallback, 3
# wave counts, the rough duration and the scale)
BULK_KEEP = 6
BULK_OPS_PER_EXEC_STEP = 4
BULK_BANK_BYTES = 16 + 1 + 4 + 12 + 4 + 4
# the low-precision layouts: one iteration at TRAIN_STEPS, card against
# CPU on PARITY_LANES lanes
LOWPREC_ENV = {"bank_dtype": "int16", "obs_dtype": "bfloat16"}
# fault injection on the card: PARITY_LANES lanes at CHAOS_STEPS rows,
# each fault class at its own iteration (seed 3: the bank_row NaN lands
# on a live node of the drill config; here it is reported either way)
CHAOS_STEPS, CHAOS_ITERS = 16, 5
CHAOS_FAULTS = {"nan_grad": [1], "bank_row": [2], "straggler": [3],
                "oom": [4], "seed": 3}
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 outside the
# tensor cores (the kernel runs plain FP32 FMAs); INT32 at half the FP32
# rate (64 INT32 against 128 FP32 lanes per SM per clock on Hopper)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
# kernel_ms: the least host time of a profiled window, and how many
# profiles with no device record are taken before CUDA events stand in
PROFILE_MIN_S, PROFILE_ATTEMPTS = 0.05, 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def flagship(device):
    from sparksched_tpu_torch.config import env_params_from_cfg, load
    from sparksched_tpu_torch.workload import make_workload_bank

    cfg = load(CONFIG)
    params = env_params_from_cfg(cfg["env"])
    bank = make_workload_bank(params.num_executors, params.max_stages,
                              device=device)
    params = params.replace(max_stages=bank.max_stages,
                            max_levels=bank.max_stages)
    agent = {k: v for k, v in cfg["agent"].items() if k != "agent_cls"}
    return params, bank, agent


def make_scheduler(params, agent, device, state_dict=None):
    from sparksched_tpu_torch.schedulers import DecimaScheduler

    sched = DecimaScheduler(params.num_executors, seed=SEED, device=device,
                            **agent)
    if state_dict is None:
        state_dict = {k: v * WEIGHT_SCALE for k, v in sched.params.items()}
    sched.load_params({k: v.cpu() for k, v in state_dict.items()})
    return sched


def cuda_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from sparksched_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln
                       or "spill" in ln or "smem" in ln]
             for n, log in build.build_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(build.SOURCES), "ptxas": ptxas})


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def bound(nbytes: int, flops: int) -> dict:
    """The least time the card could take for work that moves `nbytes`
    and does `flops` FP32 operations: the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _mlp_flops(layers) -> int:
    return sum(2 * int(w.shape[0]) * int(w.shape[1]) for w, _ in layers)


def encoder_work(f, net) -> tuple[int, int]:
    """(bytes, flops) the NodeEncoder must move and do for these inputs.
    Bytes: each input read once (x, adj, levels, node mask, the per-lane
    edgeless flag, the packed weights), the output written once. Flops:
    what this data needs, on node_mask-valid nodes only — prep once per
    node; update once per node (a leaf from its h_init, a node with
    children at its level; none on an edgeless lane, which keeps h_init);
    msg once per child of a node updated at its level; D adds per such
    edge for the aggregation and D per updated node for h_init + update.
    Biases and activations are not counted, which only lowers the bound."""
    b, k, s, _ = f.x.shape
    d = net.embed_dim
    w = net.encoder_weights()
    nbytes = (f.x.numel() * 4 + f.adj.numel() + f.node_level.numel() * 4
              + f.node_mask.numel() + b + w.packed.numel() * 4
              + b * k * s * d * 4)
    nl = min(net.num_levels, s) if net.num_levels else s
    edged = f.adj.reshape(b, -1).any(1)[:, None, None]
    has_child = f.adj.any(-1)
    leaf = f.node_mask & ~has_child & edged
    inner = f.node_mask & has_child & (f.node_level < nl) & edged
    edges = f.adj & inner[..., None]  # [p, c]: p updated at its level
    senders = edges.any(-2)  # c sends a message to an updated parent
    n_inner = int(inner.sum())
    flops = (int(f.node_mask.sum()) * _mlp_flops(w.prep)
             + (int(leaf.sum()) + n_inner) * _mlp_flops(w.update)
             + int(senders.sum()) * _mlp_flops(w.msg)
             + (int(edges.sum()) + n_inner) * d)
    return nbytes, flops


def kernel_ms(fn, reps: int, kernel: str) -> tuple[float, float, str]:
    """Device time per call of `fn` from torch.profiler's records: (the
    kernels whose names hold `kernel`, every device record of the call,
    where the times come from). Each kernel name counts at its mean
    duration times its launches per call (at least one), so a record the
    profiler drops does not bias the sum. The calls are repeated past
    `reps` until the profiled window lasts PROFILE_MIN_S: CUPTI can miss
    the first launches of a window, and 50 calls of a microsecond kernel
    once came back with no device record at all. A profile with no
    device record is taken again (PROFILE_ATTEMPTS in all); after that
    both times are CUDA events over the calls (an upper bound on the
    kernel's time: at these sizes the host's launches set it), and the
    source says "cuda_events". Raises when the profiler recorded device
    work but no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(reps, math.ceil(PROFILE_MIN_S / max(time.perf_counter() - t,
                                                   1e-6)))
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            break
    else:
        ms = cuda_ms(fn, reps)
        return ms, ms, "cuda_events"

    def per_call(names) -> float:
        return sum(sum(by_name[n]) / len(by_name[n])
                   * max(1, round(len(by_name[n]) / reps))
                   for n in names) / 1e3

    ours = [n for n in by_name if any(k in n for k in names)]
    if not ours:
        raise AssertionError(
            f"torch.profiler recorded no launch of {kernel} in {reps} "
            f"calls; device records: {sorted(by_name)}")
    return per_call(ours), per_call(by_name), "profiler"


@functools.cache
def parity_helpers():
    """`tests/_torch_parity.py`, loaded by path: the seeded NodeEncoder
    stress cases and the update comparison the CPU tests use."""
    spec = importlib.util.spec_from_file_location(
        "_torch_parity", os.path.join(HERE, "tests", "_torch_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stress_cases(f_k, s: int, nf: int) -> dict:
    """name -> (inputs on the card, num_levels): the serve features at
    num_levels 3 (the bank's DAGs are up to 5 levels deep), and every
    `make_case` case at STRESS_SHAPES and num_levels 0 and 3 (lane 0
    edgeless where B > 1)."""
    import torch

    cases_mod = parity_helpers()
    CASES, make_case = cases_mod.CASES, cases_mod.make_case
    out = {"B8_K32_num_levels3":
           ((f_k.x, f_k.adj, f_k.node_level, f_k.node_mask), 3)}
    for i, case in enumerate(CASES):
        for b, k in STRESS_SHAPES:
            x, adj, lvl, mask = make_case(case, b, k, s, nf, seed=SEED + i)
            if b > 1:
                adj[0] = False
            ins = tuple(torch.from_numpy(a).cuda() for a in (x, adj, lvl, mask))
            for nl in (0, 3):
                out[f"{case}_B{b}_K{k}_nl{nl}"] = (ins, nl)
    return out


def phase_kernels(params, bank, sched) -> tuple[dict, dict]:
    """Each case's error against the plain version; for the serve path's
    cases also the wrapper and plain times and the bound. Returns the
    cases and, per timed case, a call of the wrapper for
    `phase_kernel_alone`."""
    import torch

    from sparksched_tpu_torch.env.observe import observe
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_ref,
    )
    from sparksched_tpu_torch.schedulers.decima import compact_features
    from sparksched_tpu_torch.serve import SessionStore

    t_phase = time.perf_counter()
    # real flagship-shape sessions, a few decisions into their episodes
    store = SessionStore(params, bank, sched, capacity=MAX_BATCH,
                         max_batch=MAX_BATCH, seed=7, device="cuda")
    sids = [store.create() for _ in range(MAX_BATCH)]
    for _ in range(3):
        store.decide_batch(sids)
    f_full = sched.features(observe(params, store.store.env))
    f_k, _ = compact_features(f_full, sched.job_bucket)
    f_mixed, _ = compact_features(f_full, sched.job_bucket)
    odd = torch.arange(MAX_BATCH, device="cuda") % 2 == 1
    f_mixed.adj = (f_mixed.adj & ~odd[:, None, None, None]).contiguous()
    net = sched.net
    w = net.encoder_weights()
    checks = stress_cases(f_k, f_k.x.shape[2], f_k.x.shape[3])
    cases, calls = {}, {}
    for name, f in (("B8_K32", f_k), ("B8_K200", f_full),
                    ("B8_K32_mixed_edgeless", f_mixed)):
        ins = (f.x, f.adj, f.node_level, f.node_mask)
        args = (w, net.num_levels, net.slope)
        checks[name] = (ins, net.num_levels)
        calls[name] = functools.partial(decima_node_encoder, *ins, *args)
        cases[name] = {
            "shape": list(f.x.shape),
            # the whole wrapper call (CUDA events): the kernel plus the
            # edgeless reduction, the output's allocation and the ctypes
            # call; the kernel alone is timed in phase_kernel_alone
            "wrapper_ms": cuda_ms(calls[name], 50),
            "plain_ms": cuda_ms(lambda: decima_node_encoder_ref(*ins, *args), 10),
        } | bound(*encoder_work(f, net))
    for name, (ins, nl) in checks.items():
        out = decima_node_encoder(*ins, w, nl, net.slope)
        ref = decima_node_encoder_ref(*ins, w, nl, net.slope)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        case = cases.setdefault(name, {"shape": list(ins[0].shape),
                                       "num_levels": nl})
        case["max_abs_err"] = err
        if not err <= TOL:
            raise AssertionError(f"decima_node_encoder {name}: max abs err "
                                 f"{err} > {TOL}")
    emit({"phase": "kernel_vs_plain", "kernel": "decima_node_encoder",
          "tolerance": TOL, "cases": cases,
          "seconds": time.perf_counter() - t_phase})
    return cases, calls, checks


def phase_kernel_alone(cases: dict, calls: dict, sched, chunk,
                       bwd: dict) -> None:
    """Each kernel's own device time from torch.profiler (`kernel_ms`),
    failing when the profiler records device work but none of it: the
    forward at the serve path's shapes
    and at an update chunk (with its plain version and bound there), the
    backward (every kernel of a call) at the update chunks of BWD_TIMED. It
    runs after the main paths, so that no profiler session in this
    process comes before their host-clock numbers."""
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_ref,
    )

    for name in TIMED:
        (cases[name]["ms"], cases[name]["wrapper_device_ms"],
         cases[name]["ms_from"]) = kernel_ms(calls[name], 50,
                                             "decima_node_encoder_kernel")
    net = sched.net
    ins = (chunk.x, chunk.adj, chunk.node_level, chunk.node_mask)
    args = (net.encoder_weights(), net.num_levels, net.slope)
    fwd = {"shape": list(chunk.x.shape),
           "wrapper_ms": cuda_ms(lambda: decima_node_encoder(*ins, *args), 20),
           "plain_ms": cuda_ms(lambda: decima_node_encoder_ref(*ins, *args),
                               3)} | bound(*encoder_work(chunk, net))
    fwd["ms"], fwd["wrapper_device_ms"], fwd["ms_from"] = kernel_ms(
        lambda: decima_node_encoder(*ins, *args), 20,
        "decima_node_encoder_kernel")
    cases[CHUNK_TIMED] = cases.get(CHUNK_TIMED, {}) | fwd
    for b in bwd.values():
        b["ms"], b["wrapper_device_ms"], b["ms_from"] = kernel_ms(
            b["call"], 10, BWD_KERNELS)
    emit({"phase": "kernel_alone", "kernel": "decima_node_encoder",
          "ms": {n: cases[n]["ms"] for n in (*TIMED, CHUNK_TIMED)},
          "wrapper_device_ms": {n: cases[n]["wrapper_device_ms"]
                                for n in (*TIMED, CHUNK_TIMED)},
          "ms_from": {n: cases[n]["ms_from"] for n in (*TIMED, CHUNK_TIMED)},
          "update_chunk": fwd})
    emit({"phase": "kernel_alone", "kernel": "decima_node_encoder_bwd",
          "kernels": list(BWD_KERNELS),
          "chunks": {n: {k: v for k, v in b.items() if k != "call"}
                     for n, b in bwd.items()}})


# ---------------------------------------------------------------------------
# phase 3: the main path — serving on the card
# ---------------------------------------------------------------------------


def _check_results(results, sched_before, params) -> None:
    n = params.num_executors
    for r, sch in zip(results, sched_before):
        if r.health_mask != 0:
            raise AssertionError(f"session {r.session_id}: health mask "
                                 f"{r.health_mask}")
        if r.decided and r.stage_idx >= 0:
            if not bool(sch[r.stage_idx]):
                raise AssertionError(f"session {r.session_id}: stage "
                                     f"{r.stage_idx} was not schedulable")
            if not 1 <= r.num_exec <= n:
                raise AssertionError(f"session {r.session_id}: num_exec "
                                     f"{r.num_exec}")


class DrainCount:
    """Counts drain iterations (`flat_loop.drain_micro_step` calls) while
    active; restores the function on exit."""

    def __enter__(self):
        from sparksched_tpu_torch.env import flat_loop

        self.n, self._fl = 0, flat_loop
        self._orig = flat_loop.drain_micro_step

        def counted(*a, **k):
            self.n += 1
            return self._orig(*a, **k)

        flat_loop.drain_micro_step = counted
        return self

    def __exit__(self, *exc):
        self._fl.drain_micro_step = self._orig


def phase_serve(params, bank, sched, name: str, knobs, rounds: int,
                device: str = "cuda") -> dict:
    """`rounds` x CAPACITY decisions through `decide_batch` on a store
    built with `knobs` (None: its default, SERVE_KNOBS), then a few
    `decide` and `step` calls; the encoder's launches are counted from 0
    over this phase alone."""
    import numpy as np
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import decima_node_encoder
    from sparksched_tpu_torch.serve import SessionStore

    t_phase = time.perf_counter()
    store = SessionStore(params, bank, sched, capacity=CAPACITY,
                         max_batch=MAX_BATCH, seed=0, knobs=knobs,
                         device=device)
    sids = [store.create() for _ in range(CAPACITY)]
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase

    def sched_rows(batch):
        idx = torch.tensor(batch, device=device)
        return store.store.env.schedulable[idx].reshape(len(batch), -1).cpu()

    decima_node_encoder.launches = 0  # count this phase's launches only
    batch_ms, decisions, restarts = [], 0, 0
    t_serve = time.perf_counter()
    with DrainCount() as drains:
        for _ in range(rounds):
            for g in range(CAPACITY // MAX_BATCH):
                batch = sids[g * MAX_BATCH:(g + 1) * MAX_BATCH]
                before = sched_rows(batch)
                t = time.perf_counter()
                results = store.decide_batch(batch)
                batch_ms.append((time.perf_counter() - t) * 1e3)
                _check_results(results, before, params)
                decisions += sum(r.decided for r in results)
                for i, r in enumerate(results):
                    if r.done:  # a finished episode: its tenant starts anew
                        store.close(r.session_id)
                        sids[g * MAX_BATCH + i] = store.create()
                        restarts += 1
    serve_s = time.perf_counter() - t_serve
    batch_launches = decima_node_encoder.launches
    decide_launches = step_launches = 0
    extra = 0
    for sid in sids[:4]:
        before = sched_rows([sid])
        n0 = decima_node_encoder.launches
        _check_results([store.decide(sid)], before, params)
        n1 = decima_node_encoder.launches
        before = sched_rows([sid])
        stage = int(torch.argmax(before[0].int())) if bool(before[0].any()) else -1
        _check_results([store.step(sid, stage, 2)], before, params)
        decide_launches += n1 - n0
        step_launches += decima_node_encoder.launches - n1
        extra += 1
    launches = decima_node_encoder.launches
    if device == "cuda" and launches <= 0:
        raise AssertionError("the serve path launched no decima_node_encoder")
    if decisions < rounds * CAPACITY * 0.9:
        raise AssertionError(f"only {decisions} decisions were served")
    ms = np.array(batch_ms)
    out = {
        "phase": name, "knobs": store.knobs, "capacity": CAPACITY,
        "max_batch": MAX_BATCH, "rounds": rounds,
        "decide_batch_calls": len(batch_ms), "decisions": decisions,
        "decide_calls": extra, "step_calls": extra,
        "episode_restarts": restarts, "setup_s": setup_s,
        "decisions_per_s": decisions / serve_s,
        "decide_batch_ms_p50": float(np.percentile(ms, 50)),
        "decide_batch_ms_p99": float(np.percentile(ms, 99)),
        "drain_iters_per_decide_batch": drains.n / len(batch_ms),
        "encoder_launches": launches,
        "encoder_launches_per_decide_batch": batch_launches / len(batch_ms),
        "encoder_launches_per_decide": decide_launches / extra,
        "encoder_launches_per_step": step_launches / extra,
        "seconds": time.perf_counter() - t_phase,
        "card": card_line() if device == "cuda" else "cpu",
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 3b: serving as the config deploys it (the paged, grouped store,
# the three fronts under open-loop load) and the HTTP front
# ---------------------------------------------------------------------------

# the config's documented `serve:` block (commented in
# config/decima_tpch.yaml): capacity 64, max_batch 8, hot_capacity 32
# (half the sessions paged to host RAM), 2 slot groups, pager-aware
# admission; the front knobs per run below
SERVE_BLOCK = {"capacity": CAPACITY, "max_batch": MAX_BATCH,
               "hot_capacity": 32, "groups": 2, "pager_aware": True,
               "deterministic": True, "donate": True, "seed": 0}
SERVE_FRONTS = {
    "continuous": {"front": "continuous", "metrics": True, "trace": True},
    "pipelined": {"front": "pipelined", "depth": 2, "prefetch": True},
    "linger": {"front": "linger", "linger_ms": 2},
}
# open-loop load: 64 tenants, Poisson arrivals at 40 requests/s (about
# 45% of the synchronous decide_batch's 88.75 decisions/s on the card),
# 480 requests per front
LOAD_TENANTS, LOAD_RPS, LOAD_REQUESTS = 64, 40.0, 480
REPLAY_ROUNDS = 2  # closed-loop replay: rounds over the 64 sessions
HTTP_SESSIONS, HTTP_DECISIONS = 8, 16


def _check_no_plain_and_launched(name: str, launches: int, plain: int,
                                 device: str) -> None:
    if device != "cuda":  # a CPU rehearsal runs the plain version
        return
    if plain:
        raise AssertionError(f"{name}: {plain} plain encoder calls")
    if launches <= 0:
        raise AssertionError(f"{name}: no decima_node_encoder launch")


def bulk_plain_calls() -> int:
    from sparksched_tpu_torch.kernels.bulk_events import bulk_events_fused

    return bulk_events_fused.plain_calls


def _check_bulk(name: str, launches: dict, plain0: int, device: str) -> None:
    """On the card the path ran the fused bulk pass as its kernel: at
    least one launch, and no plain call since `plain0`."""
    if device != "cuda":  # a CPU rehearsal runs the plain version
        return
    plain = bulk_plain_calls() - plain0
    if plain or launches.get("bulk_events_fused", 0) <= 0:
        raise AssertionError(f"{name}: {launches.get('bulk_events_fused')} "
                             f"bulk_events_fused launches, {plain} plain "
                             "calls")


def _slot_bytes(ls, lane: int) -> list:
    from sparksched_tpu_torch.env.flat_loop import leaves

    return [(n, str(v.dtype), v[lane].cpu().numpy().tobytes())
            for n, v in leaves(ls)]


def _page_round_trip(store) -> dict:
    """Page a hot session out and back in on the card, once through the
    pinned host copy (drained first) and once device-side (paged back in
    before the drain): the slot must come back bit for bit on every
    leaf."""
    out = {}
    for how in ("host", "device"):
        sid = next(s for s in range(store.capacity) if store.is_hot(s))
        slot = int(store._slot_of[sid])
        g, local = divmod(slot, store.group_slots)
        before = _slot_bytes(store._stores[g], local)
        store._page_out(slot)
        store._free_slots[g].append(slot)
        if how == "host":
            store._drain_writebacks(wait=True)
            if store._cold[sid].dev is not None:
                raise AssertionError("page-out kept its device copy")
        [back] = store._ensure_hot([sid])
        g, local = divmod(back, store.group_slots)
        if _slot_bytes(store._stores[g], local) != before:
            raise AssertionError(f"page round trip ({how}) changed "
                                 f"session {sid}")
        out[how] = {"session": sid, "leaves": len(before),
                    "bytes": sum(len(b) for _, _, b in before)}
    return out


def _replay_batches(store) -> list:
    """The fixed admission sequence of the replays: REPLAY_ROUNDS rounds
    over every group's sessions in chunks of max_batch, the groups
    taking turns (so consecutive batches live in different groups)."""
    chunks = []
    for g in range(store.groups):
        sids = [s for s in range(store.capacity)
                if store.session_group(s) == g]
        chunks.append([sids[i:i + store.max_batch]
                       for i in range(0, len(sids), store.max_batch)])
    one = [b for turn in zip(*chunks) for b in turn]
    return one * REPLAY_ROUNDS


def phase_serve_front(params, bank, sched, device: str = "cuda") -> dict:
    """The `serve:` block's stores built by `store_from_config`, each
    driven by `run_open_loop` through one front (continuous with metrics
    and tracing, pipelined at depth 2 with prefetch, linger at 2 ms);
    then the checks: every request resolved and reconciled, health 0,
    the kernel launched and no plain version called, the page round
    trip bit-exact, and the closed-loop replays (paged grouped against
    unpaged one-group; pipelined against synchronous) bit-equal."""
    import numpy as np
    import torch

    from sparksched_tpu_torch.env.flat_loop import take_slot
    from sparksched_tpu_torch.env.observe import observe
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_ref,
    )
    from sparksched_tpu_torch.obs.metrics import hist_summary
    from sparksched_tpu_torch.schedulers.decima import compact_features
    from sparksched_tpu_torch.serve import (
        SessionStore,
        front_from_config,
        generate_arrivals,
        run_open_loop,
        store_from_config,
    )

    t_phase = time.perf_counter()
    arrivals = generate_arrivals(LOAD_RPS, LOAD_REQUESTS, LOAD_TENANTS,
                                 seed=SEED)
    stores, runs = {}, {}
    for name, knobs in SERVE_FRONTS.items():
        cfg = SERVE_BLOCK | knobs
        stores[name] = store_from_config(cfg, params, bank, sched,
                                         device=device)
        # the front takes the store's registry and the trace switch as
        # overrides (`front_from_config` reads neither from the block)
        stores[name]._front = front_from_config(
            cfg, stores[name], metrics=stores[name].metrics,
            trace=bool(cfg.get("trace")))
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    decima_node_encoder.launches = 0  # this path's launches only
    zero_engine_launches()
    bulk0 = bulk_plain_calls()
    with PlainCalls() as plain, BulkCapture("serve"), \
            PrngDraws("serve_front"), CallLaunches(stores.values()) as calls:
        for name, store in stores.items():
            t = time.perf_counter()
            runs[name] = run_open_loop(store, store._front, arrivals,
                                       session_seed=20_000)
            runs[name]["seconds"] = time.perf_counter() - t
    launches = decima_node_encoder.launches
    engine_n = engine_launches()
    _check_no_plain_and_launched("serve_front", launches, plain.n, device)
    _check_bulk("serve_front", engine_n, bulk0, device)
    key_chain = calls.summary()
    if not key_chain["batch"]["calls"] or key_chain["batch"]["max"] > 2:
        raise AssertionError(f"serve_front: a greedy decide_batch launched "
                             f"threefry2x32 more than twice: {key_chain}")
    rows = {}
    for name, out in runs.items():
        st = stores[name]
        if not (out["requests"] == LOAD_REQUESTS
                == out["completed"] + out["capacity_rejections"]
                and out["errors"] == 0):
            raise AssertionError(f"serve_front {name}: requests do not "
                                 f"reconcile: {out['reconcile']}")
        if st.stats["serve_quarantines"]:
            raise AssertionError(f"serve_front {name}: "
                                 f"{st.stats['serve_quarantines']} "
                                 "quarantines")
        lat = np.array(out["samples_ms"])
        rows[name] = {
            "front": out["front"], "requests": out["requests"],
            "completed": out["completed"],
            "capacity_rejections": out["capacity_rejections"],
            "offered_rps": out["offered_rps"],
            "achieved_rps": out["achieved_rps"],
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "hist": hist_summary(out["hist"]),
            "makespan_s": out["makespan_s"],
            "session_rotations": out["session_rotations"],
            "page_ins": st.stats["serve_page_ins"],
            "page_outs": st.stats["serve_page_outs"],
            "prefetches": st.stats["serve_prefetches"],
            "batch_calls": st.stats["serve_batch_calls"],
            "decisions": st.stats["serve_decisions"],
            "inflight_peak": st.stats["serve_inflight_peak"],
            "wall_split": dict(st.wall_split),
            "seconds": out["seconds"],
        }
    cont = stores["continuous"]
    rows["continuous"]["metrics_counters"] = dict(cont.metrics.counters)
    crit = stores["continuous"]._front.critpath
    rows["continuous"]["critpath"] = crit.snapshot() if crit else None
    # the kernel against its plain version on this path's inputs: the
    # first MAX_BATCH hot slots of the continuous run's group 0
    st0 = cont._stores[0]
    lanes = take_slot(st0, torch.arange(MAX_BATCH, device=st0.mode.device))
    f_full = sched.features(observe(params, lanes.env))
    f_k, _ = compact_features(f_full, sched.job_bucket)
    net = sched.net
    errs = {}
    for nm, f in (("compact", f_k), ("full", f_full)):
        ins = (f.x, f.adj, f.node_level, f.node_mask)
        args = (net.encoder_weights(), net.num_levels, net.slope)
        out = decima_node_encoder(*ins, *args)
        ref = decima_node_encoder_ref(*ins, *args)
        errs[nm] = {"shape": list(f.x.shape),
                    "max_abs_err": float((out - ref).abs().max())}
        if not errs[nm]["max_abs_err"] <= TOL:
            raise AssertionError(f"serve_front kernel vs plain ({nm}): "
                                 f"{errs[nm]}")
    # closed-loop replays of one fixed admission sequence
    paged = store_from_config(SERVE_BLOCK, params, bank, sched,
                              device=device)
    pipe = store_from_config(SERVE_BLOCK, params, bank, sched,
                             device=device)
    flat = SessionStore(params, bank, sched, capacity=CAPACITY,
                        max_batch=MAX_BATCH, seed=0, device=device)
    for st in (paged, pipe, flat):
        sids = [st.create(seed=30_000 + i) for i in range(CAPACITY)]
        if sids != list(range(CAPACITY)):
            raise AssertionError("replay stores numbered sessions apart")
    round_trip = _page_round_trip(paged)
    flat._calls = pipe._calls = paged._calls
    batches = _replay_batches(paged)
    got = [r.to_dict() for b in batches for r in paged.decide_batch(b)]
    want = [r.to_dict() for b in batches for r in flat.decide_batch(b)]
    if got != want:
        raise AssertionError("replay: the paged grouped store's decisions "
                             "differ from the unpaged one-group store's")
    piped = []
    for i in range(0, len(batches), pipe.groups):  # one batch per group
        for b in batches[i:i + pipe.groups]:
            pipe.dispatch_batch(b)
        for call in pipe.harvest(wait=True):
            piped += [r.to_dict() for r in call.results]
    if piped != got:
        raise AssertionError("replay: the pipelined window's decisions "
                             "differ from the synchronous store's")
    for st in (paged, pipe, flat):
        if st.stats["serve_quarantines"]:
            raise AssertionError("replay: a session was quarantined")
    out = {"phase": "serve_front", "block": SERVE_BLOCK,
           "fronts": SERVE_FRONTS, "tenants": LOAD_TENANTS,
           "offered_rps": LOAD_RPS, "requests_per_front": LOAD_REQUESTS,
           "runs": rows, "encoder_launches": launches,
           "engine_launches": engine_n,
           "threefry_per_served_call": key_chain,
           "plain_encoder_calls": plain.n, "kernel_vs_plain": errs,
           "tolerance": TOL, "page_round_trip": round_trip,
           "replay": {"batches": len(batches), "decisions": len(got),
                      "paged_grouped_eq_unpaged": True,
                      "pipelined_eq_synchronous": True,
                      "decided": sum(d["decided"] for d in got),
                      "paged_page_ins": paged.stats["serve_page_ins"],
                      "pipe_inflight_peak":
                          pipe.stats["serve_inflight_peak"]},
           "hot_set_advice": (paged.hot_set_advice(candidates=(32, 64, 1024))
                              if device == "cuda" else None),
           "setup_s": setup_s, "seconds": time.perf_counter() - t_phase,
           "card": card_line() if device == "cuda" else "cpu"}
    emit(out)
    return {"decima_node_encoder": launches, **engine_n,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values())}


def phase_serve_http(params, bank, sched, device: str = "cuda") -> dict:
    """A `ServeServer` on 127.0.0.1 (an ephemeral port) in front of the
    `serve:` block's paged store and continuous front; a `ServeClient`
    creates HTTP_SESSIONS sessions and asks HTTP_DECISIONS decisions of
    each, one request at a time, and every decision must equal an
    in-process twin store's at the same seeds bit for bit; `/healthz`
    and `/metrics` must answer."""
    from sparksched_tpu_torch.kernels.bulk_events import bulk_events_fused
    from sparksched_tpu_torch.kernels.decima_encoder import decima_node_encoder
    from sparksched_tpu_torch.obs.metrics import MetricsRegistry
    from sparksched_tpu_torch.serve import front_from_config, store_from_config
    from sparksched_tpu_torch.serve.server import ServeClient, ServeServer

    t_phase = time.perf_counter()
    cfg = SERVE_BLOCK | {"front": "continuous", "metrics": True}
    store = store_from_config(cfg, params, bank, sched, device=device)
    twin = store_from_config(SERVE_BLOCK, params, bank, sched, device=device)
    server = ServeServer(store, front_from_config(cfg, store,
                                                 metrics=store.metrics),
                         host="127.0.0.1", port=0,
                         metrics=MetricsRegistry()).start()
    try:
        with ServeClient("127.0.0.1", server.port) as client:
            decima_node_encoder.launches = 0  # this path's launches only
            bulk_events_fused.launches = 0
            bulk0 = bulk_plain_calls()
            with PlainCalls() as plain:
                t = time.perf_counter()
                sids = [client.create(seed=40_000 + i, tenant=i)
                        for i in range(HTTP_SESSIONS)]
                wire = []
                for _ in range(HTTP_DECISIONS):
                    for sid in sids:
                        tk = client.submit(sid)
                        client.flush()
                        if tk.error is not None:
                            raise AssertionError(f"serve_http: {tk.error}")
                        wire.append(tk.result.to_dict())
                wire_s = time.perf_counter() - t
            launches = decima_node_encoder.launches
            bulk_n = bulk_events_fused.launches
            _check_no_plain_and_launched("serve_http", launches, plain.n,
                                         device)
            _check_bulk("serve_http", {"bulk_events_fused": bulk_n}, bulk0,
                        device)
            health = client.healthz()
            metrics = client.metrics_text()
            for sid in sids:
                client.close(sid)
    finally:
        server.stop()
    if [twin.create(seed=40_000 + i)
            for i in range(HTTP_SESSIONS)] != sids:
        raise AssertionError("serve_http: session ids differ")
    local = [twin.decide(sid).to_dict()
             for _ in range(HTTP_DECISIONS) for sid in sids]
    bad = next((i for i, (a, b) in enumerate(zip(wire, local))
                if {k: a[k] for k in b} != b), None)
    if bad is not None or len(wire) != len(local):
        raise AssertionError(f"serve_http: decision {bad} differs from "
                             "the in-process store's")
    if not (health.get("ok") and "serve_http_requests" in metrics
            and "serve_requests_total" in metrics):
        raise AssertionError("serve_http: /healthz or /metrics")
    if any(d["health_mask"] for d in wire):
        raise AssertionError("serve_http: a decision tripped health")
    out = {"phase": "serve_http", "sessions": HTTP_SESSIONS,
           "decisions": len(wire), "equal_in_process": True,
           "decided": sum(d["decided"] for d in wire),
           "wire_decisions_per_s": len(wire) / wire_s,
           "healthz": health, "metrics_bytes": len(metrics),
           "encoder_launches": launches, "plain_encoder_calls": plain.n,
           "bulk_events_fused_launches": bulk_n,
           "seconds": time.perf_counter() - t_phase,
           "card": card_line() if device == "cuda" else "cpu"}
    emit(out)
    return {"decima_node_encoder": launches, "bulk_events_fused": bulk_n}


# the online loop: the config's documented `online:` block, over the
# serve: block with the record path and a 32-record device ring (the
# default cadence is then 16); open-loop load from 16 tenants at 40
# requests/s, 960 requests (about 60 decisions a session, so each
# completes one or two 32-decision segments and the learner sees >= 3
# batches of 4)
ONLINE_BLOCK = {"max_trajectories": 64, "max_steps": 32,
                "batch_trajectories": 4, "min_decisions": 2,
                "max_param_lag": 4, "swap_every": 1,
                "probation_decisions": 32, "max_quarantine_rate": 0.5,
                "learner": {"num_epochs": 2, "num_batches": 2}, "seed": 0}
ONLINE_RING = 32
ONLINE_TENANTS, ONLINE_RPS, ONLINE_REQUESTS = 16, 40.0, 960
ONLINE_MIN_UPDATES = 3
ONLINE_REPLAY_ROUNDS = 6  # the ring-vs-per-decision replay's rounds
ONLINE_TOL = {"rtol": 1e-4, "atol": 1e-6}  # tests/test_torch_ppo.py's TOL
TRAJ_FIELDS = ("stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
               "wall_times", "params_version")


def _traj_key(tr) -> tuple:
    return (tr.session_id, float(tr.wall_times[0]))


def _trajs_equal(a: list, b: list) -> str | None:
    """Where two lists of trajectories differ (bit for bit, the records
    included), or None."""
    import dataclasses

    if len(a) != len(b):
        return f"{len(a)} trajectories against {len(b)}"
    for i, (x, y) in enumerate(zip(sorted(a, key=_traj_key),
                                   sorted(b, key=_traj_key))):
        if (x.session_id, x.length, x.done) != (y.session_id, y.length,
                                                y.done):
            return f"trajectory {i}: session/length/done"
        for f in TRAJ_FIELDS:
            if getattr(x, f).tobytes() != getattr(y, f).tobytes():
                return f"trajectory {i}: {f}"
        for f in dataclasses.fields(x.obs):
            xa, ya = getattr(x.obs, f.name), getattr(y.obs, f.name)
            if xa.dtype != ya.dtype or xa.tobytes() != ya.tobytes():
                return f"trajectory {i}: obs.{f.name}"
    return None


def phase_online(params, bank, agent, device: str = "cuda") -> dict:
    """The serve -> learn -> serve loop as the config documents it: a
    record-on ring store built by `store_from_config`, the `online:`
    block by `online_from_config`, `run_open_loop` with `on_poll=
    bus.pump` while the learner runs in the background on its own
    stream. Fails unless >= ONLINE_MIN_UPDATES updates were accepted and
    published, the served versions never go back and each call's
    results share one, every decided result reached the ring and none
    was dropped, both kernels launched and no plain version ran. Then
    one deterministic schedule replayed through a ring store and a
    `ring: 0` per-decision store must give bit-equal trajectories, and
    one learner update on the card must agree with the same update on
    the CPU (`ONLINE_TOL`; the policy heads to Adam's step bound)."""
    import numpy as np
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.online import (
        OnlineLearner,
        TrajectoryBuffer,
        make_learner_trainer,
        online_from_config,
    )
    from sparksched_tpu_torch.serve import (
        front_from_config,
        generate_arrivals,
        run_open_loop,
        store_from_config,
    )

    t_phase = time.perf_counter()
    agent_cfg = {"agent_cls": "DecimaScheduler"} | agent
    cfg = SERVE_BLOCK | {"front": "continuous", "record": True,
                         "ring": ONLINE_RING}
    # its own weights: the bus swaps them in place
    store = store_from_config(cfg, params, bank,
                              make_scheduler(params, agent, device),
                              device=device)
    front = front_from_config(cfg, store)
    buffer, learner, bus = online_from_config(ONLINE_BLOCK, store, agent_cfg)
    warm_s = learner.warmup()
    arrivals = generate_arrivals(ONLINE_RPS, ONLINE_REQUESTS, ONLINE_TENANTS,
                                 seed=SEED)
    # each call's result versions, in order (the continuous front serves
    # every batch through decide_batch)
    calls: list[list[int]] = []
    call_ms: dict[int, list[float]] = {}  # version -> its calls' ms
    decided = [0]
    serve_batch = store.decide_batch

    def logged(sids):
        t = time.perf_counter()
        rs = serve_batch(sids)
        call_ms.setdefault(rs[0].params_version, []).append(
            (time.perf_counter() - t) * 1e3)
        calls.append([r.params_version for r in rs])
        decided[0] += sum(r.decided for r in rs)
        return rs

    store.decide_batch = logged
    ingest_ms: list[float] = []
    ingest = store._ring_ingest

    def timed_ingest(g, snap):
        t = time.perf_counter()
        ingest(g, snap)
        ingest_ms.append((time.perf_counter() - t) * 1e3)

    store._ring_ingest = timed_ingest
    if device == "cuda":
        torch.cuda.synchronize()
    decima_node_encoder.launches = 0  # this path's launches only
    decima_node_encoder_bwd.launches = 0
    zero_engine_launches()
    bulk0 = bulk_plain_calls()
    with PlainCalls() as plain, PrngDraws("online"):
        learner.start_background()
        t = time.perf_counter()
        try:
            run = run_open_loop(store, front, arrivals, session_seed=50_000,
                                on_poll=bus.pump)
        finally:
            learner.stop()
        run_s = time.perf_counter() - t
        t = time.perf_counter()
        store.drain_ring(wait=True)
        drain_s = time.perf_counter() - t
        bus.pump()  # the last publish, if one is pending
    fwd, bwd = decima_node_encoder.launches, decima_node_encoder_bwd.launches
    engine_n = engine_launches()
    if learner.error is not None:
        raise AssertionError(f"online: the learner thread raised "
                             f"{learner.error!r}")
    _check_no_plain_and_launched("online", fwd, plain.n, device)
    _check_bulk("online", engine_n, bulk0, device)
    if device == "cuda" and bwd <= 0:
        raise AssertionError("online: no decima_node_encoder_bwd launch")
    st = store.stats
    accepted = [h for h in learner.history if h["accepted"]]
    if (learner.stats["learner_published"] < ONLINE_MIN_UPDATES
            or len(accepted) < ONLINE_MIN_UPDATES):
        raise AssertionError(
            f"online: {len(accepted)} accepted / "
            f"{learner.stats['learner_published']} published updates "
            f"(< {ONLINE_MIN_UPDATES}); buffer {buffer.stats}")
    if any(len(set(c)) != 1 for c in calls):
        raise AssertionError("online: a call's results carry two versions")
    flat = [v for c in calls for v in c]
    if any(b < a for a, b in zip(flat, flat[1:])) or flat[-1] < 1:
        raise AssertionError(f"online: params_version not monotone or "
                             f"never swapped: {sorted(set(flat))}")
    if st["serve_ring_records"] != decided[0] or st["serve_ring_dropped"]:
        raise AssertionError(
            f"online: ring records {st['serve_ring_records']} / dropped "
            f"{st['serve_ring_dropped']} against {decided[0]} decided")
    if st["serve_quarantines"] or not (
            run["requests"] == run["completed"] + run["capacity_rejections"]
            and run["errors"] == 0):
        raise AssertionError(f"online: quarantines {st['serve_quarantines']}"
                             f" or requests do not reconcile: "
                             f"{run['reconcile']}")
    lat = np.array(run["samples_ms"])

    # the ring path against the per-decision path on one fixed schedule
    replay_sched = make_scheduler(params, agent, device)
    bufs, rstores = [], []
    for ring in (ONLINE_RING, 0):
        buf = TrajectoryBuffer(capacity=10 ** 6, max_steps=32,
                               min_decisions=2)
        rs = store_from_config(SERVE_BLOCK | {"record": True, "ring": ring},
                               params, bank, replay_sched, device=device,
                               collector=buf)
        if [rs.create(seed=60_000 + i)
                for i in range(CAPACITY)] != list(range(CAPACITY)):
            raise AssertionError("online replay: session ids differ")
        bufs.append(buf)
        rstores.append(rs)
    rstores[1]._calls = rstores[0]._calls
    batches = _replay_batches(rstores[0])
    batches = (batches[:len(batches) // REPLAY_ROUNDS]
               * ONLINE_REPLAY_ROUNDS)
    res = []
    for rs in rstores:
        res.append([r.to_dict() for b in batches for r in rs.decide_batch(b)])
        for sid in range(CAPACITY):
            rs.close(sid)
        rs.drain_ring(wait=True)
    if res[0] != res[1]:
        raise AssertionError("online replay: ring and per-decision stores "
                             "decided differently")
    trajs = [b.drain(10 ** 6) for b in bufs]
    diff = _trajs_equal(*trajs)
    if diff is not None or not trajs[0]:
        raise AssertionError(f"online replay: trajectories differ: {diff}")
    replay = {"decisions": len(res[0]), "trajectories": len(trajs[0]),
              "ring_records": rstores[0].stats["serve_ring_records"],
              "ring_drains": rstores[0].stats["serve_ring_drains"],
              "ring_dropped": rstores[0].stats["serve_ring_dropped"],
              "bit_equal": True}

    # one learner update on the card against the CPU's
    ph = parity_helpers()
    w0 = {k: v.detach().cpu() for k, v in replay_sched.params.items()}
    B, T = ONLINE_BLOCK["batch_trajectories"], ONLINE_BLOCK["max_steps"]
    steps = {}
    for dev in (device, "cpu"):
        lr = OnlineLearner(
            make_learner_trainer(agent_cfg, params, B, T,
                                 learner_cfg=ONLINE_BLOCK["learner"],
                                 seed=ONLINE_BLOCK["seed"], device=dev),
            TrajectoryBuffer(), init_params=w0)
        lr.buffer.requeue(sorted(trajs[0], key=_traj_key)[:B])
        info = lr.step()
        if not info or not info["accepted"]:
            raise AssertionError(f"online learner on {dev}: {info}")
        steps[dev] = (info, {k: v.detach().cpu()
                             for k, v in lr.state.params.items()})
    (ci, cp), (hi, hp) = steps[device], steps["cpu"]
    for k in ("policy_loss", "approx_kl_div", "entropy"):
        np.testing.assert_allclose(ci[k], hi[k], err_msg=k, **ONLINE_TOL)
    worst = ph.assert_update_close(
        hp, cp, w0, int(hi["minibatches_applied"]), 3e-4, False)
    step_ms = [h["update_s"] * 1e3 for h in learner.history]
    out = {"phase": "online", "block": cfg, "online": ONLINE_BLOCK,
           "tenants": ONLINE_TENANTS, "offered_rps": ONLINE_RPS,
           "requests": ONLINE_REQUESTS,
           "achieved_rps": run["achieved_rps"],
           "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_p99_ms": float(np.percentile(lat, 99)),
           "run_s": run_s, "calls": len(calls), "decided": decided[0],
           "call_ms_by_version": {v: {"calls": len(m),
                                      "mean": float(np.mean(m))}
                                  for v, m in sorted(call_ms.items())},
           "versions_served": sorted(set(flat)),
           "learner": dict(learner.stats), "bus": dict(bus.stats),
           "buffer": dict(buffer.stats), "learner_warmup_s": warm_s,
           "learner_step_ms": {"mean": float(np.mean(step_ms)),
                               "max": float(np.max(step_ms)),
                               "n": len(step_ms)},
           "history": learner.history,
           "ring": {k: st[k] for k in st if k.startswith("serve_ring")},
           "ring_ingest_ms": {"mean": float(np.mean(ingest_ms)),
                              "max": float(np.max(ingest_ms)),
                              "n": len(ingest_ms)},
           "ring_final_drain_ms": drain_s * 1e3,
           "encoder_launches": fwd, "encoder_bwd_launches": bwd,
           "engine_launches": engine_n,
           "plain_encoder_calls": plain.n, "replay": replay,
           "learner_card_vs_cpu": {
               "stats": {k: (ci[k], hi[k]) for k in
                         ("policy_loss", "approx_kl_div", "entropy")},
               "worst_of_tolerance": worst,
               "minibatches_applied": hi["minibatches_applied"],
               "card_step_ms": ci["update_s"] * 1e3},
           "seconds": time.perf_counter() - t_phase,
           "card": card_line() if device == "cuda" else "cpu"}
    emit(out)
    return {"decima_node_encoder": fwd, "decima_node_encoder_bwd": bwd,
            **engine_n}


# the replica fleet: the serve: block (continuous front, traced) with the
# record path and a 32-record ring in each of 2 replica processes on the
# one card; parity through the router on 8 sessions x 8 decisions;
# open-loop load from 64 tenants at 80 requests/s, 960 requests (a rate
# one in-process store of the block falls behind)
FLEET_REPLICAS = 2
FLEET_BLOCK = SERVE_BLOCK | {"front": "continuous", "metrics": True,
                             "record": True, "ring": ONLINE_RING}
FLEET_PARITY_SESSIONS, FLEET_PARITY_DECISIONS = 8, 8
FLEET_TENANTS, FLEET_RPS, FLEET_REQUESTS = 64, 80.0, 960
FLEET_RTOL = 1e-5  # tests/_torch_parity.py:assert_same_result's
FLEET_INT_FIELDS = ("stage_idx", "job_idx", "num_exec", "decided", "done",
                    "health_mask", "batched", "params_version")
FLEET_FLOAT_FIELDS = ("lgprob", "reward", "dt", "wall_time")


def fleet_builder(weights: dict, device: str):
    """A replica's stack (`ReplicaSpec.builder` "chip_smoke:fleet_builder"):
    the flagship shape on `device` with the parent's weights, given as
    numpy, so every replica and the parent hold the same bits."""
    import torch

    params, bank, agent = flagship(device)
    sched = make_scheduler(params, agent, device, state_dict={
        k: torch.from_numpy(v) for k, v in weights.items()})
    return params, bank, sched


def _fleet_result_diff(want, got) -> float:
    """The largest relative difference of the served floats; raises when
    an integer field differs."""
    for k in FLEET_INT_FIELDS:
        if getattr(want, k) != getattr(got, k):
            raise AssertionError(f"serve_fleet parity: {k} "
                                 f"{getattr(want, k)} != {getattr(got, k)}"
                                 f" ({want.to_dict()} / {got.to_dict()})")
    worst = 0.0
    for k in FLEET_FLOAT_FIELDS:
        a, b = float(getattr(want, k)), float(getattr(got, k))
        err = abs(a - b)
        if err > FLEET_RTOL * abs(a) + 1e-6:
            raise AssertionError(f"serve_fleet parity: {k} {a} vs {b}")
        worst = max(worst, err / max(abs(a), 1e-30))
    return worst


def phase_serve_fleet(params, bank, sched, agent, device: str = "cuda",
                      builder: str = "chip_smoke:fleet_builder") -> dict:
    """The replica fleet on the card: `Router(spec, replicas=2)`, each
    replica rebuilding the `serve:` block's store (record path, ring)
    from `fleet_builder` on the one card. Gates: decisions through the
    router equal to an in-process store's per replica; under open-loop
    load every request reconciled and health 0 with the fleet collector
    and a quarantine-rate SLO monitor scraping on the loop; every
    decided result through the ring to ONE parent buffer with none
    dropped; one learner update on the card accepted and applied on
    both replicas; a seeded quarantine regression firing exactly one
    alert that rolls the fleet back; `/fleet` and the replica-labeled
    `/metrics` over HTTP; after killing replica 1 its sessions raise
    `ReplicaDied` and replica 0 serves on; the forward kernel launched
    in each replica and the backward in the learner, no plain version
    called in any process. `device="cpu"` with a builder of a small
    setup rehearses it on the CPU (the kernel gates then skip)."""
    import urllib.request

    import numpy as np
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.obs.fleet import FleetCollector, render_status
    from sparksched_tpu_torch.obs.hostprof import HostProfiler
    from sparksched_tpu_torch.obs.metrics import MetricsRegistry
    from sparksched_tpu_torch.obs.slo import SLOMonitor, SLOSpec
    from sparksched_tpu_torch.online import (
        OnlineLearner,
        ParamBus,
        TrajectoryBuffer,
        make_learner_trainer,
    )
    from sparksched_tpu_torch.serve import (
        ReplicaDied,
        ReplicaSpec,
        Router,
        generate_arrivals,
        run_open_loop,
        store_from_config,
    )
    from sparksched_tpu_torch.serve.server import ServeServer

    t_phase = time.perf_counter()
    weights = {k: v.detach().cpu().numpy() for k, v in sched.params.items()}
    spec = ReplicaSpec(builder=builder, builder_kwargs={"weights": weights},
                       serve_cfg=FLEET_BLOCK, trace=True, device=device)
    buf = TrajectoryBuffer(capacity=4 * FLEET_TENANTS,
                           max_steps=ONLINE_BLOCK["max_steps"],
                           min_decisions=2)
    decima_node_encoder.launches = 0  # this path's launches only
    decima_node_encoder_bwd.launches = 0
    plain0 = (decima_node_encoder.plain_calls,
              decima_node_encoder_bwd.plain_calls)
    t = time.perf_counter()
    router = Router(spec, replicas=FLEET_REPLICAS, metrics=MetricsRegistry(),
                    collector=buf)
    boot_s = time.perf_counter() - t
    server = None
    try:
        boot = router.replica_info()
        # results the router handed back, to count the decided ones
        results = []
        submit = router.submit

        def counted(gsid):
            tk = submit(gsid)
            results.append(tk)
            return tk

        router.submit = counted

        # parity: one request at a time through the router (a single
        # decide on its replica) against an in-process store of the same
        # block per replica, created in the same order
        refs = [store_from_config(FLEET_BLOCK, params, bank, sched,
                                  device=device)
                for _ in range(FLEET_REPLICAS)]
        sids = [router.create(seed=70_000 + i)
                for i in range(FLEET_PARITY_SESSIONS)]
        lsids = [refs[router.replica_of(s)].create(seed=70_000 + i)
                 for i, s in enumerate(sids)]
        worst = 0.0
        with PlainCalls() as plain:
            for _ in range(FLEET_PARITY_DECISIONS):
                for s, ls in zip(sids, lsids):
                    tk = router.submit(s)
                    router.flush()
                    if tk.error is not None:
                        raise AssertionError(f"serve_fleet parity: {tk.error}")
                    r = router.replica_of(s)
                    if (tk.result.replica, tk.result.session_id) != (r, ls):
                        raise AssertionError("serve_fleet: affinity broken")
                    worst = max(worst, _fleet_result_diff(
                        refs[r].decide(ls), tk.result))
        for s in sids:
            router.close(s)
        parity = {"sessions": len(sids),
                  "decisions": len(sids) * FLEET_PARITY_DECISIONS,
                  "max_rel_float_diff": worst,
                  "sessions_per_replica": [
                      sum(router.replica_of(s) == r for s in sids)
                      for r in range(FLEET_REPLICAS)]}
        del refs
        # the parity's reference stores are not the fleet's path
        parent_fwd_parity = decima_node_encoder.launches
        decima_node_encoder.launches = 0

        # open-loop load, the collector scraping on the loop
        rl_path = os.path.join(TMP_ROOT, "serve_fleet.jsonl")
        from sparksched_tpu_torch.obs.runlog import RunLog

        rl = RunLog(rl_path)
        load_mon = SLOMonitor([SLOSpec("quarantine_rate", "ratio", 0.05)],
                              runlog=rl)
        col = FleetCollector(router, period_s=1.0, runlog=rl, slo=load_mon)
        col.scrape()
        arrivals = generate_arrivals(FLEET_RPS, FLEET_REQUESTS,
                                     FLEET_TENANTS, seed=SEED)
        t = time.perf_counter()
        with PlainCalls() as plain_load:
            run = run_open_loop(router, router, arrivals,
                                session_seed=80_000,
                                on_poll=col.maybe_scrape)
        run_s = time.perf_counter() - t
        status = col.scrape()
        fs = router.fleet_stats()
        if not (run["requests"] == FLEET_REQUESTS
                == run["completed"] + run["capacity_rejections"]
                and run["errors"] == 0):
            raise AssertionError(f"serve_fleet: requests do not reconcile: "
                                 f"{run['reconcile']}")
        if fs["serve_quarantines"] or load_mon.alerts:
            raise AssertionError(f"serve_fleet: {fs['serve_quarantines']} "
                                 f"quarantines, alerts {load_mon.alerts}")
        lat = np.array(run["samples_ms"])
        samples = router.replica_samples()
        per_replica = [s["stats"]["serve_decisions"] for s in samples]
        seg = router.registry()
        seg_ms = {k[len("serve_seg_"):-3]: {
                      "p50": h.quantile(0.5), "p99": h.quantile(0.99),
                      "mean": h.total / max(h.count, 1)}
                  for k, h in sorted(seg.hists.items())
                  if k.startswith("serve_seg_") and h.count}

        # ring -> one learner
        t = time.perf_counter()
        router.ring_pump(force=True)
        pump_ms = (time.perf_counter() - t) * 1e3
        fs = router.fleet_stats()
        decided = sum(1 for tk in results
                      if tk.result is not None and tk.result.decided)
        if fs["serve_ring_records"] != decided or fs["serve_ring_dropped"]:
            raise AssertionError(
                f"serve_fleet: ring records {fs['serve_ring_records']} / "
                f"dropped {fs['serve_ring_dropped']} against {decided} "
                "decided")
        if buf.stats["online_decisions"] != decided:
            raise AssertionError(f"serve_fleet: the buffer took "
                                 f"{buf.stats['online_decisions']} of "
                                 f"{decided} records")
        agent_cfg = {"agent_cls": "DecimaScheduler"} | agent
        B, T = ONLINE_BLOCK["batch_trajectories"], ONLINE_BLOCK["max_steps"]
        bus = ParamBus(router, probation_decisions=10 ** 6,
                       max_quarantine_rate=0.5)
        learner = OnlineLearner(
            make_learner_trainer(agent_cfg, params, B, T,
                                 learner_cfg=ONLINE_BLOCK["learner"],
                                 seed=ONLINE_BLOCK["seed"], device=device),
            buf, bus, max_param_lag=ONLINE_BLOCK["max_param_lag"],
            init_params={k: torch.from_numpy(v) for k, v in weights.items()},
            version0=router.params_version)
        if not learner.ready():
            raise AssertionError(f"serve_fleet: learner not ready: "
                                 f"{buf.stats}")
        with PlainCalls() as plain_learn:
            info = learner.step()
        if not info or not info["accepted"]:
            raise AssertionError(f"serve_fleet: learner update {info}")
        if bus.pump() != {"event": "swap", "version": 1}:
            raise AssertionError("serve_fleet: the update was not swapped")
        sids = [router.create(seed=90_000 + i) for i in range(4)]
        tks = [router.submit(s) for s in sids]
        router.flush()
        if ({tk.result.replica for tk in tks} != {0, 1} or any(
                tk.error or tk.result.params_version != 1 for tk in tks)):
            raise AssertionError("serve_fleet: version 1 not served by "
                                 "both replicas")
        learner_out = {k: info[k] for k in ("policy_loss", "approx_kl_div",
                                            "entropy", "update_s")}

        # the fleet plane: a seeded quarantine regression, one alert,
        # a fleet-wide rollback; then /fleet and /metrics over HTTP
        mon = SLOMonitor([SLOSpec("quarantine_rate", "ratio", 0.05)],
                         windows=((60.0, 15.0, 1.0),), cooldown_s=600.0,
                         rollback=router, rollback_on=("quarantine_rate",),
                         runlog=rl)
        plane = FleetCollector(router, period_s=0.0, runlog=rl, slo=mon)
        plane.scrape()
        for s in sids[:2]:  # one session on each replica
            router.poison(s)
        tks = [router.submit(s) for s in sids]
        router.flush()
        if sum(bool(tk.result.health_mask) for tk in tks) != 2:
            raise AssertionError("serve_fleet: poison did not quarantine")
        alerts = plane.scrape()["alerts"]
        alerts += plane.scrape()["alerts"]  # the cooldown holds
        if (len(alerts) != 1 or alerts[0]["action"] != "rollback"
                or alerts[0]["rolled_back_to_version"] != 0
                or router.params_version != 0):
            raise AssertionError(f"serve_fleet: alerts {alerts}")
        tks = [router.submit(s) for s in sids[2:]]
        router.flush()
        if ({tk.result.replica for tk in tks} != {0, 1} or any(
                tk.error or tk.result.params_version != 0 for tk in tks)):
            raise AssertionError("serve_fleet: rollback not fleet-wide")
        for s in sids:
            router.close(s)
        prof = HostProfiler()
        server = ServeServer(router, router, metrics=MetricsRegistry(),
                             collector=plane, hostprof=prof).start()
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/fleet", timeout=60) as r:
            fleet_doc = json.loads(r.read().decode())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            prom = r.read().decode()
        server.stop()
        server = None
        if [row["replica"] for row in fleet_doc["replicas"]] != ["0", "1"]:
            raise AssertionError(f"serve_fleet: /fleet {fleet_doc}")
        if 'replica="0"' not in prom or 'replica="1"' not in prom:
            raise AssertionError("serve_fleet: /metrics has no labels")
        hostprof = prof.tables()
        rl.close()

        # the kernels, counted in each process before the kill
        counts = router.kernel_counts()
        for i, c in enumerate(counts):
            if device == "cuda" and (c["decima_node_encoder"] <= 0
                                     or c["decima_node_encoder_plain"]
                                     or c["bulk_events_fused"] <= 0
                                     or c["bulk_events_fused_plain"]):
                raise AssertionError(f"serve_fleet: replica {i} kernels {c}")
        parent_fwd = decima_node_encoder.launches
        parent_bwd = decima_node_encoder_bwd.launches
        parent_plain = (plain.n + plain_load.n + plain_learn.n
                        + decima_node_encoder.plain_calls - plain0[0]
                        + decima_node_encoder_bwd.plain_calls - plain0[1])
        if device == "cuda" and (parent_plain or parent_bwd <= 0):
            raise AssertionError(f"serve_fleet: parent plain calls "
                                 f"{parent_plain}, backward launches "
                                 f"{parent_bwd}")

        # replica death: its sessions fail, replica 0 serves on
        sids = [router.create(seed=95_000 + i) for i in range(4)]
        victim = router._replicas[1]
        victim.proc.kill()
        victim.proc.join(timeout=30.0)
        deadline = time.monotonic() + 30.0
        while (router.stats["router_replica_deaths"] == 0
               and time.monotonic() < deadline):
            router.poll()
            time.sleep(0.05)
        tks = [router.submit(s) for s in sids]
        router.flush()
        for s, tk in zip(sids, tks):
            if router.replica_of(s) == 1:
                if not isinstance(tk.error, ReplicaDied):
                    raise AssertionError(f"serve_fleet: {tk.error!r} after "
                                         "the kill")
            elif tk.error is not None or tk.result.replica != 0:
                raise AssertionError(f"serve_fleet: survivor {tk.error!r}")
        for s in sids:
            router.close(s)
        death = {"deaths": router.stats["router_replica_deaths"],
                 "sessions_failed": router.stats["router_sessions_failed"],
                 "placement_after": sorted({router.replica_of(
                     router.create(seed=96_000 + i)) for i in range(2)})}
        if death["placement_after"] != [0]:
            raise AssertionError(f"serve_fleet: placement {death}")
    finally:
        if server is not None:
            server.stop()
        router.stop()
    if any(r.proc.is_alive() for r in router._replicas):
        raise AssertionError("serve_fleet: a replica outlived stop()")
    fwd = sum(c["decima_node_encoder"] for c in counts) + parent_fwd
    out = {"phase": "serve_fleet", "block": FLEET_BLOCK,
           "replicas": FLEET_REPLICAS, "boot_s": boot_s, "boot": boot,
           "parity": parity, "tenants": FLEET_TENANTS,
           "offered_rps": FLEET_RPS, "requests": FLEET_REQUESTS,
           "achieved_rps": run["achieved_rps"],
           "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_p99_ms": float(np.percentile(lat, 99)),
           "completed": run["completed"],
           "capacity_rejections": run["capacity_rejections"],
           "session_rotations": run["session_rotations"], "run_s": run_s,
           "decisions_per_replica": per_replica,
           "replica_segments_ms": seg_ms,
           "scoreboard": render_status(status).splitlines(),
           "collector": dict(col.stats),
           "ring": {"records": fs["serve_ring_records"],
                    "drains": fs["serve_ring_drains"],
                    "dropped": fs["serve_ring_dropped"],
                    "decided": decided, "force_pump_ms": pump_ms,
                    "buffer": dict(buf.stats)},
           "learner": learner_out, "alerts": alerts,
           "fleet_rows": [row["replica"] for row in fleet_doc["replicas"]],
           "hostprof": {role: {"samples": t["samples"], "share": t["share"],
                               "top": [x["site"] for x in t["top"][:3]]}
                        for role, t in hostprof["roles"].items()},
           "death": death, "kernel_counts_by_replica": counts,
           "parent_launches": {"decima_node_encoder": parent_fwd,
                               "decima_node_encoder_bwd": parent_bwd,
                               "in_parity_reference": parent_fwd_parity},
           "contexts_time_slice": "2 CUDA contexts on one card take turns; "
                                  "they do not run kernels concurrently",
           "seconds": time.perf_counter() - t_phase,
           "card": card_line() if device == "cuda" else "cpu"}
    emit(out)
    return {"decima_node_encoder": fwd,
            "decima_node_encoder_bwd": parent_bwd,
            "bulk_events_fused": sum(c["bulk_events_fused"] for c in counts)}


# ---------------------------------------------------------------------------
# phase 4: the card against the CPU port
# ---------------------------------------------------------------------------


def phase_parity(agent, sched_cuda) -> None:
    """The card's decisions against the CPU port's at SERVE_KNOBS on the
    same sessions: integer fields equal, floats within TOL."""
    import numpy as np

    from sparksched_tpu_torch.serve import SERVE_KNOBS, SessionStore

    t_phase = time.perf_counter()
    results = {}
    for dev in ("cuda", "cpu"):
        params, bank, _ = flagship(dev)
        sched = make_scheduler(params, agent, dev, sched_cuda.params)
        store = SessionStore(params, bank, sched, capacity=PARITY_SESSIONS,
                             max_batch=PARITY_SESSIONS, seed=3, device=dev)
        sids = [store.create(seed=100 + i) for i in range(PARITY_SESSIONS)]
        results[dev] = [r for _ in range(PARITY_DECISIONS)
                        for r in store.decide_batch(sids)]
    worst = 0.0
    for i, (a, b) in enumerate(zip(results["cuda"], results["cpu"])):
        for k in ("stage_idx", "job_idx", "num_exec", "decided", "done",
                  "health_mask"):
            if getattr(a, k) != getattr(b, k):
                raise AssertionError(f"card vs CPU: decision {i}: first "
                                     f"diverging field {k}: "
                                     f"{a.to_dict()} vs {b.to_dict()}")
        for k in ("lgprob", "reward", "dt", "wall_time"):
            x, y = getattr(a, k), getattr(b, k)
            if not np.isclose(x, y, rtol=TOL, atol=TOL):
                raise AssertionError(f"card vs CPU: decision {i}: first "
                                     f"diverging field {k}: {x} vs {y}")
            worst = max(worst, abs(x - y) / max(abs(y), 1.0))
    emit({"phase": "card_vs_cpu", "knobs": SERVE_KNOBS,
          "sessions": PARITY_SESSIONS, "decisions": len(results["cpu"]),
          "tolerance": TOL, "worst_rel_err": worst,
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# phase 5: whole fair-policy episodes through run_flat
# ---------------------------------------------------------------------------


def run_flat_fair(params, bank, lanes: int, device: str, lane_ids=None):
    """`run_flat` under the fair policy at the serve engine's knobs (bulk
    fulfillment on), auto-reset, FLAT_GROUPS groups, from `lanes` seeded
    resets; `lane_ids` runs only those lanes. Returns (final LoopState,
    seconds)."""
    import torch

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.env import core, flat_loop
    from sparksched_tpu_torch.schedulers import round_robin_policy
    from sparksched_tpu_torch.serve import SERVE_KNOBS

    keys = prng.split(prng.PRNGKey(SEED, device), 2)
    reset_keys = prng.split(keys[0], lanes)
    run_keys = prng.split(keys[1], lanes)
    if lane_ids is not None:
        reset_keys, run_keys = reset_keys[lane_ids], run_keys[lane_ids]

    def fair(rng, obs):
        si, ne = round_robin_policy(obs, params.num_executors, True)
        return si, ne, {}

    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    ls = flat_loop.run_flat(
        params, bank, fair, run_keys, FLAT_GROUPS,
        core.reset(params, bank, reset_keys), auto_reset=True,
        **(SERVE_KNOBS | {"fulfill_bulk": True}),
    )
    if device == "cuda":
        torch.cuda.synchronize()
    return ls, time.perf_counter() - t


def phase_run_flat() -> None:
    import torch

    from sparksched_tpu_torch.config import load
    from sparksched_tpu_torch.env import flat_loop
    from sparksched_tpu_torch.env.health import state_health

    cfg = load(CONFIG)
    lanes = (int(cfg["trainer"]["num_sequences"])
             * int(cfg["trainer"]["num_rollouts"]))
    params, bank, _ = flagship("cuda")
    ls, secs = run_flat_fair(params, bank, lanes, "cuda")
    hm = state_health(ls.env)
    if bool((hm != 0).any()):
        raise AssertionError(f"run_flat: health masks {hm.tolist()}")
    env = ls.env
    done = env.job_arrived & torch.isfinite(env.job_t_completed)
    dur = (env.job_t_completed - env.job_arrival_time)[done]
    micro = lanes * FLAT_GROUPS
    out = {
        "phase": "run_flat_fair", "lanes": lanes, "groups": FLAT_GROUPS,
        "micro_steps": micro, "seconds": secs,
        "micro_steps_per_s": micro / secs,
        "decisions": int(ls.decisions.sum()),
        "decisions_per_s": int(ls.decisions.sum()) / secs,
        "bulked_events": int(ls.bulked.sum()),
        "completed_episodes": int(ls.episodes.sum()),
        "completed_jobs": int(done.sum()),
        "avg_job_duration_completed_ms":
            float(dur.mean()) if dur.numel() else None,
        "health_masks_zero": True,
    }
    # the same lanes on the CPU port: every LoopState leaf
    ids = torch.arange(FLAT_CPU_LANES)
    cparams, cbank, _ = flagship("cpu")
    cls, csecs = run_flat_fair(cparams, cbank, lanes, "cpu", ids)
    for (name, a), (_, b) in zip(flat_loop.leaves(ls), flat_loop.leaves(cls)):
        a = a[ids.to(a.device)].cpu()
        if a.dtype.is_floating_point:
            same = (torch.equal(torch.isinf(a), torch.isinf(b))
                    and torch.equal(a[torch.isinf(a)], b[torch.isinf(b)])
                    and torch.allclose(a[torch.isfinite(a)],
                                       b[torch.isfinite(b)],
                                       rtol=FLAT_RTOL, atol=0))
        else:
            same = torch.equal(a, b)
        if not same:
            raise AssertionError(f"run_flat card vs CPU: first diverging "
                                 f"leaf {name}")
    out.update({"card_vs_cpu_lanes": FLAT_CPU_LANES, "cpu_seconds": csecs,
                "card_vs_cpu_rtol": FLAT_RTOL, "card_vs_cpu": "equal",
                "card": card_line()})
    emit(out)


# ---------------------------------------------------------------------------
# phase 6: the backward kernel against its plain version
# ---------------------------------------------------------------------------


def bwd_err(got, ref) -> tuple[float, float]:
    """(worst max abs error, worst error over its tolerance) over the
    gradient tensors; the tolerance is BWD_RTOL * max|ref| + BWD_ATOL."""
    errs = [(float((a.double() - b).abs().max()),
             BWD_RTOL * float(b.abs().max()) + BWD_ATOL)
            for a, b in zip(got, ref)]
    return max(e for e, _ in errs), max(e / t for e, t in errs)


def bwd_work(f, net) -> tuple[int, int]:
    """(bytes, flops) the NodeEncoder backward must move and do for these
    inputs. Bytes: each input read once (x, adj, levels, node mask, the
    per-lane edgeless flag, the packed weights, dL/dh), the gradient
    written once. Flops: what this data needs, counted on the kernel's
    algorithm, node_mask-valid rows only: per job with a valid node, prep
    forward and backward (no input gradient at its first layer) over its
    valid nodes; on an edged lane also update and msg forward and
    backward over the valid nodes (h0 and its messages) and over each node
    updated at its level (h_fin and its message), plus D per edge of an
    updated node, twice (aggregation, scatter). Biases and activations are
    not counted, which only lowers the bound."""
    b, k, s, _ = f.x.shape
    d = net.embed_dim
    w = net.encoder_weights()
    nbytes = (f.x.numel() * 4 + f.adj.numel() + f.node_level.numel() * 4
              + f.node_mask.numel() + b + w.packed.numel() * 4
              + b * k * s * d * 4 + w.packed.numel() * 4)
    nl = min(net.num_levels, s) if net.num_levels else s
    edged = f.adj.reshape(b, -1).any(1)[:, None, None]
    has_child = f.adj.any(-1)
    upd = has_child & (f.node_level < nl) & edged
    upd &= f.node_mask.any(-1, keepdim=True)
    valid = int(f.node_mask.sum())
    valid_edged = int((f.node_mask & edged).sum())
    n_upd = int(upd.sum())
    edges = int((f.adj & upd[..., None]).sum())
    prep = _mlp_flops(w.prep)
    first = 2 * int(w.prep[0][0].shape[0]) * int(w.prep[0][0].shape[1])
    um = _mlp_flops(w.update) + _mlp_flops(w.msg)
    flops = (valid * (3 * prep - first) + (valid_edged + n_upd) * 3 * um
             + 2 * edges * d)
    return nbytes, flops


def update_chunk_features(trainer, ro, items: int):
    """The features of the first `items` valid steps of a rollout, as the
    PPO update builds them (full width)."""
    import torch

    from sparksched_tpu_torch.trainers.rollout import stored_to_observation

    bb, tt = torch.nonzero(ro.valid)[:items].unbind(1)
    so = ro.obs.map(lambda a: a[bb, tt])
    return trainer.scheduler.features(stored_to_observation(trainer.bank, so))


def phase_fwd_train(trainer, chunks: dict, cases: dict) -> None:
    """The forward kernel against its plain version at the shapes training
    gives it, with the trained weights: a collection row of the last
    rollout (all lanes at one step) at full width and compacted to
    `job_bucket` as the collector runs it, and the update chunks
    (BWD_CHUNKS and a full UPDATE_CHUNK of valid steps) at full width.
    Held to the plain forward evaluated in float64 within FWD_RTOL *
    max|ref| + FWD_ATOL, the float32 plain version's error against it
    and the kernel's against the float32 plain version reported beside.
    Each case's error goes into `cases`; one over its tolerance fails."""

    from sparksched_tpu_torch.trainers.ppo import UPDATE_CHUNK

    t_phase = time.perf_counter()
    sched, ro = trainer.scheduler, trainer.last_rollout
    net = sched.net
    todo = collection_rows(sched, trainer.bank, ro, sched.job_bucket)
    todo |= chunks
    todo[f"update_chunk_{UPDATE_CHUNK}"] = update_chunk_features(
        trainer, ro, UPDATE_CHUNK)
    out = {}
    for name, f in todo.items():
        out[name] = fwd_vs_ref64(name, f, net)
        cases[name] = cases.get(name, {}) | out[name]
    if "collection_row_compact" not in out:
        raise AssertionError("no collection row fits the job bucket")
    emit({"phase": "kernel_vs_plain_train", "kernel": "decima_node_encoder",
          "tolerance": f"{FWD_RTOL} * max|ref| + {FWD_ATOL}, against the "
                       "float64 plain forward",
          "cases": out, "seconds": time.perf_counter() - t_phase})


def collection_rows(sched, bank, ro, bucket: int) -> dict:
    """The features of two rows of a collection (all lanes at one step):
    the last row with a decision at full width, and the latest row where
    every lane's live jobs fit `bucket`, compacted to it as the collector
    runs the net."""
    import torch

    from sparksched_tpu_torch.schedulers.decima import compact_features
    from sparksched_tpu_torch.trainers.rollout import stored_to_observation

    def row(t):
        so = ro.obs.map(lambda a: a[:, t])
        return sched.features(stored_to_observation(bank, so))

    steps = torch.nonzero(ro.valid.any(0)).reshape(-1).tolist()
    out = {"collection_row_full": row(steps[-1])}
    for t in reversed(steps):
        f = row(t)
        if int(f.job_mask.sum(1).max()) <= bucket:
            out["collection_row_compact"] = compact_features(f, bucket)[0]
            break
    return out


def fwd_vs_ref64(name: str, f, net) -> dict:
    """The forward kernel on features `f` against the plain forward in
    float64, within FWD_RTOL * max|ref| + FWD_ATOL (failing beyond it),
    the float32 plain version's error reported beside."""
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_ref,
    )

    ins = tuple(a.contiguous()
                for a in (f.x, f.adj, f.node_level, f.node_mask))
    args = (net.encoder_weights(), net.num_levels, net.slope)
    with torch.no_grad():
        got = decima_node_encoder(*ins, *args)
        ref32 = decima_node_encoder_ref(*ins, *args)
        ref = parity_helpers().fwd_ref64(*ins, *args)
    tol = FWD_RTOL * float(ref.abs().max()) + FWD_ATOL
    err = float((got.double() - ref).abs().max())
    if not err <= tol:
        raise AssertionError(f"decima_node_encoder {name}: max abs err "
                             f"{err} is {err / tol:.3g}x its tolerance")
    return {"shape": list(f.x.shape), "num_levels": net.num_levels,
            "max_abs_err": err, "err_over_tol": err / tol,
            "max_abs_ref": float(ref.abs().max()),
            "plain32_err_over_tol": float(
                (ref32.double() - ref).abs().max()) / tol,
            "err_vs_plain32": float((got - ref32).abs().max())}


def phase_bwd_kernel(sched, checks: dict, chunks: dict):
    """The backward kernel against the float64 plain backward on the
    stress cases and on update-chunk features, each with a seeded dL/dh:
    held to it with each LeakyReLU derivative on the branch of the
    kernel's float32 forward (`bwd_ref64_pinned`; a float32 evaluation can
    take the other branch where a pre-activation lies within its rounding
    of 0), with the kernel's error against the plain float64 backward on
    its own branches, and the float32 plain backward's (up to
    PLAIN_MAX_ITEMS items), reported beside; on the chunks of BWD_TIMED a
    rerun must give the same bits, and the wrapper and the float32 plain
    version (up to PLAIN_MAX_ITEMS items) are timed. Returns (per timed
    chunk: the call and the numbers, the worst max abs error)."""
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder_bwd,
        decima_node_encoder_bwd_ref,
    )

    t_phase = time.perf_counter()
    net = sched.net
    w = net.encoder_weights()
    d = net.embed_dim
    cases = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    todo = dict(checks)
    for name, f in chunks.items():
        todo[name] = ((f.x, f.adj, f.node_level, f.node_mask), net.num_levels)
    for name, (ins, nl) in todo.items():
        b, k, s, _ = ins[0].shape
        g = torch.randn((b, k, s, d), device="cuda", generator=gen)
        got = decima_node_encoder_bwd(*ins, w, nl, net.slope, g)
        torch.cuda.synchronize()
        ref = parity_helpers().bwd_ref64_pinned(*ins, w, nl, net.slope, g,
                                                lanes=REF_LANES)
        err, ratio = bwd_err(got, ref)
        # the plain backward in float64 with its own branches, and the
        # float32 plain backward against it
        ref_plain = parity_helpers().bwd_ref64(*ins, w, nl, net.slope, g,
                                               lanes=REF_LANES)
        _, ratio_plain = bwd_err(got, ref_plain)
        plain32 = None
        if b <= PLAIN_MAX_ITEMS:
            _, plain32 = bwd_err(
                decima_node_encoder_bwd_ref(*ins, w, nl, net.slope, g),
                ref_plain)
        cases[name] = {"shape": list(ins[0].shape), "num_levels": nl,
                       "max_abs_err": err, "err_over_tol": ratio,
                       "plain64_err_over_tol": ratio_plain,
                       "plain32_err_over_tol": plain32}
        if not ratio <= 1.0:
            raise AssertionError(f"decima_node_encoder_bwd {name}: error "
                                 f"{err} is {ratio:.3g}x its tolerance")
    timed = {}
    for name in BWD_TIMED:
        f = chunks[name]
        ins = (f.x, f.adj, f.node_level, f.node_mask)
        g = torch.randn(tuple(f.x.shape[:3]) + (d,), device="cuda",
                        generator=gen)
        call = functools.partial(decima_node_encoder_bwd, *ins, w,
                                 net.num_levels, net.slope, g)
        a, b = call(), call()  # a rerun gives the same bits
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"decima_node_encoder_bwd {name}: a rerun "
                                 "gave other bits")
        timed[name] = {
            "call": call, "shape": list(f.x.shape), "same_bits": True,
            "scratch_bytes": decima_node_encoder_bwd.scratch_bytes,
            "wrapper_ms": cuda_ms(call, 10),
            "plain_ms": cuda_ms(lambda: decima_node_encoder_bwd_ref(
                *ins, w, net.num_levels, net.slope, g), 3)
            if f.x.shape[0] <= PLAIN_MAX_ITEMS else None,
        } | bound(*bwd_work(f, net))
        cases[name].update({k: v for k, v in timed[name].items()
                            if k != "call"})
    emit({"phase": "bwd_kernel_vs_plain", "kernel": "decima_node_encoder_bwd",
          "tolerance": f"{BWD_RTOL} * max|ref| + {BWD_ATOL}, against the "
                       "float64 plain backward on the kernel's LeakyReLU "
                       "branches",
          "worst_err_over_tol": max(c["err_over_tol"] for c in cases.values()),
          "worst_plain64_err_over_tol": max(
              c["plain64_err_over_tol"] for c in cases.values()),
          "worst_plain32_err_over_tol": max(
              c["plain32_err_over_tol"] for c in cases.values()
              if c["plain32_err_over_tol"] is not None),
          "cases": cases,
          "seconds": time.perf_counter() - t_phase})
    return timed, max(c["max_abs_err"] for c in cases.values())


# ---------------------------------------------------------------------------
# phase 7: the main path — PPO training on the card
# ---------------------------------------------------------------------------


def train_cfg(artifacts_dir: str | None = None, **trainer) -> dict:
    """config/decima_tpch.yaml with `trainer` keys replaced and the
    trainer's artifacts in `artifacts_dir`, by default a new temporary
    directory (below TMP_ROOT when it is set)."""
    from sparksched_tpu_torch.config import load

    cfg = load(CONFIG)
    art = artifacts_dir or tempfile.mkdtemp(prefix="train_", dir=TMP_ROOT)
    cfg["trainer"] = cfg["trainer"] | {"artifacts_dir": art} | trainer
    return cfg


class PlainCalls:
    """Counts calls of the encoder's plain versions (forward and
    backward) while active; restores them on exit."""

    def __enter__(self):
        from sparksched_tpu_torch.kernels import decima_encoder as de

        self.n, self._de = 0, de
        self._orig = (de.decima_node_encoder_ref,
                      de.decima_node_encoder_bwd_ref)

        def counted(fn):
            def wrapper(*a, **k):
                self.n += 1
                return fn(*a, **k)
            return wrapper

        de.decima_node_encoder_ref = counted(self._orig[0])
        de.decima_node_encoder_bwd_ref = counted(self._orig[1])
        return self

    def __exit__(self, *exc):
        de = self._de
        de.decima_node_encoder_ref, de.decima_node_encoder_bwd_ref = self._orig


def engine_wrappers() -> dict:
    """name -> the wrapper of each kernel the engine and the key chain
    launch (its `launches` and `plain_calls` counters): the three PRNG
    kernels and the fused bulk event pass, which draws its own
    uniforms."""
    from sparksched_tpu_torch.kernels import bulk_events, rbg, threefry

    return {"rbg_random_bits": rbg.rbg_random_bits,
            "threefry2x32": threefry.threefry2x32,
            "split_uniform": rbg.split_uniform,
            "bulk_events_fused": bulk_events.bulk_events_fused}


def zero_engine_launches() -> None:
    for fn in engine_wrappers().values():
        fn.launches = 0


def engine_launches() -> dict:
    return {n: fn.launches for n, fn in engine_wrappers().items()}


KEY_TABLES: dict[str, dict] = {}


class PrngDraws:
    """While active: the PRNG calls made on the card -- rbg draws by (key
    batch shape, draw shape, uniform or bits) (`shapes`), threefry2x32
    calls by (key batch shape, key words, counters, mode, path table
    shape or None for the one-hop default) (`tf`), under each such key
    every distinct table with the last varying counter it was called
    with (`tables`), and
    split_uniform calls by (key batch shape, key words, draw shape)
    (`su`), each with its count -- and the plain versions' calls of all
    three wrappers since entry (`plain`). Named, it leaves `tf` and
    `tables` in KEY_TABLES[name] on exit (the `prng` phase checks the
    kernel at every site's table)."""

    def __init__(self, name: str | None = None):
        self.name = name

    def __enter__(self):
        import collections

        from sparksched_tpu_torch import prng
        from sparksched_tpu_torch.kernels import rbg

        self.shapes: collections.Counter = collections.Counter()
        self.tf: collections.Counter = collections.Counter()
        self.tables: dict = {}
        self.su: collections.Counter = collections.Counter()
        self._rbg, self._prng = rbg, prng
        self._orig = (rbg._draw, prng._threefry, prng.split_uniform)
        self._plain0 = sum(f.plain_calls for f in engine_wrappers().values())
        draw0, tf0, su0 = self._orig

        def draw(keys, shape, uniform):
            if keys.device.type == "cuda":
                self.shapes[(tuple(keys.shape[:-1]),
                             tuple(int(d) for d in shape), bool(uniform))] += 1
            return draw0(keys, shape, uniform)

        def tf(keys, n, base=0, mode="pair", paths=None):
            if keys.device.type == "cuda":
                key = (tuple(keys.shape[:-1]), int(keys.shape[-1]), int(n),
                       mode, None if paths is None else tuple(paths.shape))
                self.tf[key] += 1
                ptr = None if paths is None else paths.data_ptr()
                self.tables.setdefault(key, {})[ptr] = (paths, int(base))
            return tf0(keys, n, base, mode, paths)

        def su(keys, shape=()):
            if keys.device.type == "cuda":
                self.su[(tuple(keys.shape[:-1]), int(keys.shape[-1]),
                         tuple(int(d) for d in shape))] += 1
            return su0(keys, shape)

        rbg._draw, prng._threefry, prng.split_uniform = draw, tf, su
        return self

    @property
    def plain(self) -> int:
        return (sum(f.plain_calls for f in engine_wrappers().values())
                - self._plain0)

    def __exit__(self, *exc):
        (self._rbg._draw, self._prng._threefry,
         self._prng.split_uniform) = self._orig
        if self.name:
            KEY_TABLES[self.name] = {"tf": self.tf, "tables": self.tables}


def tf_count() -> int:
    """threefry2x32's launches and plain calls so far (one of the two
    moves, by the keys' device)."""
    from sparksched_tpu_torch.kernels.threefry import threefry2x32

    return threefry2x32.launches + threefry2x32.plain_calls


class CallLaunches:
    """While active: threefry2x32's launches (or plain calls) inside each
    served call of `stores` (their single and batched programs), by kind
    (`single`, `batch`)."""

    def __init__(self, stores):
        self.stores = list(stores)
        self.single: list[int] = []
        self.batch: list[int] = []

    def __enter__(self):
        def counted(fn, into):
            def run(*a, **k):
                n0 = tf_count()
                try:
                    return fn(*a, **k)
                finally:
                    into.append(tf_count() - n0)
            return run

        self._orig = [(st._decide1, st._decidek) for st in self.stores]
        for st in self.stores:
            st._decide1 = counted(st._decide1, self.single)
            st._decidek = counted(st._decidek, self.batch)
        return self

    def __exit__(self, *exc):
        for st, (one, k) in zip(self.stores, self._orig):
            st._decide1, st._decidek = one, k

    def summary(self) -> dict:
        return {kind: {"calls": len(v), "max": max(v, default=0),
                       "mean": sum(v) / max(len(v), 1)}
                for kind, v in (("single", self.single),
                                ("batch", self.batch))}


BULK_CAPTURES: dict[str, list] = {}


class BulkCapture:
    """While active: the inputs of the fused bulk pass's calls 0, 1, 3,
    7, ... on the card (through `flat_loop._bulk_events_fused`, the name
    every caller uses), cloned, the last BULK_KEEP kept in
    BULK_CAPTURES[name]."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import dataclasses

        from sparksched_tpu_torch.env import flat_loop

        self._fl, self._orig = flat_loop, flat_loop._bulk_events_fused
        kept = BULK_CAPTURES.setdefault(self.name, [])
        calls = [0]
        orig = self._orig

        def capture(params, bank, state, enabled, stop_at_limit=False,
                    max_events=8):
            i = calls[0]
            calls[0] += 1
            if state.rng.device.type == "cuda" and i & (i + 1) == 0:
                st = state.replace(**{
                    f.name: getattr(state, f.name).clone()
                    for f in dataclasses.fields(state)})
                kept.append((params, bank, st, enabled.clone(),
                             stop_at_limit, max_events))
                del kept[:-BULK_KEEP]
            return orig(params, bank, state, enabled,
                        stop_at_limit=stop_at_limit, max_events=max_events)

        flat_loop._bulk_events_fused = capture
        return self

    def __exit__(self, *exc):
        self._fl._bulk_events_fused = self._orig


class RowLaunches:
    """While active: threefry2x32's launches between one collection row's
    policy call and the next row's (`deltas`: the row's key chain, which
    the row derives before its policy call, and whatever the row's
    engine launched), within each of `trainer`'s collections."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.deltas: list[int] = []

    def __enter__(self):
        tr, sched = self.trainer, self.trainer.scheduler
        self._orig = (tr._collect, sched.lane_policy)
        last = [None]

        def collect(*a, **k):
            last[0] = None
            return self._orig[0](*a, **k)

        def policy(*a, **k):
            n = tf_count()
            if last[0] is not None:
                self.deltas.append(n - last[0])
            last[0] = n
            return self._orig[1](*a, **k)

        tr._collect, sched.lane_policy = collect, policy
        return self

    def __exit__(self, *exc):
        self.trainer._collect, self.trainer.scheduler.lane_policy = (
            self._orig)


def phase_train() -> dict:
    """The flagship config through `make_trainer(...).train()` on the
    card, TRAIN_ITERS iterations at rollout_steps TRAIN_STEPS, with the
    config's `obs:` block (run log, telemetry, memory) and its checkpoint
    cadences cut to fire within the phase (`checkpointing_freq`
    TRAIN_CKPT_FREQ, `health.checkpoint_every` TRAIN_STATE_EVERY), the
    artifacts in a temporary directory: one line per iteration, the gates
    (`check_train_artifacts` among them), and the launches of both
    encoder kernels and of the three PRNG kernels (the rbg draws under
    the config's `fast_prng: True`, the threefry hash of every split and
    fold_in, the engine's split_uniform) counted from 0 over the training
    run: each must be launched, no plain version called, and the train
    state stamped "rbg"."""
    import math

    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.trainers import make_trainer

    t_phase = time.perf_counter()
    cfg = train_cfg(num_iterations=TRAIN_ITERS, rollout_steps=TRAIN_STEPS,
                    checkpointing_freq=TRAIN_CKPT_FREQ)
    base = train_cfg(cfg["trainer"]["artifacts_dir"])
    cuts = {k: [base["trainer"][k], cfg["trainer"][k]] for k in (
        "num_iterations", "rollout_steps", "checkpointing_freq")}
    cuts["health.checkpoint_every"] = [base["health"]["checkpoint_every"],
                                       TRAIN_STATE_EVERY]
    cfg["health"]["checkpoint_every"] = TRAIN_STATE_EVERY
    trainer = make_trainer(cfg, device="cuda")
    if trainer.prng_impl != "rbg":
        raise AssertionError(f"the flagship trains under {trainer.prng_impl}")
    p0 = {k: v.detach().clone()
          for k, v in trainer.scheduler.net.named_parameters()}
    pre_update = [p0]  # the parameters before each iteration's update
    lines = []

    def report(i, state, stats):
        line = {"phase": "train_iteration", "iteration": i + 1}
        line.update({k: stats[k] for k in (
            "collect_seconds", "rows", "decisions", "update_seconds",
            "minibatches_applied", "kl_stopped", "update_chunks",
            "policy_loss", "entropy", "approx_kl_div", "health_mask",
            "max_memory_allocated", "episode_length", "avg_num_jobs",
            "telemetry_decisions")})
        line["decisions_per_s"] = stats["decisions"] / stats["collect_seconds"]
        lines.append(line)
        pre_update.append({k: v.detach().clone()
                           for k, v in state.params.items()})
        emit(line)

    torch.cuda.reset_peak_memory_stats()
    decima_node_encoder.launches = 0
    decima_node_encoder_bwd.launches = 0
    zero_engine_launches()
    per_row = RowLaunches(trainer)
    with PlainCalls() as plain, PrngDraws("train") as draws, \
            BulkCapture("train"), per_row:
        state = trainer.train(callback=report)
    torch.cuda.synchronize()
    launches = {"decima_node_encoder": decima_node_encoder.launches,
                "decima_node_encoder_bwd": decima_node_encoder_bwd.launches,
                **engine_launches()}
    if plain.n or draws.plain:
        raise AssertionError(f"the plain encoder ran {plain.n} times, the "
                             f"plain PRNG versions {draws.plain} times on "
                             "the card path")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"training launched no {name}")
    if not per_row.deltas or max(per_row.deltas) > 1:
        raise AssertionError(f"a collection row launched threefry2x32 "
                             f"{max(per_row.deltas, default=0)} times "
                             f"(over {len(per_row.deltas)} rows; rbg: 1)")
    for line in lines:
        if line["health_mask"] != 0:
            raise AssertionError(f"health mask {line['health_mask']}")
        if line["telemetry_decisions"] != line["decisions"]:
            raise AssertionError(
                f"telemetry counted {line['telemetry_decisions']} decisions, "
                f"the rollout holds {line['decisions']}")
        for k in ("policy_loss", "entropy", "approx_kl_div"):
            if not math.isfinite(line[k]):
                raise AssertionError(f"{k} = {line[k]}")
    params = dict(trainer.scheduler.net.named_parameters())
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError("a parameter is not finite")
    moved = max(float((v.detach() - p0[k]).abs().max())
                for k, v in params.items())
    if not moved > 0:
        raise AssertionError("training changed no parameter")
    artifacts = check_train_artifacts(trainer, state, pre_update)
    out = {"phase": "train", "iterations": TRAIN_ITERS,
           "rollout_steps": TRAIN_STEPS, "lanes": trainer.num_envs,
           "cuts": cuts, "prng_impl": trainer.prng_impl,
           "kernel_launches": launches, "plain_encoder_calls": plain.n,
           "plain_prng_calls": draws.plain,
           "rbg_draw_shapes": len(draws.shapes),
           "threefry_hash_shapes": len(draws.tf),
           "threefry_per_row": {"rows": len(per_row.deltas),
                                "max": max(per_row.deltas),
                                "min": min(per_row.deltas)},
           "split_uniform_shapes": len(draws.su), "max_param_change": moved,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "artifacts": artifacts,
           "seconds": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    return {"trainer": trainer, "state": state, "launches": launches,
            "rbg_draws": draws.shapes, "tf_draws": draws.tf,
            "su_draws": draws.su, "lines": lines}


def _sha_ok(path: str) -> dict:
    """A train-state generation against its meta file: digest, stamp (the
    flagship's rbg) and iteration."""
    import hashlib

    with open(path + ".meta.json") as fp:
        meta = json.load(fp)
    with open(path, "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()
    if digest != meta["sha256"] or meta["prng_impl"] != "rbg":
        raise AssertionError(f"{path}: digest or prng_impl does not check "
                             f"({meta})")
    return {"iteration": meta["iteration"], "sha256_ok": True}


def check_train_artifacts(trainer, state, pre_update: list) -> dict:
    """What the train phase left in its artifacts directory: the best
    model of the first TRAIN_CKPT_FREQ iterations (`model.msgpack`,
    loaded into a fresh card `DecimaScheduler`, must equal the parameters
    before the best iteration's update, bit for bit) with `state.json`,
    the train state and its previous generation (each digest checks, and
    the newest loads back to the trained state), and a run log holding
    the record kinds the trainer writes on a healthy run."""
    import glob

    import torch

    from sparksched_tpu_torch.schedulers import DecimaScheduler

    art = trainer.artifacts_dir
    ckpt = os.path.join(art, "checkpoints", str(TRAIN_CKPT_FREQ))
    with open(os.path.join(ckpt, "state.json")) as fp:
        best = json.load(fp)
    agent = {k: v for k, v in train_cfg(art)["agent"].items()
             if k != "agent_cls"}
    loaded = DecimaScheduler(trainer.params_env.num_executors,
                             state_dict_path=os.path.join(ckpt,
                                                          "model.msgpack"),
                             device="cuda", **agent)
    want = pre_update[best["iteration"]]
    for k, v in loaded.params.items():
        if not torch.equal(v, want[k]):
            raise AssertionError(f"model.msgpack {k} differs from the "
                                 "best iteration's pre-update parameters")
    ts = os.path.join(art, "train_state.msgpack")
    gens = {os.path.basename(p): _sha_ok(p) for p in (ts, ts + ".1")}
    restored = trainer.load_train_state(ts)
    if restored.iteration != TRAIN_ITERS or not all(
            torch.equal(v, state.params[k])
            for k, v in restored.params.items()):
        raise AssertionError("train_state.msgpack does not load back to the "
                             "trained state")
    logs = glob.glob(os.path.join(art, "runlog", "*.jsonl"))
    kinds = sorted({json.loads(x)["ev"] for p in logs for x in open(p)})
    need = {"run_start", "span", "telemetry", "memory", "scalars", "run_end"}
    if len(logs) != 1 or not need <= set(kinds):
        raise AssertionError(f"run log {logs} holds {kinds}, not {need}")
    return {"best": best, "train_state": gens, "runlog_kinds": kinds,
            "model_equals_pre_update_params": True}


def phase_train_kernels(train: dict) -> dict:
    """A profiled `_update` on the last training iteration's rollout:
    both encoder kernels must be in torch.profiler's records of the
    update, the backward with every kernel of a call (each counted at its
    mean duration; a call's mean is their sum). Returns update-chunk
    features for phase_bwd_kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer, state = train["trainer"], train["state"]
    ro = trainer.last_rollout
    chunks = {f"update_chunk_{n}": update_chunk_features(trainer, ro, n)
              for n in BWD_CHUNKS}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer._update(state, ro)
        torch.cuda.synchronize()
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    out = {}
    main = "decima_node_encoder_bwd_kernel"
    for kernel, names in (("decima_node_encoder",
                           ("decima_node_encoder_kernel",)),
                          ("decima_node_encoder_bwd", BWD_KERNELS)):
        means = {}
        for match in names:
            recs = [t for n, ts in by_name.items() if match in n for t in ts]
            if not recs:
                raise AssertionError(f"torch.profiler recorded no {match} "
                                     "in the update")
            means[match] = (len(recs), sum(recs) / len(recs) / 1e3)
        # one launch of each per call: a call's mean is the sum of means
        out[kernel] = {"records": means.get(main, means[names[0]])[0],
                       "mean_ms": sum(m for _, m in means.values()),
                       "by_kernel_mean_ms": {n: m for n, (_, m)
                                             in means.items()}}
    emit({"phase": "train_update_profile", "rollout_steps": TRAIN_STEPS,
          "decisions": int(ro.valid.sum()), "kernels": out})
    return chunks


def phase_train_parity(parity) -> None:
    """Two lanes of one collection at T = PARITY_STEPS, on the card and on
    the CPU port from the same weights (the port's init x WEIGHT_SCALE)
    and keys, and two `_update`s on it from those weights, one at the
    config's Adam and one at the linear Adam (eps 1e-2, lr 3e-2): actions,
    valid and stage indices equal, log-probs and rewards within rtol
    1e-5, the same minibatches applied. The updated parameters are held
    as `tests/_torch_parity.py:assert_update_close` holds the port to the
    JAX package: at the config's Adam within rtol 1e-4 / atol 1e-6 but
    the policy heads (Adam's step bound: there they step along float32
    noise); at the linear Adam the change of every parameter within rtol
    1e-4 / atol 1e-7 per applied step, the heads' per tensor
    (`heads_per_tensor`: their gradients sum near-cancelling terms over
    every node and executor row, which the card's float32 summation order
    reaches at the 1e-4 level of the tensor's largest change)."""
    import numpy as np
    import torch

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.trainers import make_optimizer, make_trainer

    t_phase = time.perf_counter()
    cfg = train_cfg(num_sequences=1, num_rollouts=PARITY_LANES,
                    rollout_steps=PARITY_STEPS)
    linear_cfg = cfg["trainer"] | {"opt_kwargs": parity.LINEAR_ADAM}
    out, sd, seconds = {}, None, {}
    for dev in ("cuda", "cpu"):
        trainer = make_trainer(cfg, device=dev)
        if sd is None:
            sd = {k: v.cpu() * WEIGHT_SCALE
                  for k, v in trainer.scheduler.params.items()}
        trainer.scheduler.load_params(sd)
        t = time.perf_counter()
        ro, hm = trainer._collect(
            0, prng.PRNGKey(SEED, dev, impl=trainer.prng_impl))
        seconds[f"{dev}_collect"] = time.perf_counter() - t
        updates = {}
        for adam in ("config_adam", "linear_adam"):
            trainer.scheduler.load_params(sd)
            state = trainer.init_state()
            state.rng = prng.PRNGKey(SEED, dev, impl=trainer.prng_impl)
            if adam == "linear_adam":
                state.opt_state = make_optimizer(
                    linear_cfg, list(state.params.values()))
            t = time.perf_counter()
            state, stats = trainer._update(state, ro)
            seconds[f"{dev}_update_{adam}"] = time.perf_counter() - t
            updates[adam] = ({k: v.detach().clone()
                              for k, v in state.params.items()}, stats)
        out[dev] = (ro, hm, updates)
    (rc, hc, uc), (rp, hp, up) = out["cuda"], out["cpu"]
    for k in ("stage_idx", "job_idx", "num_exec_k", "valid"):
        if not torch.equal(getattr(rc, k).cpu(), getattr(rp, k)):
            raise AssertionError(f"train parity: {k} differs")
    for k in ("lgprob", "reward"):
        a, b = getattr(rc, k).cpu().numpy(), getattr(rp, k).numpy()
        if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"train parity: {k} differs by "
                                 f"{np.abs(a - b).max()}")
    worst, applied = {}, {}
    for adam, (pc, stc) in uc.items():
        pp, stp = up[adam]
        if stc["minibatches_applied"] != stp["minibatches_applied"]:
            raise AssertionError(f"train parity ({adam}): minibatches "
                                 "applied differ")
        linear = adam == "linear_adam"
        lr = (parity.LINEAR_ADAM if linear
              else cfg["trainer"]["opt_kwargs"])["lr"]
        applied[adam] = int(stc["minibatches_applied"])
        worst[adam] = parity.assert_update_close(
            {k: v.numpy() for k, v in pp.items()}, pc, sd, applied[adam],
            lr, linear, heads_per_tensor=True)
    emit({"phase": "train_parity", "lanes": PARITY_LANES,
          "rollout_steps": PARITY_STEPS, "decisions": int(rp.valid.sum()),
          "minibatches_applied": applied,
          "health": [int(hc.max()), int(hp.max())],
          "worst_param_err_over_tol": worst, "seconds_by_part": seconds,
          "card_seconds": sum(v for k, v in seconds.items()
                              if k.startswith("cuda")),
          "cpu_seconds": sum(v for k, v in seconds.items()
                             if k.startswith("cpu")),
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# phase 8: training resumed from a train state
# ---------------------------------------------------------------------------


def _first_unequal(a: dict, b: dict, prefix: str = "") -> str | None:
    """The path of the first leaf of two nested dicts of arrays that is
    not bit-equal, or None."""
    import numpy as np

    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            hit = _first_unequal(x, y, f"{prefix}{k}/")
            if hit:
                return hit
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return prefix + k
    return None


def _update_nondeterminism(trainer, state, ro) -> dict:
    """Two `_update`s of one state on one rollout: whether they give the
    same bits, and the ops PyTorch names as lacking a deterministic
    implementation on the card (its warnings under
    `use_deterministic_algorithms(True, warn_only=True)`)."""
    import warnings

    import torch

    snap = state.snapshot()
    outs = []
    for _ in range(2):
        state.restore(snap)
        state, _ = trainer._update(state, ro)
        outs.append({k: v.detach().clone() for k, v in state.params.items()})
    same = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    state.restore(snap)
    ops = set()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer._update(state, ro)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        state.restore(snap)
    for w in caught:
        msg = str(w.message)
        if "deterministic" in msg:
            ops.add(msg.split(" does not have")[0].strip())
    return {"update_rerun_bit_equal": same,
            "nondeterministic_ops": sorted(ops)}


def phase_train_resume() -> dict:
    """RESUME_LANES lanes at rollout_steps RESUME_STEPS on the card: 2
    uninterrupted iterations against 1 iteration, a fresh trainer, and a
    resume from the first run's `train_state.msgpack` for the second.
    Reports whether the parameters and Adam's moments are bit-equal and,
    where not, the first tensor that differs, whether the second
    iteration's collections are equal, and what makes the update differ
    (a rerun of one update, the ops PyTorch names as nondeterministic).
    Held as the card-vs-CPU training check holds the card: parameters
    within rtol 1e-4 / atol 1e-6, the policy heads per tensor
    (`assert_update_close`); Adam's step counts and the schedule's count
    equal. Both encoder kernels and the rbg kernel must be launched on
    this path and no plain version called."""
    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.trainers import make_trainer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="resume_", dir=TMP_ROOT)

    def trainer_at(name: str, iterations: int):
        cfg = train_cfg(os.path.join(root, name), num_sequences=1,
                        num_rollouts=RESUME_LANES,
                        rollout_steps=RESUME_STEPS,
                        num_iterations=iterations)
        return make_trainer(cfg, device="cuda")

    applied = []
    decima_node_encoder.launches = 0
    decima_node_encoder_bwd.launches = 0
    zero_engine_launches()
    with PlainCalls() as plain, PrngDraws() as draws:
        ta = trainer_at("full", 2)
        p0 = {k: v.detach().cpu().clone()
              for k, v in ta.scheduler.params.items()}
        sa = ta.train(callback=lambda i, s, st: applied.append(
            int(st["minibatches_applied"])))
        trainer_at("stopped", 1).train()
        tc = trainer_at("stopped", 1)
        sc = tc.train(resume_from=os.path.join(root, "stopped",
                                               "train_state.msgpack"))
        torch.cuda.synchronize()
    launches = {"decima_node_encoder": decima_node_encoder.launches,
                "decima_node_encoder_bwd": decima_node_encoder_bwd.launches,
                **engine_launches()}
    if plain.n or draws.plain or min(launches.values()) <= 0:
        raise AssertionError(f"resume path: launches {launches}, plain "
                             f"calls {plain.n} + {draws.plain}")
    full, resumed = ta.train_state_tree(sa), tc.train_state_tree(sc)
    first = _first_unequal(full, resumed)
    out = {"phase": "train_resume", "lanes": RESUME_LANES,
           "rollout_steps": RESUME_STEPS, "iterations": 2,
           "bit_equal": first is None, "first_unequal": first,
           "params_bit_equal": _first_unequal(
               full["params"], resumed["params"]) is None,
           "moments_bit_equal": _first_unequal(
               full["opt_state"], resumed["opt_state"]) is None,
           "kernel_launches": launches, "plain_encoder_calls": plain.n}
    runlogs = os.listdir(os.path.join(root, "stopped", "runlog"))
    kinds = {json.loads(x)["ev"] for p in runlogs
             for x in open(os.path.join(root, "stopped", "runlog", p))}
    if "resume" not in kinds:
        raise AssertionError(f"the resumed run log holds {sorted(kinds)}")
    if first is not None:
        ra, rc = ta.last_rollout, tc.last_rollout
        out["collection_equal"] = all(
            torch.equal(getattr(ra, k), getattr(rc, k)) for k in (
                "stage_idx", "num_exec_k", "valid", "lgprob", "reward"))
        out |= _update_nondeterminism(tc, sc, rc)
    if (full["opt_state"]["count"] != resumed["opt_state"]["count"]
            or _first_unequal(full["opt_state"]["step"],
                              resumed["opt_state"]["step"])):
        raise AssertionError("resume: Adam's step counts differ")
    lr = ta.train_cfg["opt_kwargs"]["lr"]
    out["worst_param_err_over_tol"] = parity_helpers().assert_update_close(
        {k: v.detach().cpu().numpy() for k, v in sa.params.items()},
        sc.params, p0,
        sum(applied), lr, linear=False, heads_per_tensor=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# phase 8b: the rbg kernel, the low-precision layouts, fault injection
# ---------------------------------------------------------------------------


def rbg_work(n: int, uniform: bool) -> tuple[int, int]:
    """(bytes, integer operations) of an rbg draw of `n` words: the key
    read once and each output written once (float32 uniforms, or the
    port's int64 words); RBG_OPS_PER_BLOCK per block of 4 words."""
    return 32 + n * (4 if uniform else 8), -(-n // 4) * RBG_OPS_PER_BLOCK


def phase_rbg(draws) -> dict:
    """The rbg kernel against its plain version on the card, then timed.
    Bit-equal: RBG_CHECK_KEYS random single keys (the first three with
    counters that carry across words and wrap) at odd counts, as words
    and as uniforms, and key batches at every draw shape the `train`
    phase made (`draws`: one stream of the batch's first key). Timed at
    the RBG_TIMED most launched shapes of `train` and at the largest: the
    kernel's own device time (torch.profiler's records, `ms`, or CUDA
    events where the profiler delivers no record: `ms_from`) and a whole
    wrapper call (CUDA events over repeated calls, `call_ms`: at these
    sizes the host's launch sets it), the plain version on the card
    (`rbg_bits_ref`, and the uniform mapping), the threefry draw of the
    same shape from 2-word keys (both CUDA events), and the bound (bytes
    over the HBM rate or integer operations over the INT32 rate). No
    PyTorch call computes this stream (torch's Philox takes another key and counter
    layout), so `library_ms` is None."""
    import torch

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.kernels.rbg import (
        bits_to_uniform,
        rbg_bits_ref,
        rbg_random_bits,
        rbg_uniform,
    )

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    keys = torch.randint(0, 2**32, (RBG_CHECK_KEYS, 4), generator=g,
                         dtype=torch.int64)
    keys[:3] = torch.tensor([[1, 2, 0xFFFFFFFF, 0xFFFFFFFF],
                             [0xFFFFFFFF] * 4, [5, 6, 0xFFFFFFFE, 0]])
    keys = keys.cuda()
    bad, words = [], 0
    for i in range(RBG_CHECK_KEYS):
        n = 2 * (i % RBG_MAX_ODD) + 1
        k = keys[i]
        want = rbg_bits_ref(k, n)
        if not (torch.equal(rbg_random_bits(k, (n,)), want)
                and torch.equal(rbg_uniform(k, (n,)),
                                bits_to_uniform(want))):
            bad.append(i)
        words += n
    shapes = sorted(draws, key=lambda d: -draws[d])
    for batch, shape, uniform in shapes:
        kb = keys[:max(1, math.prod(batch))].reshape(batch + (4,))
        got = (rbg_uniform if uniform else rbg_random_bits)(kb, shape)
        want = rbg_bits_ref(kb, got.numel()).reshape(got.shape)
        if not torch.equal(got, bits_to_uniform(want) if uniform else want):
            bad.append((batch, shape, uniform))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"rbg kernel differs from rbg_bits_ref at "
                             f"{bad[:8]} ({len(bad)} cases)")
    timed = shapes[:RBG_TIMED]
    biggest = max(shapes, key=lambda d: math.prod(d[0]) * math.prod(d[1]))
    if biggest not in timed:
        timed.append(biggest)
    at = {}
    for batch, shape, uniform in timed:
        kb = keys[:max(1, math.prod(batch))].reshape(batch + (4,))
        kt = kb[..., :2].contiguous()  # threefry keys of the same batch
        n = math.prod(batch) * math.prod(shape)
        draw = rbg_uniform if uniform else rbg_random_bits
        ms, _, ms_from = kernel_ms(lambda: draw(kb, shape), 50,
                                   "rbg_philox_kernel")
        call_ms = cuda_ms(lambda: draw(kb, shape), 200)
        plain_ms = cuda_ms(lambda: (bits_to_uniform if uniform else
                                    (lambda b: b))(rbg_bits_ref(kb, n)), 50)
        tf_ms = cuda_ms(lambda: (prng.uniform if uniform
                                 else prng.random_bits)(kt, shape), 50)
        nbytes, ops = rbg_work(n, uniform)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        name = (f"{'uniform' if uniform else 'bits'}"
                f"{list(batch)}x{list(shape)}")
        at[name] = {"words": n, "train_launches": draws[(batch, shape,
                                                          uniform)],
                    "ms": ms, "ms_from": ms_from, "call_ms": call_ms,
                    "plain_ms": plain_ms,
                    "threefry_ms": tf_ms,
                    "bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations", "bytes": nbytes, "int_ops": ops}
    out = {"phase": "rbg", "checked_keys": RBG_CHECK_KEYS,
           "checked_words": words, "batch_shapes_checked": len(shapes),
           "max_abs_err": 0, "timed": at,
           "seconds": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    return out


def int_bound(nbytes: int, ops: int) -> dict:
    """The least time for work that moves `nbytes` and does `ops` INT32
    operations: the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def tf_work(keys: int, words: int, n: int, mode: str, paths=None,
            base: int = 0) -> tuple[int, int]:
    """(bytes, integer operations) a threefry2x32 call needs: each root
    read once and each output written once (a pair of int64 words per
    half, an int64 word, or a float32); a hash for each (root, half) and
    each distinct node of the paths' tree (paths that share their first
    hops share those hashes), the last hop at each of its n counters.
    The path table is the kernel's way to the answer, not part of it,
    so its bytes are not counted."""
    from sparksched_tpu_torch.kernels.threefry import PATH_VAR

    out = {"pair": 8 * words, "bits": 8, "uniform": 4}[mode]
    rows = [(PATH_VAR,)] if paths is None else \
        paths.reshape(-1, paths.shape[-1]).tolist()
    nodes = set()
    for row in rows:
        hops = []
        for c in row:
            if c < 0 and c != PATH_VAR:
                break
            hops.append(base if c == PATH_VAR else c)
        nodes.update(tuple(hops[:d]) for d in range(1, len(hops)))
        nodes.update(tuple(hops[:-1]) + (hops[-1] + j,) for j in range(n))
    hashes = keys * len(nodes) * (words // 2)
    return (keys * words * 8 + keys * len(rows) * n * out,
            hashes * TF_OPS_PER_HASH)


def su_work(lanes: int, words: int, n: int) -> tuple[int, int]:
    """(bytes, integer operations) of a split_uniform call: the keys read
    once, the next keys and the uniforms written once; the hashes this
    data needs (each lane's next key; under threefry each lane's second
    key and a hash a word, under rbg the first lane's second key once
    and a Philox block per 4 words)."""
    nbytes = 2 * lanes * words * 8 + lanes * n * 4
    if words == 4:
        ops = ((2 * lanes + 2) * TF_OPS_PER_HASH
               + -(-lanes * n // 4) * RBG_OPS_PER_BLOCK)
    else:
        ops = (2 * lanes + lanes * n) * TF_OPS_PER_HASH
    return nbytes, ops


def random_tables(g, count: int) -> list:
    """`count` random path tables [P, D] (int64, CPU): depths 1 to 3,
    counters anywhere in [0, 2^32) and near its top, PATH_VAR entries,
    rows shorter than the table padded with PATH_END."""
    import torch

    from sparksched_tpu_torch.kernels.threefry import PATH_VAR, path_table

    tables = []
    for i in range(count):
        depth, num = 1 + i % 3, 5 + 7 * i
        rows = []
        for _ in range(num):
            hops = int(torch.randint(1, depth + 1, (), generator=g))
            row = torch.randint(0, 2**32, (hops,), generator=g).tolist()
            for d in range(hops):
                pick = int(torch.randint(0, 4, (), generator=g))
                if pick == 0:
                    row[d] = PATH_VAR
                elif pick == 1:
                    row[d] = 2**32 - 1 - d
            rows.append(tuple(row))
        tables.append(path_table(rows, "cpu"))
    return tables


def phase_prng(train: dict) -> dict:
    """The threefry path kernel (`threefry2x32`) and the engine's
    split-then-draw kernel (`split_uniform`) against their plain versions
    on the card, then timed. Bit-equal, under both impls: threefry2x32
    on PRNG_CHECK_KEYS random roots (non-contiguous views) with the
    one-hop default in every mode at PRNG_COUNTS (bases past 2^32) and
    through PRNG_TABLES random path tables (depths 1 to 3, varying
    counters, counters near 2^32) at 1 and 3 counters; at every (key
    batch, counters, mode, table) that `train`, `serve_front` and
    `online` called (KEY_TABLES: the collector row's table, the lane
    keys', PPO's, a served call's, the one-hop default), with the
    varying counter the path last used and 2^32 - 1; split_uniform at
    every (key batch, draw shape) the five engine sites drew in `train`,
    with threefry and rbg keys. Timed at the PRNG_TIMED most launched
    calls of `train` (rbg keys) and at the most launched with threefry
    keys: the kernel's own device time (`ms`, `ms_from` as in `rbg`), a
    whole wrapper call (`call_ms`, CUDA events), the plain version on
    the card (`plain_ms`) and the bound (bytes over the HBM rate or
    integer operations over the INT32 rate). No PyTorch call computes
    jax's threefry stream, so `library_ms` is None."""
    import torch

    from sparksched_tpu_torch.kernels.rbg import (
        split_uniform,
        split_uniform_ref,
    )
    from sparksched_tpu_torch.kernels.threefry import (
        MODES,
        threefry2x32,
        threefry2x32_keys_ref,
    )

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 1)
    words = torch.randint(0, 2**32, (PRNG_CHECK_KEYS, 2, 4), generator=g,
                          dtype=torch.int64).cuda()
    pool = {4: words[:, 1], 2: words[:, 1, 1:3]}  # row stride 8: views

    def keys(batch: tuple, w: int):
        return pool[w][:max(1, math.prod(batch))].reshape(batch + (w,))

    def modes(w: int):
        return MODES if w == 2 else ("pair",)

    bad, cases = [], 0

    def check(kb, n, base, mode, paths, label):
        nonlocal cases
        cases += 1
        got = threefry2x32(kb, n, base, mode, paths)
        if not torch.equal(got, threefry2x32_keys_ref(kb, n, base, mode,
                                                      paths)):
            bad.append(label)

    for w in (2, 4):
        for mode in modes(w):
            for n, base in PRNG_COUNTS:
                check(pool[w], n, base, mode, None,
                      ("threefry2x32", w, n, base, mode))
            for i, table in enumerate(random_tables(g, PRNG_TABLES)):
                for n in (1, 3):
                    check(pool[w][:512], n, 2**32 - 1 - i, mode, table.cuda(),
                          ("threefry2x32", w, n, mode, "table", i))
    sites = 0
    for path in ("train", "serve_front", "online"):
        tf, tables = KEY_TABLES[path]["tf"], KEY_TABLES[path]["tables"]
        for key in tf:
            batch, w, n, mode, _ = key
            for paths, base in tables[key].values():
                sites += 1
                for kw in ((2, 4) if mode == "pair" else (w,)):
                    for var in (base, 2**32 - 1):
                        check(keys(batch, kw), n, var, mode, paths,
                              ("threefry2x32", path, key, kw, var))
    su_shapes = sorted(train["su_draws"], key=lambda d: -train["su_draws"][d])
    for batch, _, shape in su_shapes:
        for w in (2, 4):
            cases += 1
            kb = keys(batch, w)
            got, want = split_uniform(kb, shape), split_uniform_ref(kb, shape)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                bad.append(("split_uniform", batch, w, shape))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"PRNG kernels differ from their plain versions "
                             f"at {bad[:8]} ({len(bad)} of {cases} cases)")

    def timed(name: str, kernel: str, fn, plain, work, launches) -> dict:
        ms, _, ms_from = kernel_ms(fn, 50, kernel)
        return {"train_launches": launches, "ms": ms, "ms_from": ms_from,
                "call_ms": cuda_ms(fn, 200), "plain_ms": cuda_ms(plain, 50),
                **int_bound(*work)}

    at = {"threefry2x32": {}, "split_uniform": {}}
    tf_train = KEY_TABLES["train"]
    tf_shapes = sorted(tf_train["tf"], key=lambda d: -tf_train["tf"][d])
    for i, key in enumerate(tf_shapes[:PRNG_TIMED]):
        batch, w, n, mode, pshape = key
        paths, base = next(iter(tf_train["tables"][key].values()))
        for kw in ((w, 2) if i == 0 and w != 2 else (w,)):
            kb = keys(batch, kw)
            label = (f"{mode}{list(batch)}x{n}w{kw}"
                     + (f"paths{list(pshape)}" if pshape else ""))
            at["threefry2x32"][label] = timed(
                "threefry2x32", "threefry2x32_kernel",
                lambda: threefry2x32(kb, n, base, mode, paths),
                lambda: threefry2x32_keys_ref(kb, n, base, mode, paths),
                tf_work(max(1, math.prod(batch)), kw, n, mode, paths,
                        base),
                tf_train["tf"][key])
    for i, (batch, w, shape) in enumerate(su_shapes[:PRNG_TIMED]):
        for kw in ((w, 2) if i == 0 and w != 2 else (w,)):
            kb = keys(batch, kw)
            at["split_uniform"][f"{list(batch)}x{list(shape)}w{kw}"] = timed(
                "split_uniform", "split_uniform_kernel",
                lambda: split_uniform(kb, shape),
                lambda: split_uniform_ref(kb, shape),
                su_work(max(1, math.prod(batch)), kw, math.prod(shape)),
                train["su_draws"][(batch, w, shape)])
    out = {"phase": "prng", "checked_keys": PRNG_CHECK_KEYS,
           "cases": cases, "random_tables": PRNG_TABLES,
           "site_tables_checked": sites,
           "split_uniform_shapes_checked": len(su_shapes),
           "max_abs_err": 0, "timed": at,
           "seconds": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    return out


def _bulk_unequal(got, want) -> list[str]:
    """The EnvState fields (and counts) of two fused passes that are not
    bit-equal (floats compared as their bits)."""
    import dataclasses

    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    bad = [f.name for f in dataclasses.fields(got[0])
           if not torch.equal(bits(getattr(got[0], f.name)),
                              bits(getattr(want[0], f.name)))]
    return bad + [n for n, a, b in (("k_rel", got[1], want[1]),
                                    ("k_rdy", got[2], want[2]))
                  if not torch.equal(a, b)]


def bulk_work(bank, st, got, enabled) -> tuple[int, int]:
    """(bytes, integer operations) this pass's data needs: every field
    the pass writes read and written once (whole: the outputs are new
    tensors), the executor, job and lane inputs it reads once, and, for
    each stage a launch or an arrival touched, its `adj` row and four
    per-stage facts; for each launch one bank gather (BULK_BANK_BYTES and
    its `dur` entry). Operations: each lane's scan steps (its events, and
    one more that stops it) of BULK_OPS_PER_EXEC_STEP per executor, and
    the hashes: under threefry two a launch and two a lane (its second
    and next key), under rbg a Philox block a launch and three hashes a
    lane (lane 0's second key, the next key's two halves)."""
    from sparksched_tpu_torch.kernels.bulk_events import OUT_FIELDS

    out, k_rel, k_rdy = got

    def nbytes(t) -> int:
        return t.numel() * t.element_size()

    nb = sum(nbytes(getattr(st, f)) * 2 for f in OUT_FIELDS)
    nb += nbytes(k_rel) + nbytes(k_rdy) + nbytes(enabled)
    nb += sum(nbytes(getattr(st, f)) for f in (
        "time_limit", "job_template", "job_arrival_time", "job_arrival_seq",
        "job_arrived", "exec_dst_job", "exec_dst_stage", "exec_arrive_seq",
        "source_valid", "source_job", "source_stage"))
    touched = int(((out.stage_remaining != st.stage_remaining)
                   | (out.moving_count != st.moving_count)).sum())
    nb += touched * (st.adj.shape[-1] + 1 + 4 + 4 + 4)
    launches = int((out.seq_counter - st.seq_counter).sum())
    nb += launches * (BULK_BANK_BYTES + bank.dur.element_size())
    lanes, n = st.exec_job.shape
    steps = int((k_rel + k_rdy).sum() + enabled.sum())
    ops = steps * n * BULK_OPS_PER_EXEC_STEP
    if st.rng.shape[-1] == 4:
        ops += launches * RBG_OPS_PER_BLOCK + 3 * lanes * TF_OPS_PER_HASH
    else:
        ops += (2 * launches + 2 * lanes) * TF_OPS_PER_HASH
    return nb, ops


def _arena_outputs(st) -> list:
    """The kernel's outputs as views of one buffer (the allocation the
    wrapper could make instead of one `empty_like` a field): for the
    host-cost comparison only."""
    import torch

    from sparksched_tpu_torch.kernels.bulk_events import OUT_FIELDS

    like = [getattr(st, f) for f in OUT_FIELDS] + [st.seq_counter] * 2
    sizes = [-(-t.numel() * t.element_size() // 8) * 8 for t in like]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=st.rng.device)
    return [v.view(t.dtype).view(t.shape)
            for v, t in zip(buf.split(sizes), like)]


@functools.cache
def corner_helpers():
    """`tests/_bulk_corners.py`, loaded by path: the fused pass's corner
    cases, built on the port alone."""
    spec = importlib.util.spec_from_file_location(
        "_bulk_corners", os.path.join(HERE, "tests", "_bulk_corners.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu_pass(got):
    """A pass's (state, k_rel, k_rdy) with every tensor on the CPU."""
    import dataclasses

    st = got[0]
    return (st.replace(**{f.name: getattr(st, f.name).cpu()
                          for f in dataclasses.fields(st)}),
            got[1].cpu(), got[2].cpu())


def bulk_corners() -> dict:
    """Every case of `tests/_bulk_corners.py` at each of its executor
    counts under both impls (the lanes made on the CPU by the port's own
    engine): the kernel on the card against the plain version on the CPU
    copy of the same inputs (the inputs the CPU tests hold the g++ build
    to; CUDA's float32 `amin` may keep either zero of a +0.0 / -0.0 tie,
    the CPU's and the kernel's keep the first), and each case's check
    that it happened. Returns case -> events consumed over its lanes."""
    from sparksched_tpu_torch.env.core import _bulk_events_fused_ref
    from sparksched_tpu_torch.kernels import bulk_events as bk

    cm = corner_helpers()
    out = {}
    for case in cm.CASES:
        for n in cm.EXECUTORS:
            if not cm.applies(case, n):
                continue
            for impl in ("threefry2x32", "rbg"):
                p, b, st, on, stop, check = cm.corner_batch(case, n, impl)
                want = _bulk_events_fused_ref(p, b, st, on,
                                              stop_at_limit=stop,
                                              max_events=8)
                _, db, dst, don = cm.to_device(p, b, st, on, "cuda")
                got = _cpu_pass(bk.bulk_events_fused(p, db, dst, don, stop,
                                                     8))
                name = f"{case}_n{n}_{impl}"
                bad = _bulk_unequal(got, want)
                if bad:
                    raise AssertionError(f"bulk_kernel corner {name}: the "
                                         f"kernel differs at {bad}")
                what = check(got)
                if what is not None:
                    raise AssertionError(f"bulk_kernel corner {name}: "
                                         f"{what}")
                out[name] = int((got[1] + got[2]).sum())
    return out


def _wide_jobs(p, b, st, on, stop, me) -> dict:
    """The timed capture with every job-indexed field twice as long (its
    jobs repeated): the kernel's shared memory then passes 48 KB, the
    launch that raises its cap, held bit-equal to the plain version."""
    import dataclasses

    import torch

    from sparksched_tpu_torch.env.core import _bulk_events_fused_ref
    from sparksched_tpu_torch.kernels import bulk_events as bk

    j_cap = st.stage_remaining.shape[1]
    wide = st.replace(**{
        f.name: torch.cat([getattr(st, f.name)] * 2, 1).contiguous()
        for f in dataclasses.fields(st)
        if getattr(st, f.name).dim() >= 2
        and getattr(st, f.name).shape[1] == j_cap})
    got = bk.bulk_events_fused(p, b, wide, on, stop, me)
    want = _bulk_events_fused_ref(p, b, wide, on, stop_at_limit=stop,
                                  max_events=me)
    bad = _bulk_unequal(got, want)
    if bad:
        raise AssertionError(f"bulk_kernel wide jobs: differs at {bad}")
    return {"jobs": 2 * j_cap, "events": int((got[1] + got[2]).sum()),
            "ms": kernel_ms(lambda: bk.bulk_events_fused(p, b, wide, on,
                                                         stop, me), 20,
                            "bulk_events_fused_kernel")[0]}


def _line_fit(xs, ys) -> tuple[float, float]:
    """(intercept, slope) of the least-squares line through (xs, ys)."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
             if sxx else 0.0)
    return my - slope * mx, slope


def bulk_steps(on, got) -> int:
    """The longest lane's scan steps: its events and, on an enabled lane,
    the step that stopped it."""
    return int((got[1] + got[2] + on.to(got[1].dtype)).max())


def phase_bulk_kernel() -> dict:
    """The fused bulk event kernel (`bulk_events_fused`) against its plain
    version (`core._bulk_events_fused_ref`) on the card, then timed.
    Bit-equal on every EnvState field, k_rel and k_rdy, on the pass's
    inputs captured from the card's paths (BulkCapture): `train` (rbg
    keys, and the same states with their threefry words), `lowprec` (the
    int16 bank, rbg) and `serve_front` (a serving store's gathered
    slots, threefry). Timed on the `train` capture that consumed the most
    events, under both impls: the kernel's own device time (`ms`,
    `ms_from` as in `rbg`), a whole wrapper call (`call_ms`, CUDA
    events), the plain version on the card (`plain_ms`) and the bound
    (`bulk_work` over the HBM rate or the INT32 rate); and the host cost
    of the wrapper's argument packing with its 23 `empty_like` outputs
    against one arena split into views (`host_us`). Then the corner
    cases (`bulk_corners`), every `train` capture's kernel time beside
    its longest lane's scan steps with the least-squares fit ms = fixed
    + per_step x steps per impl (`fit`), a launch on the timed capture
    with `enabled` all False, the copy and the outputs alone
    (`disabled`), and the timed capture with twice its job slots
    (`wide`: past 48 KB of shared memory). No PyTorch call computes this pass, so `library_ms` is
    None."""
    import torch

    from sparksched_tpu_torch.env.core import _bulk_events_fused_ref
    from sparksched_tpu_torch.kernels import bulk_events as bk

    t_phase = time.perf_counter()
    cases = {}
    for name, cap in (("train", "train"), ("lowprec_int16", "lowprec"),
                      ("serve", "serve")):
        if not BULK_CAPTURES.get(cap):
            raise AssertionError(f"bulk_kernel: no capture from {cap}")
        impls = ("rbg", "threefry") if name == "train" else (
            "threefry" if BULK_CAPTURES[cap][0][2].rng.shape[-1] == 2
            else "rbg",)
        for impl in impls:
            rows = []
            for p, b, st, on, stop, me in BULK_CAPTURES[cap]:
                if impl == "threefry" and st.rng.shape[-1] == 4:
                    st = st.replace(rng=st.rng[:, :2].contiguous())
                rows.append((p, b, st, on, stop, me))
            cases[f"{name}_{impl}"] = rows
    checked, top = {}, {}
    for key, rows in cases.items():
        events = 0
        for p, b, st, on, stop, me in rows:
            got = bk.bulk_events_fused(p, b, st, on, stop, me)
            want = _bulk_events_fused_ref(p, b, st, on, stop_at_limit=stop,
                                          max_events=me)
            bad = _bulk_unequal(got, want)
            if bad:
                raise AssertionError(f"bulk_kernel {key}: the kernel differs "
                                     f"from the plain version at {bad}")
            k = int((got[1] + got[2]).sum())
            events += k
            if key.startswith("train") and k > top.get(key, (-1,))[0]:
                top[key] = (k, (p, b, st, on, stop, me), got)
        if events <= 0:
            raise AssertionError(f"bulk_kernel {key}: no event consumed")
        checked[key] = {"calls": len(rows), "events": events,
                        "lanes": int(rows[0][2].rng.shape[0]),
                        "bank_dur": str(rows[0][1].dur.dtype)}
    at = {}
    for key, (k, (p, b, st, on, stop, me), got) in top.items():
        def kern():
            return bk.bulk_events_fused(p, b, st, on, stop, me)

        def plain():
            return _bulk_events_fused_ref(p, b, st, on, stop_at_limit=stop,
                                          max_events=me)

        ms, _, ms_from = kernel_ms(kern, 50, "bulk_events_fused_kernel")
        at[key] = {"lanes": int(st.rng.shape[0]), "events": k,
                   "executors": int(st.exec_job.shape[1]),
                   "stages": list(st.stage_remaining.shape[1:]),
                   "max_events": me, "ms": ms, "ms_from": ms_from,
                   "call_ms": cuda_ms(kern, 200),
                   "plain_ms": cuda_ms(plain, 10),
                   **int_bound(*bulk_work(b, st, got, on))}
    p, b, st, on, stop, me = top["train_rbg"][1]
    host = {}
    for how, fn in (("pack_empty_like", lambda: bk.pack(p, b, st, on, stop,
                                                        me)),
                    ("arena_views", lambda: _arena_outputs(st)),
                    ("empty_like_only", lambda: [
                        torch.empty_like(getattr(st, f))
                        for f in bk.OUT_FIELDS])):
        fn()
        t = time.perf_counter()
        for _ in range(500):
            fn()
        host[how] = (time.perf_counter() - t) / 500 * 1e6
    fit = {}
    for key in ("train_rbg", "train_threefry"):
        points = []
        for p, b, st, on, stop, me in cases[key]:
            def kern(p=p, b=b, st=st, on=on, stop=stop, me=me):
                return bk.bulk_events_fused(p, b, st, on, stop, me)

            got = kern()
            ms, _, ms_from = kernel_ms(kern, 20, "bulk_events_fused_kernel")
            points.append({"steps": bulk_steps(on, got),
                           "events": int((got[1] + got[2]).sum()),
                           "ms": ms, "ms_from": ms_from})
        fixed, per_step = _line_fit([q["steps"] for q in points],
                                    [q["ms"] for q in points])
        fit[key] = {"fixed_ms": fixed, "per_step_ms": per_step,
                    "points": points}
    p, b, st, on, stop, me = top["train_rbg"][1]
    off = torch.zeros_like(on)
    got = bk.bulk_events_fused(p, b, st, off, stop, me)
    want = _bulk_events_fused_ref(p, b, st, off, stop_at_limit=stop,
                                  max_events=me)
    bad = _bulk_unequal(got, want)
    if bad or int((got[1] + got[2]).sum()):
        raise AssertionError(f"bulk_kernel disabled: differs at {bad}, "
                             f"{int((got[1] + got[2]).sum())} events")
    disabled = {"ms": kernel_ms(
        lambda: bk.bulk_events_fused(p, b, st, off, stop, me), 50,
        "bulk_events_fused_kernel")[0], "lanes": int(off.shape[0])}
    corners = bulk_corners()
    wide = _wide_jobs(p, b, st, on, stop, me)
    torch.cuda.synchronize()
    out = {"phase": "bulk_kernel", "checked": checked, "max_abs_err": 0,
           "timed": at, "host_us": host, "fit": fit, "disabled": disabled,
           "corners": corners, "wide": wide,
           "seconds": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    return out


def phase_lowprec(train: dict) -> dict:
    """`bank_dtype: int16` and `obs_dtype: bfloat16` (LOWPREC_ENV) on the
    flagship config: one iteration through `make_trainer(...).train()` at
    TRAIN_STEPS on the card (the bank's table int16, the recorded
    duration buffer bf16, health 0, the kernels launched and no plain
    version called) with its peak device memory beside the f32 layout's
    over the `train` phase's first iteration (the same config, seed, lanes
    and T); then PARITY_LANES lanes of one collection on the card and on
    the CPU port from the same weights and keys, PARITY_STEPS rows:
    actions and valid equal, the bf16 duration buffer bit-equal, log-probs
    and wall times within rtol 1e-5 (`train_parity`'s bound); the int16
    codes go through each device's float32 `expm1`, which may part in
    the last ulp (ROADMAP queue C), and a reward is a difference of wall
    times, so the rewards are held within 1e-5 of their largest magnitude
    (as the forward is held relative to its outputs' scale)."""
    import numpy as np
    import torch

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
    )
    from sparksched_tpu_torch.trainers import make_trainer

    t_phase = time.perf_counter()
    cfg = train_cfg(num_iterations=1, rollout_steps=TRAIN_STEPS)
    cfg["env"] = cfg["env"] | LOWPREC_ENV
    trainer = make_trainer(cfg, device="cuda")
    if trainer.bank.dur.dtype != torch.int16:
        raise AssertionError(f"bank table {trainer.bank.dur.dtype}")
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decima_node_encoder.launches = 0
    zero_engine_launches()
    with PlainCalls() as plain, PrngDraws() as draws, BulkCapture("lowprec"):
        trainer.train(callback=lambda i, st, s: stats.update(s))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"decima_node_encoder": decima_node_encoder.launches,
                **engine_launches()}
    ro = trainer.last_rollout
    if (ro.obs.duration.dtype != torch.bfloat16 or stats["health_mask"]
            or plain.n or draws.plain or min(launches.values()) <= 0):
        raise AssertionError(
            f"lowprec iteration: duration {ro.obs.duration.dtype}, health "
            f"{stats['health_mask']}, launches {launches}, plain "
            f"{plain.n} + {draws.plain}")
    f32_peak = train["lines"][0]["max_memory_allocated"]
    out = {"phase": "lowprec", "env": LOWPREC_ENV,
           "rollout_steps": TRAIN_STEPS, "lanes": trainer.num_envs,
           "decisions": stats["decisions"],
           "collect_seconds": stats["collect_seconds"],
           "update_seconds": stats["update_seconds"],
           "peak_bytes_bf16_int16": peak, "peak_bytes_f32": f32_peak,
           "peak_ratio": peak / f32_peak,
           "duration_buffer_bytes": ro.obs.duration.numel()
           * ro.obs.duration.element_size(),
           "kernel_launches": launches}
    # the card against the CPU port on PARITY_LANES lanes
    pcfg = train_cfg(num_sequences=1, num_rollouts=PARITY_LANES,
                     rollout_steps=PARITY_STEPS)
    pcfg["env"] = pcfg["env"] | LOWPREC_ENV
    got, sd = {}, None
    for dev in ("cuda", "cpu"):
        t = make_trainer(pcfg, device=dev)
        if sd is None:
            sd = {k: v.cpu() * WEIGHT_SCALE
                  for k, v in t.scheduler.params.items()}
        t.scheduler.load_params(sd)
        got[dev], _ = t._collect(0, prng.PRNGKey(SEED, dev,
                                                  impl=t.prng_impl))
    rc, rp = got["cuda"], got["cpu"]
    for k in ("stage_idx", "job_idx", "num_exec_k", "valid"):
        if not torch.equal(getattr(rc, k).cpu(), getattr(rp, k)):
            raise AssertionError(f"lowprec card vs CPU: {k} differs")
    if not torch.equal(rc.obs.duration.cpu().view(torch.int16),
                       rp.obs.duration.view(torch.int16)):
        raise AssertionError("lowprec card vs CPU: the bf16 buffer differs")
    errs = {}
    for k in ("lgprob", "reward", "wall_times"):
        a, b = getattr(rc, k).cpu().numpy(), getattr(rp, k).numpy()
        atol = 1e-5 * float(np.abs(b).max()) if k == "reward" else 1e-6
        if not np.allclose(a, b, rtol=1e-5, atol=atol):
            raise AssertionError(f"lowprec card vs CPU: {k} differs by "
                                 f"{np.abs(a - b).max()}")
        errs[k] = float(np.abs(a - b).max())
    errs["wall_times_bit_equal"] = bool(torch.equal(rc.wall_times.cpu(),
                                                    rp.wall_times))
    out |= {"card_vs_cpu": {"lanes": PARITY_LANES,
                            "rollout_steps": PARITY_STEPS,
                            "decisions": int(rp.valid.sum()),
                            "actions_equal": True,
                            "duration_bits_equal": True,
                            "max_abs_err": errs},
            "seconds": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    return launches


def _chaos_cfg(art: str, iterations: int, chaos_blk=None) -> dict:
    cfg = train_cfg(art, num_sequences=1, num_rollouts=PARITY_LANES,
                    rollout_steps=CHAOS_STEPS, num_iterations=iterations)
    cfg["health"] = cfg["health"] | {"backoff_seconds": 0.05,
                                     "checkpoint_every": 1,
                                     "straggler_ratio_max": 1.9}
    if chaos_blk:
        cfg["chaos"] = chaos_blk
    return cfg


def _runlog(art: str) -> list:
    import glob

    return [json.loads(x) for p in sorted(glob.glob(
        os.path.join(art, "runlog", "*.jsonl"))) for x in open(p)]


def phase_chaos() -> dict:
    """The `chaos:` block on the card, the flagship config cut to
    PARITY_LANES lanes x CHAOS_STEPS rows: `nan_grad`, `bank_row`,
    `straggler` and `oom` at iterations 1-4 of one run (CHAOS_FAULTS),
    each injection a `chaos` record; `nan_grad` and `oom` rolled back and
    retried (`health` and `recovery` records, the oom after
    `torch.cuda.empty_cache()`), `straggler` quarantined, `bank_row`
    retried where its NaN row is a live node (reported either way); the
    run finishes with finite parameters. A real `torch.OutOfMemoryError`
    from the update is retried the same way. Then `sigkill` at iteration
    1 of 2 in a child process on the card (killed after its collect, rc
    -9), the run resumed from its `checkpoint_every: 1` train state for
    the last iteration and held against an uninterrupted run as
    `train_resume` holds it (bit-equality reported; parameters within the
    `assert_update_close` bounds)."""
    import signal

    import torch

    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
        decima_node_encoder_bwd,
    )
    from sparksched_tpu_torch.trainers import make_trainer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chaos_", dir=TMP_ROOT)
    decima_node_encoder.launches = decima_node_encoder_bwd.launches = 0
    zero_engine_launches()
    art = os.path.join(root, "faults")
    t = make_trainer(_chaos_cfg(art, CHAOS_ITERS, CHAOS_FAULTS), "cuda")
    state = t.train()
    recs = [(r["ev"], r.get("action"), tuple(r.get("bits") or ()),
             tuple(r.get("injected") or ()), r.get("iteration"))
            for r in _runlog(art) if r["ev"] in ("chaos", "health",
                                                 "recovery")]
    injected = sorted(f for ev, _, _, inj, _ in recs if ev == "chaos"
                      for f in inj)
    retried = {it for ev, act, _, _, it in recs
               if ev == "recovery" and act == "rollback_retry"}
    quarantined = {it for ev, act, bits, _, it in recs
                   if ev == "health" and act == "quarantine"
                   and "straggler" in bits}
    oom = [bits for ev, _, bits, _, it in recs if ev == "health" and it == 4]
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.params.values())
    if (injected != ["bank_row", "nan_grad", "straggler"]
            or not {1, 4} <= retried or 3 not in quarantined
            or oom != [("oom",)] or state.iteration != CHAOS_ITERS
            or not finite):
        raise AssertionError(f"chaos run: records {recs}, iteration "
                             f"{state.iteration}, finite {finite}")
    # a real out-of-memory error from the update
    art2 = os.path.join(root, "real_oom")
    t2 = make_trainer(_chaos_cfg(art2, 1), "cuda")
    update, calls = t2._update, []

    def oom_once(st, ro):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return update(st, ro)

    t2._update = oom_once
    t2.train()
    real = [(r["ev"], r.get("bits")) for r in _runlog(art2)
            if r["ev"] in ("health", "recovery")]
    if len(calls) != 2 or real != [("health", ["oom"]),
                                   ("recovery", ["oom"])]:
        raise AssertionError(f"real oom: {len(calls)} updates, {real}")
    # sigkill in a child process on the card, then the resume
    killed = os.path.join(root, "killed")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {HERE!r})\n"
            "from sparksched_tpu_torch.trainers import make_trainer\n"
            "make_trainer(json.loads(sys.argv[1]), device='cuda').train()\n")
    cfg = _chaos_cfg(killed, 2, {"sigkill": [1]})
    child = subprocess.run([sys.executable, "-c", code, json.dumps(cfg)],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"sigkill child: rc {child.returncode}\n"
                             f"{child.stderr[-2000:]}")
    resumer = make_trainer(_chaos_cfg(killed, 1), "cuda")
    resumed = resumer.train(resume_from=os.path.join(
        killed, "train_state.msgpack"))
    applied = []
    full_t = make_trainer(_chaos_cfg(os.path.join(root, "full"), 2), "cuda")
    p0 = {k: v.detach().cpu().clone()
          for k, v in full_t.scheduler.params.items()}
    full = full_t.train(callback=lambda i, s, st: applied.append(
        int(st["minibatches_applied"])))
    a, b = full_t.train_state_tree(full), resumer.train_state_tree(resumed)
    first = _first_unequal(a, b)
    worst = parity_helpers().assert_update_close(
        {k: v.detach().cpu().numpy() for k, v in full.params.items()},
        resumed.params, p0, sum(applied),
        full_t.train_cfg["opt_kwargs"]["lr"], linear=False,
        heads_per_tensor=True)
    if resumed.iteration != 2 or a["opt_state"]["count"] != \
            b["opt_state"]["count"]:
        raise AssertionError("sigkill resume: iteration or Adam count")
    out = {"phase": "chaos", "lanes": PARITY_LANES,
           "rollout_steps": CHAOS_STEPS, "faults": CHAOS_FAULTS,
           "records": [list(r) for r in recs],
           "bank_row_detected": 2 in retried,
           "retries": [s["health_retries"] for s in t.stats_log],
           "real_oom_retried": True, "sigkill_rc": child.returncode,
           "resume_bit_equal": first is None, "first_unequal": first,
           "worst_param_err_over_tol": worst,
           "seconds": time.perf_counter() - t_phase}
    # this process's launches (the sigkill child's are its own)
    launches = {"decima_node_encoder": decima_node_encoder.launches,
                "decima_node_encoder_bwd": decima_node_encoder_bwd.launches,
                **engine_launches()}
    out["kernel_launches"] = launches
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# phase 9: trained weights — the held-out evaluation
# ---------------------------------------------------------------------------


# the card's and the CPU's float32 arithmetic may round a value of the
# engine (a log, an exp, a sum) an ulp or so apart
ENGINE_FLOAT_RTOL = 1e-6


def _first_divergence(card, cpu, lanes: int) -> dict | None:
    """Where the card's rollout and the CPU's first part over the first
    `lanes` lanes, decision by decision: in what a decision saw (each
    stored observation field and the wall time, `kind` "obs", with the
    largest absolute and relative difference there) or, with the
    observations equal through that decision, in the action taken
    (`kind` "action"). None when every lane agrees throughout."""
    import dataclasses

    import torch

    for lane in range(lanes):
        n = int(min(card.valid[lane].sum(), cpu.valid[lane].sum()))
        fields = [(f"obs.{f.name}", getattr(card.obs, f.name)[lane, :n],
                   getattr(cpu.obs, f.name)[lane, :n])
                  for f in dataclasses.fields(card.obs)]
        fields.append(("wall_times", card.wall_times[lane, :n],
                       cpu.wall_times[lane, :n]))
        first = None
        for name, a, b in fields:
            a = a.cpu()
            bad = (a != b).reshape(n, -1).any(1)
            if bool(bad.any()):
                d = int(bad.nonzero()[0])
                if first is None or d < first["decision"]:
                    x, y = a[d].double(), b[d].double()
                    diff = float((x - y).abs().max())
                    first = {"lane": lane, "decision": d, "kind": "obs",
                             "what": name, "float": a.is_floating_point(),
                             "abs_diff": diff,
                             "rel_diff": diff / max(float(y.abs().max()),
                                                    1e-30)}
        for name in ("stage_idx", "num_exec_k"):
            bad = getattr(card, name)[lane, :n].cpu() != getattr(
                cpu, name)[lane, :n]
            if bool(bad.any()):
                d = int(bad.nonzero()[0])
                if first is None or d < first["decision"]:
                    first = {"lane": lane, "decision": d, "kind": "action",
                             "what": name}
        if first is None and not torch.equal(card.valid[lane].cpu(),
                                             cpu.valid[lane]):
            first = {"lane": lane, "decision": n, "kind": "episode_length",
                     "what": "valid"}
        if first is not None:
            return first
    return None


def _score_gap_at(ro, div: dict, bank_cpu) -> dict:
    """The card's and the CPU's scores on one recorded observation (the
    CPU rollout's, at `div`'s lane and decision): how far apart the two
    evaluations of the trained net are there."""
    import torch

    from sparksched_tpu_torch import evaluate as ev
    from sparksched_tpu_torch.trainers.rollout import stored_to_observation

    so = ro.obs.map(lambda a: a[div["lane"], div["decision"]][None])
    out = {}
    for dev in ("cpu", "cuda"):
        params, bank = ev.eval_env(dev)
        sched = ev.make_decima(EVAL_MODEL, params, dev)
        obs = stored_to_observation(bank, so.map(lambda a: a.to(dev)))
        with torch.no_grad():
            f = sched.features(obs)
            out[dev] = [t.cpu().double() for t in (
                sched.net.encode(f), *sched.score(f))]
    names = ("node_embedding", "stage_scores", "exec_scores")
    return {f"{n}_card_vs_cpu": float((a - b).abs().max())
            for n, a, b in zip(names, out["cuda"], out["cpu"])}


def phase_eval_trained() -> dict:
    """`sparksched_tpu_torch.evaluate` with the JAX package's TPU-trained
    `model_tpu.msgpack` on the card: EVAL_SEEDS held-out seeds, fair and
    greedy Decima, full episodes. The first EVAL_CPU_SEEDS seeds are run
    again by the CPU port and compared decision by decision: with every
    observation and action equal, the avg JCTs must agree within rtol
    1e-6. Where they part, the first difference is reported and must be
    explained: an action taken on equal observations must be a near-tied
    greedy choice (its top two scores closer than `evaluate.TIE_GAP` on
    the CPU), an observation must first differ in a float (a duration or
    the wall time) by at most ENGINE_FLOAT_RTOL relative, the card's and
    the CPU's float32 rounding apart; anything else fails.
    The forward kernel is held to the float64 plain forward at these
    trained weights on a collection row at full width and compacted. The
    forward kernel must be launched on the card's evaluation and no plain
    version called there."""
    import numpy as np

    from sparksched_tpu_torch import evaluate as ev
    from sparksched_tpu_torch.kernels.bulk_events import bulk_events_fused
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder,
    )

    t_phase = time.perf_counter()
    decima_node_encoder.launches = bulk_events_fused.launches = 0
    bulk0 = bulk_plain_calls()
    with PlainCalls() as plain:
        res = ev.evaluate(EVAL_MODEL, EVAL_SEEDS, device="cuda")
    launches = decima_node_encoder.launches
    bulk_n = bulk_events_fused.launches
    if plain.n or launches <= 0:
        raise AssertionError(f"evaluation: {launches} forward launches, "
                             f"{plain.n} plain calls")
    _check_bulk("eval_trained", {"bulk_events_fused": bulk_n}, bulk0, "cuda")
    card_s = time.perf_counter() - t_phase
    for name in ("fair", "decima"):
        if not res[name]["all_done"]:
            raise AssertionError(f"{name}: an episode did not finish")
    t_cpu = time.perf_counter()
    cpu = ev.evaluate(EVAL_MODEL, seeds=res["seeds"][:EVAL_CPU_SEEDS],
                      device="cpu")
    cpu_s = time.perf_counter() - t_cpu
    params_cpu, bank_cpu = ev.eval_env("cpu")
    parity = {}
    for name in ("fair", "decima"):
        a = np.array(res[name]["avg_jct_s"][:EVAL_CPU_SEEDS])
        b = np.array(cpu[name]["avg_jct_s"])
        div = _first_divergence(res["rollouts"][name],
                                cpu["rollouts"][name], EVAL_CPU_SEEDS)
        rec = {"equal": div is None, "first_divergence": div,
               "avg_jct_rel_err": float(np.max(np.abs(a - b) / b))}
        if div is not None:
            if div["kind"] == "action" and name == "decima":
                ro = cpu["rollouts"][name]
                gaps = ev.greedy_gaps(
                    ev.make_decima(EVAL_MODEL, params_cpu, "cpu"),
                    bank_cpu, ro)
                div["gap"] = float(
                    gaps[int(ro.valid[:div["lane"]].sum()) + div["decision"]]
                    .min())
                div |= _score_gap_at(ro, div, bank_cpu)
                explained = div["gap"] < ev.TIE_GAP
            else:
                explained = (div["kind"] == "obs" and div["float"]
                             and div["rel_diff"] <= ENGINE_FLOAT_RTOL)
            if not explained:
                raise AssertionError(f"eval card vs cpu ({name}): first "
                                     f"divergence {div}")
        elif not rec["avg_jct_rel_err"] <= 1e-6:
            raise AssertionError(f"eval card vs cpu ({name}): avg JCT "
                                 f"differs by {rec['avg_jct_rel_err']}")
        parity[name] = rec
    params, bank = ev.eval_env("cuda")
    dec = ev.make_decima(EVAL_MODEL, params, "cuda")
    rows = collection_rows(dec, bank, res["rollouts"]["decima"], 8)
    fwd = {n: fwd_vs_ref64(n, f, dec.net) for n, f in rows.items()}
    if "collection_row_compact" not in fwd:
        raise AssertionError("no evaluation row fits 8 live jobs")
    out = {"phase": "eval_trained", "model": os.path.relpath(EVAL_MODEL, HERE),
           "seeds": res["seeds"], "steps": res["steps"],
           "fair_mean_avg_jct_s": res["fair"]["mean_avg_jct_s"],
           "decima_mean_avg_jct_s": res["decima"]["mean_avg_jct_s"],
           "decima_wins": res["decima_wins"],
           "decima_vs_fair": res["decima_vs_fair"],
           "decisions": {n: res[n]["decisions"] for n in ("fair", "decima")},
           "near_ties": res["decima"]["near_ties"],
           "near_ties_by_head": res["decima"]["near_ties_by_head"],
           "exact_ties": res["decima"]["exact_ties"],
           "min_gap": res["decima"]["min_gap"], "tie_gap": ev.TIE_GAP,
           "card_vs_cpu": parity, "fwd_vs_plain64": fwd,
           "encoder_launches": launches, "plain_encoder_calls": plain.n,
           "bulk_events_fused_launches": bulk_n,
           "card_seconds": card_s, "cpu_seconds": cpu_s,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return {"decima_node_encoder": launches, "bulk_events_fused": bulk_n}


# ---------------------------------------------------------------------------
# phase 10: what the telemetry costs
# ---------------------------------------------------------------------------


def phase_telemetry_cost() -> None:
    """TELEMETRY_LANES lanes x TELEMETRY_ROWS rows of the flagship
    collection from the same keys, telemetry off and on: over the first
    PROFILED_ROWS rows (off first, which also warms up), the kernel
    launches and device kernel records per row that torch.profiler sees;
    then rows per second on the host clock, no profiler, in the order
    off, on, on, off. Reported, not gated; every collection must give the
    same rollout."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.trainers import make_trainer

    t_phase = time.perf_counter()
    groups = TELEMETRY_LANES // 4
    trainer = make_trainer(train_cfg(num_sequences=groups, num_rollouts=4,
                                     rollout_steps=TELEMETRY_ROWS),
                           device="cuda")

    def collect(on: bool, rows: int = TELEMETRY_ROWS):
        trainer.obs_telemetry = on
        trainer.rollout_steps = rows
        counts: dict = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        ro, _ = trainer._collect(
            0, prng.PRNGKey(SEED, "cuda", impl=trainer.prng_impl), counts)
        torch.cuda.synchronize()
        return ro, counts, time.perf_counter() - t

    out = {}
    for mode in ("off", "on"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, pcounts, _ = collect(mode == "on", PROFILED_ROWS)
        ev = prof.events()
        launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchKernelExC") for e in ev)
        kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      for e in ev)
        prows = pcounts["rows"]
        out[mode] = {"profiled_rows": prows,
                     "kernel_launches_per_row": launches / prows,
                     "device_records_per_row": kernels / prows,
                     "rows_per_s": []}
    first = None
    for mode in ("off", "on", "on", "off"):
        ro, counts, secs = collect(mode == "on")
        out[mode]["rows_per_s"].append(counts["rows"] / secs)
        if mode == "on":
            out[mode]["telemetry_decisions"] = int(
                counts["telemetry"].decide_steps.sum())
        first = first or ro
        if not all(torch.equal(getattr(first, k), getattr(ro, k))
                   for k in ("stage_idx", "num_exec_k", "valid", "lgprob",
                             "reward", "wall_times")):
            raise AssertionError("telemetry changed the collection")
    emit({"phase": "telemetry_cost", "lanes": TELEMETRY_LANES,
          "rows": TELEMETRY_ROWS, "same_rollout": True, **out,
          "launches_per_row_added": out["on"]["kernel_launches_per_row"]
          - out["off"]["kernel_launches_per_row"],
          "seconds": time.perf_counter() - t_phase})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import sparksched_tpu_torch
    except ImportError:
        print("chip_smoke: sparksched_tpu_torch not found next to this "
              "script", file=sys.stderr)
        return 2
    if not os.path.abspath(sparksched_tpu_torch.__file__).startswith(HERE):
        print("chip_smoke: sparksched_tpu_torch is not the checkout's",
              file=sys.stderr)
        return 2
    global TMP_ROOT
    t_start = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    TMP_ROOT = tmp.name
    try:
        emit({"phase": "env", "python": sys.version.split()[0],
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)})
        phase_build()
        params, bank, agent = flagship("cuda")
        sched = make_scheduler(params, agent, "cuda")
        cases, calls, checks = phase_kernels(params, bank, sched)
        phase_serve(params, bank, sched, "serve", None, ROUNDS)
        phase_serve(params, bank, sched, "serve_knobs_off", KNOBS_OFF,
                    ROUNDS_OFF)
        front = phase_serve_front(params, bank, sched)
        http = phase_serve_http(params, bank, sched)
        online = phase_online(params, bank, agent)
        fleet = phase_serve_fleet(params, bank, sched, agent)
        phase_parity(agent, sched)
        phase_run_flat()
        train = phase_train()
        chunks = phase_train_kernels(train)
        phase_fwd_train(train["trainer"], chunks, cases)
        tsched = train["trainer"].scheduler
        bwd, bwd_err_max = phase_bwd_kernel(tsched, checks, chunks)
        phase_kernel_alone(cases, calls, tsched, chunks[CHUNK_TIMED], bwd)
        rbg = phase_rbg(train["rbg_draws"])
        prng_out = phase_prng(train)
        phase_train_parity(parity_helpers())
        paths = {"serve_front": front, "serve_http": http,
                 "online": online, "serve_fleet": fleet,
                 "train": train["launches"],
                 "train_resume": phase_train_resume(),
                 "lowprec": phase_lowprec(train),
                 "chaos": phase_chaos(),
                 "eval_trained": phase_eval_trained()}
        bulk = phase_bulk_kernel()
        phase_telemetry_cost()
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        tmp.cleanup()
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    fwd, bw = cases[CHUNK_TIMED], bwd[CHUNK_TIMED]
    rbg_top = next(iter(rbg["timed"].values()))  # the most launched shape
    bw_at = {n: {k: b[k] for k in ("shape", "ms", "bound_ms", "bound_by",
                                   "plain_ms", "scratch_bytes")}
             for n, b in bwd.items()}
    emit({"kernels": [{
        "name": "decima_node_encoder",
        "route": "cuda",
        "source": "sparksched_tpu_torch/csrc/decima_encoder.cu",
        "replaces": "sparksched_tpu/schedulers/decima.py:284",
        "launches": train["launches"]["decima_node_encoder"],
        "launches_by_path": {p: n["decima_node_encoder"]
                             for p, n in paths.items()
                             if "decima_node_encoder" in n},
        "max_abs_err": max([c["max_abs_err"] for c in cases.values()]
                           + [front["max_abs_err"]]),
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "decima_node_encoder_bwd",
        "route": "cuda",
        "source": "sparksched_tpu_torch/csrc/decima_encoder_bwd.cu",
        "replaces": "sparksched_tpu/schedulers/decima.py:706",
        "launches": train["launches"]["decima_node_encoder_bwd"],
        "launches_by_path": {p: n["decima_node_encoder_bwd"]
                             for p, n in paths.items()
                             if "decima_node_encoder_bwd" in n},
        "max_abs_err": bwd_err_max,
        "ms": bw["ms"],
        "plain_ms": bw["plain_ms"],
        "bound_ms": bw["bound_ms"],
        "bound_by": bw["bound_by"],
        "library_ms": None,
        "scratch_bytes": max(b["scratch_bytes"] for b in bw_at.values()),
        "at": bw_at,
    }, {
        "name": "rbg_random_bits",
        "route": "cuda",
        "source": "sparksched_tpu_torch/csrc/rbg_philox.cu",
        "replaces": "jax/_src/prng.py:_rbg_random_bits "
                    "(lax.rng_bit_generator; the JAX package's fast_prng, "
                    "sparksched_tpu/config.py:263)",
        "launches": train["launches"]["rbg_random_bits"],
        "launches_by_path": {p: n["rbg_random_bits"]
                             for p, n in paths.items()
                             if "rbg_random_bits" in n},
        "max_abs_err": rbg["max_abs_err"],
        "ms": rbg_top["ms"],
        "plain_ms": rbg_top["plain_ms"],
        "bound_ms": rbg_top["bound_ms"],
        "bound_by": rbg_top["bound_by"],
        "library_ms": None,
        "at": rbg["timed"],
    }, *({
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": train["launches"][name],
        "launches_by_path": {p: n[name] for p, n in paths.items()
                             if name in n},
        "max_abs_err": prng_out["max_abs_err"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "at": prng_out["timed"][name],
    } for name, source, replaces, top in (
        ("threefry2x32", "sparksched_tpu_torch/csrc/threefry.cu",
         "jax/_src/prng.py:threefry_2x32 (threefry2x32_p under "
         "jax.random.split / fold_in / bits / uniform, fused by XLA in "
         "the JAX package)",
         next(iter(prng_out["timed"]["threefry2x32"].values()))),
        ("split_uniform", "sparksched_tpu_torch/csrc/rbg_philox.cu",
         "sparksched_tpu/env/core.py:259-264 (jax.random.split then "
         "jax.random.uniform; also :575-579, :1120-1123, :1319-1322; "
         "the fused pass's :1570-1574 is bulk_events_fused's)",
         next(iter(prng_out["timed"]["split_uniform"].values()))))), {
        "name": "bulk_events_fused",
        "route": "cuda",
        "source": "sparksched_tpu_torch/csrc/bulk_events.cu",
        "replaces": "sparksched_tpu/env/core.py:1478-1740 (_bulk_events_fused: "
                    "jax.random.split + uniform at :1570-1574, the lax.scan "
                    "at :1672, sample_task_duration and sample_executor_key "
                    "at sparksched_tpu/workload/sampling.py:74, :45; "
                    "XLA-compiled)",
        "launches": train["launches"]["bulk_events_fused"],
        "launches_by_path": {p: n["bulk_events_fused"]
                             for p, n in paths.items()
                             if "bulk_events_fused" in n},
        "max_abs_err": bulk["max_abs_err"],
        "ms": bulk["timed"]["train_rbg"]["ms"],
        "plain_ms": bulk["timed"]["train_rbg"]["plain_ms"],
        "bound_ms": bulk["timed"]["train_rbg"]["bound_ms"],
        "bound_by": bulk["timed"]["train_rbg"]["bound_by"],
        "library_ms": None,
        "at": bulk["timed"],
        "fixed_ms": {k: f["fixed_ms"] for k, f in bulk["fit"].items()},
        "per_step_ms": {k: f["per_step_ms"] for k, f in bulk["fit"].items()},
        "disabled_ms": bulk["disabled"]["ms"],
        "corners_checked": len(bulk["corners"]),
    }]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
