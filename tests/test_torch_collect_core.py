"""The port's `core.step` collectors against the JAX package's.

- `collect_sync` and `collect_async` over 4 lanes (2 sequence groups x
  2, laid out as the trainer lays them out), against the JAX collectors
  vmapped as the JAX trainer vmaps them, with telemetry and health on:
  under threefry2x32 and rbg keys, for the fair heuristic and for
  Decima (the port's `lane_policy` on the lanes' policy keys already
  split, the JAX `policy` on each lane's key). Every `Rollout` leaf is
  bit-equal — the stored observations, actions, valid and reset masks,
  wall times, the final state and the reset counts — but the rewards
  (rtol 1e-6) and the log-probs (rtol 1e-5, two float32 GNNs); the
  counters and the health mask are bit-equal. `job_idx` and
  `num_exec_k` are compared on the valid steps only: once every lane is
  frozen the port leaves the loop, and the rows it skips hold no policy
  sample (the JAX rows hold one on the frozen state, which no consumer
  reads).
- Under threefry2x32 the lanes of a sequence group replay one job
  sequence at equal reset ordinals, although they reset at different
  decisions, and the groups draw different ones (`tests/test_trainers.py
  ::test_collect_async_group_shares_sequences_across_resets`).
- The counters of one episode collected by `collect_sync` and by
  `run_flat` describe the same trajectory (`tests/test_flat_loop.py::
  test_telemetry_parity_core_vs_flat`).

Sizes: 4 executors, 4 job slots, mean time limit 1e6 (episodes of ~5-15
decisions), T = 8 (sync: some lanes cut, some done) and 32 (async, a
budget of 4e6 that freezes lanes mid-call).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.env import core as jcore
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.trainers import rollout as jro
from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.env.flat_loop import run_flat
from sparksched_tpu_torch.obs.telemetry import summarize, telemetry_zeros
from sparksched_tpu_torch.schedulers.heuristics import round_robin_policy
from sparksched_tpu_torch.trainers import rollout as tro

from ._torch_parity import (
    collect_env,
    collect_policies,
    group_lanes,
    jax_telemetry_array,
    port_fixture_state,
    rollout_mismatches,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .reference_fixtures import spec_multi_job

SYNC_T, ASYNC_T, BUDGET = 8, 32, 4e6
CASES = [("sync", "fair", "threefry2x32"), ("sync", "decima", "rbg"),
         ("async", "decima", "threefry2x32"), ("async", "fair", "rbg")]


@functools.lru_cache(maxsize=None)
def _collected(mode: str, kind: str, impl: str):
    saved = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", impl)
    try:
        jp, jb, tp, tb = collect_env()
        j, t = group_lanes(11)
        jpol, tpol, split = collect_policies(kind)
        jstates = jax.vmap(lambda s, l: jcore.reset_pair(jp, jb, s, l))(
            j["seq"], j["lane"])
        tstates = core.reset_pair(tp, tb, t["seq"], t["lane"])
        tm0 = telemetry_zeros_like((4,))
        if mode == "sync":
            jout, jtm = jax.vmap(lambda k, s, tm: jro.collect_sync(
                jp, jb, jpol, k, SYNC_T, s, tm, health=True))(
                    j["pol"], jstates, tm0)
            counts = {}
            tout, hm, ttm = tro.collect_sync(
                tp, tb, tpol, t["pol"], SYNC_T, tstates, telemetry_zeros(4),
                True, counts=counts, split_policy_keys=split)
        else:
            rc = np.ones(4, np.int32)
            jout, jtm = jax.vmap(
                lambda k, s, b, salt, r, tm: jro.collect_async(
                    jp, jb, jpol, k, ASYNC_T, s, BUDGET, b, salt, r, tm,
                    health=True))(j["pol"], jstates, j["bases"], j["salts"],
                                  rc, tm0)
            counts = {}
            tout, hm, ttm = tro.collect_async(
                tp, tb, tpol, t["pol"], ASYNC_T, tstates, BUDGET, t["bases"],
                t["salts"], torch.from_numpy(rc), telemetry_zeros(4), True,
                counts=counts, split_policy_keys=split)
        return jout, jax_telemetry_array(jtm), tout, hm, ttm.t.numpy(), counts
    finally:
        jax.config.update("jax_default_prng_impl", saved)


@pytest.mark.parametrize("mode,kind,impl", CASES)
def test_core_collector_matches_jax(mode, kind, impl):
    jout, jtm, tout, hm, ttm, counts = _collected(mode, kind, impl)
    bad = rollout_mismatches(jout, tout, actions_where_valid=True)
    assert not bad, bad
    assert np.array_equal(jtm, ttm)
    assert np.array_equal(ttm[:, -1], hm.numpy()) and not hm.any()
    valid = tout.valid.numpy()
    assert valid.sum() >= 4 * 3
    if mode == "sync":  # some lanes done before T, some cut at T
        assert valid[:, -1].any() and not valid[:, -1].all()
    else:  # resets happened, the budget froze lanes before T
        assert tout.resets.numpy().sum(1).min() >= 2
        assert not valid[:, -1].all()
        assert counts["rows"] < ASYNC_T or valid[:, -1].any()
        assert (tout.final_reset_count.numpy()
                == 1 + tout.resets.numpy().sum(1)).all()


def test_collect_async_group_shares_sequences_across_resets():
    """At each reset ordinal the two lanes of a group start the same job
    sequence (templates and arrival count), at different decisions; the
    groups' first sequences differ. Under threefry2x32 only: under rbg a
    batch draws one stream (lane b words [b*n, (b+1)*n) of lane 0's), so
    there the lanes of a group do not share sequences, in the JAX package
    as in the port (ROADMAP queue C; the rbg cases above hold the port to
    it)."""
    tout = _collected("async", "decima", "threefry2x32")[2]
    resets = tout.resets.numpy()
    tmpl = tout.obs.job_template.numpy()
    num_jobs = tout.obs.job_mask.numpy()
    after = {}
    for lane in range(4):
        after[lane] = [int(i) + 1 for i in np.flatnonzero(resets[lane])[:2]]
        assert len(after[lane]) == 2 and after[lane][-1] < ASYNC_T
    assert after[0] != after[1] or after[2] != after[3]
    for g in (0, 2):
        for o in range(2):
            a, b = after[g][o], after[g + 1][o]
            assert np.array_equal(tmpl[g, a], tmpl[g + 1, b])
    first = [(tmpl[g, after[g][0]].tolist(), num_jobs[g, after[g][0]].sum())
             for g in (0, 2)]
    arrivals = tout.final_state.job_arrival_time
    assert first[0] != first[1] or not torch.equal(arrivals[0], arrivals[2])


def test_telemetry_parity_core_vs_flat():
    """One episode of the fixture (4 staggered jobs, 5 executors) under
    the fair heuristic: `collect_sync`'s counters and `run_flat`'s agree
    on the decisions, the events by kind, the fulfillments and the
    finished rounds."""
    params, bank, ls = port_fixture_state(spec_multi_job(4, 11), 5)
    pol = lambda k, o: round_robin_policy(o, 5, True) + ({},)  # noqa: E731
    keys = torch.zeros((1, 2), dtype=torch.int64)
    counts = {}
    ro, tm_core = tro.collect_sync(params, bank, pol, keys, 400, ls.env,
                                   telemetry_zeros(1), counts=counts)
    assert bool(ro.final_state.terminated[0])
    assert counts["rows"] == int(ro.valid.sum()) < 400  # left at the end
    assert not ro.valid[0, -1]
    ls_f, tm_flat = ls, telemetry_zeros(1)
    for _ in range(40):  # 4,000 micro-steps at most, as the JAX test runs
        ls_f, tm_flat = run_flat(params, bank, pol, keys, 100,
                                 loop_state=ls_f, auto_reset=False,
                                 telemetry=tm_flat)
        if int(ls_f.episodes[0]):
            break  # later micro-steps of a done lane count nothing
    assert int(ls_f.episodes[0]) == 1
    s_core, s_flat = summarize(tm_core), summarize(tm_flat)
    assert s_core["decisions"] == s_flat["decisions"] == int(
        ls_f.decisions[0]) == int(ro.valid.sum())
    for k in ("events_by_kind", "fulfillments", "commit_rounds"):
        assert s_core[k] == s_flat[k], k
    assert s_core["phase_iters"]["decide"] == s_flat["phase_iters"]["decide"]
    assert s_core["phase_iters"]["bulk"] > 0
    assert s_flat["phase_iters"]["bulk"] > 0
