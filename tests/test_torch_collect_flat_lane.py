"""The port's per-lane flat collectors and `micro_step(record=True)`
against the JAX package's.

- `micro_step(record=True)`: 24 micro-steps of 4 lanes (every mode, an
  auto-reset on the way) under Decima's per-lane policy; each step's
  `MicroRec` — the observation, the action fields, `decide`, reward,
  `dt`, `reset` — and the LoopState equal the JAX package's vmapped
  `micro_step(record=True)`: bit for bit but the log-probs (rtol 1e-5),
  the rewards, `dt` and the state's floats (rtol 1e-6: a reset's arrival
  gaps take float32 `log1p`, where torch and XLA may part in the last
  ulp, and the times after it inherit that).
- `collect_flat_sync` and `collect_flat_async` over 4 lanes (2 sequence
  groups x 2), against the JAX collectors vmapped as the JAX trainer
  vmaps them, with telemetry and health on, under threefry2x32 and rbg
  keys, for the fair heuristic and Decima, with an event burst of 1 and
  2: every `Rollout` leaf as `rollout_mismatches` holds it (bit-equal but
  rewards, log-probs and the final state's floats), the counters and
  the health mask bit-equal. The asynchronous ones run a second chunk
  from the returned `LoopState` and reset ordinals, held the same way
  (`tests/test_trainers.py::
  test_collect_flat_async_group_sequences_budget_and_resume`): the lanes
  of a group share sequences at equal ordinals (threefry2x32),
  `final_reset_count` is 1 + the resets, and the budget freezes lanes.

Sizes: 4 executors, 4 job slots, mean time limit 1e6, T = 8 (sync) and
24 (async, budget 6e5), 4 micro-step groups per decision.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.trainers import rollout as jro
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.env import flat_loop as tfl
from sparksched_tpu_torch.obs.telemetry import telemetry_zeros
from sparksched_tpu_torch.trainers import rollout as tro

from ._torch_parity import (
    collect_env,
    collect_policies,
    decima_pair,
    group_lanes,
    jax_leaves,
    jax_telemetry_array,
    mismatched_leaves,
    port_leaves,
    rollout_mismatches,
    to_port_key,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

SYNC_T, ASYNC_T, BUDGET = 8, 24, 6e5
CASES = [("sync", "decima", "rbg", 1), ("async", "decima", "threefry2x32", 2),
         ("async", "fair", "rbg", 1)]


def _ls_mismatches(jls, tls) -> list[str]:
    return mismatched_leaves(jax_leaves(jls), port_leaves(tls, None),
                             rtol=1e-6)


def test_micro_step_record_matches_jax():
    jp, jb, tp, tb = collect_env()
    js, ts = decima_pair(4)
    j, t = group_lanes(5)
    jls = jax.vmap(jfl.init_loop_state)(jax.vmap(
        lambda s, l: jcore.reset_pair(jp, jb, s, l))(j["seq"], j["lane"]))
    tls = tfl.init_loop_state(core.reset_pair(tp, tb, t["seq"], t["lane"]))
    step = jax.jit(jax.vmap(lambda ls, k: jfl.micro_step(
        jp, jb, lambda kk, o: js.policy(kk, o, js.params), ls, k,
        record=True, t_ref=ls.env.wall_time)))
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    modes, decided, resets = set(), 0, 0
    for i in range(24):
        keys = jax.vmap(jax.random.fold_in, (0, None))(keys, i)
        modes |= set(np.asarray(jls.mode).tolist())
        t_ref = tls.env.wall_time
        jls, jrec = step(jls, keys)
        tls, trec = tfl.micro_step(tp, tb, ts.lane_policy, tls,
                                   to_port_key(keys), record=True,
                                   t_ref=t_ref)
        for f in dataclasses.fields(trec.obs):
            a = np.asarray(getattr(jrec.obs, f.name))
            b = getattr(trec.obs, f.name).numpy()
            rtol = 1e-6 if f.name == "wall_time" else 0.0
            assert not mismatched_leaves([a], [(f.name, b)], rtol), (i, f.name)
        for f in dataclasses.fields(trec):
            if f.name == "obs":
                continue
            a = np.asarray(getattr(jrec, f.name))
            b = getattr(trec, f.name).numpy()
            rtol = {"lgprob": 1e-5, "reward": 1e-6, "dt": 1e-6}.get(
                f.name, 0.0)
            assert not mismatched_leaves([a], [(f.name, b)], rtol), (i, f.name)
        assert not _ls_mismatches(jls, tls), i
        decided += int(trec.decide.sum())
        resets += int(trec.reset.sum())
    assert modes == {tfl.M_DECIDE, tfl.M_FULFILL, tfl.M_EVENT}
    assert decided >= 8 and resets >= 1


@functools.lru_cache(maxsize=None)
def _collected(mode: str, kind: str, impl: str, burst: int):
    saved = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", impl)
    try:
        jp, jb, tp, tb = collect_env()
        j, t = group_lanes(13)
        jpol, tpol, _ = collect_policies(kind)
        jstates = jax.vmap(lambda s, l: jcore.reset_pair(jp, jb, s, l))(
            j["seq"], j["lane"])
        tstates = core.reset_pair(tp, tb, t["seq"], t["lane"])
        tm0 = telemetry_zeros_like((4,))
        T = SYNC_T if mode == "sync" else ASYNC_T
        knobs = dict(micro_groups=tro.flat_micro_group_budget(T, 4.0, burst),
                     event_burst=burst, health=True)
        if mode == "sync":
            jout, jtm = jax.vmap(lambda k, s, tm: jro.collect_flat_sync(
                jp, jb, jpol, k, T, s, tm, **knobs))(j["pol"], jstates, tm0)
            tout, hm, ttm = tro.collect_flat_sync(
                tp, tb, tpol, t["pol"], T, tstates, telemetry_zeros(4),
                **knobs)
            return [(jout, jax_telemetry_array(jtm), tout, hm, ttm.t.numpy(),
                     None, None)]

        fn = jax.jit(jax.vmap(lambda k, ls, b, salt, r, tm:
                              jro.collect_flat_async(
                                  jp, jb, jpol, k, T, ls, BUDGET, b, salt, r,
                                  tm, **knobs)))
        jls = jax.vmap(jfl.init_loop_state)(jstates)
        tls = tfl.init_loop_state(tstates)
        jrc, trc = np.ones(4, np.int32), torch.ones(4, dtype=torch.int32)
        chunks = []
        for c in range(2):  # the second chunk resumes from the carry
            jk = jax.vmap(jax.random.fold_in, (0, None))(j["pol"], c)
            jout, jls, jtm = fn(jk, jls, j["bases"], j["salts"], jrc, tm0)
            tout, tls, hm, ttm = tro.collect_flat_async(
                tp, tb, tpol, to_port_key(jk), T, tls, BUDGET, t["bases"],
                t["salts"], trc, telemetry_zeros(4), **knobs)
            chunks.append((jout, jax_telemetry_array(jtm), tout, hm,
                           ttm.t.numpy(), jls, tls))
            jrc, trc = jout.final_reset_count, tout.final_reset_count
        return chunks
    finally:
        jax.config.update("jax_default_prng_impl", saved)


@pytest.mark.parametrize("mode,kind,impl,burst", CASES)
def test_flat_lane_collector_matches_jax(mode, kind, impl, burst):
    for jout, jtm, tout, hm, ttm, jls, tls in _collected(mode, kind, impl,
                                                         burst):
        bad = rollout_mismatches(jout, tout,
                                 wall_rtol=0.0 if mode == "sync" else 1e-6)
        assert not bad, bad
        assert np.array_equal(jtm, ttm)
        assert np.array_equal(ttm[:, -1], hm.numpy()) and not hm.any()
        valid = tout.valid.numpy()
        assert valid.sum() >= 4 * 3
        if jls is not None:
            assert not _ls_mismatches(jls, tls)


@pytest.mark.parametrize("kind,impl", [("decima", "threefry2x32"),
                                       ("fair", "rbg")])
def test_collect_flat_async_group_sequences_budget_and_resume(kind, impl):
    chunks = _collected("async", kind, impl, 2 if kind == "decima" else 1)
    spent = []
    for c, (_, _, tout, *_rest) in enumerate(chunks):
        n_resets = tout.resets.numpy().sum(1)
        final = tout.final_reset_count.numpy()
        if c == 0:  # every reset follows a decision of the chunk
            assert (final == 1 + n_resets).all()
        else:  # one before a resumed lane's first decision is not marked
            assert (final >= chunks[0][2].final_reset_count.numpy()
                    + n_resets).all()
        assert tout.valid.sum() > 0
        spent.append(tout.wall_times.numpy()[:, -1])
    assert sum(int(x[2].resets.sum()) for x in chunks) >= 8
    # the budget froze lanes: each stops within a group's span past it
    spent = np.concatenate(spent)
    assert (spent >= BUDGET).sum() >= 2 and (spent < 2 * BUDGET).all()
    if impl == "threefry2x32":  # under rbg a batch draws one stream
        pairs = 0
        for _, _, tout, *_rest in chunks:
            resets = tout.resets.numpy()
            valid = tout.valid.numpy()
            tmpl = tout.obs.job_template.numpy()
            for g in (0, 2):
                at = [np.flatnonzero(resets[g + r]) + 1 for r in (0, 1)]
                for a, b in zip(*at):
                    if (max(a, b) < ASYNC_T and valid[g, a]
                            and valid[g + 1, b]):
                        assert np.array_equal(tmpl[g, a], tmpl[g + 1, b])
                        pairs += 1
        assert pairs >= 2
    assert prng.impl_of(chunks[0][2].final_state.rng) == impl
