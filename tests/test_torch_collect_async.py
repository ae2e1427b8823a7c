"""The port's asynchronous single-eval collector against the JAX
package's.

- `collect_flat_async_batch` over 4 persistent lanes (2 sequence groups
  x 2, laid out as the trainer lays them out), two chunks, the second
  from the first's returned `LoopState` and reset ordinals, against the
  JAX collector with telemetry and health on: Decima under threefry2x32
  (the port's `lane_policy` on the lanes' split policy keys, as the
  trainer calls it; the JAX `batch_policy`) under threefry2x32 and
  under rbg (the flagship's setting), and the fair heuristic under
  rbg. Every `Rollout` leaf as `rollout_mismatches` holds it (bit-equal
  but the rewards, the log-probs, the final state's floats and the
  elapsed wall times, within 1e-6), the LoopState carry, the counters
  and the health mask.
- `tests/test_trainers.py::
  test_collect_flat_async_batch_group_sequences_budget_and_resume`: the
  lanes of a group replay one sequence at equal reset ordinals
  (threefry2x32; under rbg a batch draws one stream), the reset counts
  advance by the resets, a resumed chunk keeps collecting (two port
  chunks of T = 48 without a budget), and the budget freezes lanes at
  the decision row that crosses it (the parity chunks).
- The collector writes nothing into the carry it is given (a health
  retry restarts from it).

Sizes: 4 executors, 4 job slots, mean time limit 1e6, T = 24, budget
6e5 of simulated time per chunk.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.schedulers.heuristics import (
    round_robin_policy as j_round_robin,
)
from sparksched_tpu.trainers import rollout as jro
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.env import flat_loop as tfl
from sparksched_tpu_torch.obs.telemetry import telemetry_zeros
from sparksched_tpu_torch.schedulers.heuristics import round_robin_policy
from sparksched_tpu_torch.trainers import rollout as tro

from ._torch_parity import (
    COLLECT_N,
    collect_env,
    decima_pair,
    group_lanes,
    jax_impl,
    jax_leaves,
    jax_telemetry_array,
    mismatched_leaves,
    port_leaves,
    rollout_mismatches,
    to_port_key,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

T, BUDGET = 24, 6e5
CASES = [("decima", "threefry2x32"), ("fair", "rbg"), ("decima", "rbg")]


def batch_policies(kind: str):
    """(JAX batch policy, port policy, split_policy_keys)."""
    if kind == "fair":
        return (lambda k, o: jax.vmap(
                    lambda x: j_round_robin(x, COLLECT_N, True))(o) + ({},),
                lambda k, o: round_robin_policy(o, COLLECT_N, True) + ({},),
                False)
    js, ts = decima_pair(COLLECT_N)
    return (lambda k, o: js.batch_policy(k, o, js.params), ts.lane_policy,
            True)


@functools.lru_cache(maxsize=None)
def _collected(kind: str, impl: str):
    saved = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", impl)
    try:
        jp, jb, tp, tb = collect_env()
        j, t = group_lanes(17)
        jpol, tpol, split = batch_policies(kind)
        jls = jax.vmap(jfl.init_loop_state)(jax.vmap(
            lambda s, l: jcore.reset_pair(jp, jb, s, l))(j["seq"], j["lane"]))
        tls = tfl.init_loop_state(core.reset_pair(tp, tb, t["seq"],
                                                  t["lane"]))
        jrc, trc = np.ones(4, np.int32), torch.ones(4, dtype=torch.int32)
        chunks = []
        for c in range(2):  # the second chunk resumes from the carry
            key = jax.random.fold_in(j["key"], c)
            jout, jls2, jtm = jro.collect_flat_async_batch(
                jp, jb, jpol, key, T, jls, BUDGET, j["bases"], j["salts"],
                jrc, telemetry_zeros_like((4,)), health=True)
            before = port_leaves(tls, None)
            counts = {}
            tout, tls2, hm, ttm = tro.collect_flat_async_batch(
                tp, tb, tpol, to_port_key(key), T, tls, BUDGET, t["bases"],
                t["salts"], trc, telemetry_zeros(4), health=True,
                counts=counts, split_policy_keys=split)
            untouched = not mismatched_leaves([a for _, a in before],
                                              port_leaves(tls, None), 0.0)
            chunks.append((jout, jls2, jax_telemetry_array(jtm), tout, tls2,
                           hm, ttm.t.numpy(), counts, untouched))
            jls, tls = jls2, tls2
            jrc, trc = jout.final_reset_count, tout.final_reset_count
        return chunks
    finally:
        jax.config.update("jax_default_prng_impl", saved)


@pytest.mark.parametrize("kind,impl", CASES)
def test_collect_flat_async_batch_matches_jax(kind, impl):
    for (jout, jls, jtm, tout, tls, hm, ttm, counts,
         untouched) in _collected(kind, impl):
        bad = rollout_mismatches(jout, tout, wall_rtol=1e-6)
        assert not bad, bad
        assert not mismatched_leaves(jax_leaves(jls), port_leaves(tls, None),
                                     rtol=1e-6)
        assert np.array_equal(jtm, ttm)
        assert np.array_equal(ttm[:, -1], hm.numpy()) and not hm.any()
        assert untouched
        assert tout.valid.sum() >= 4 * 3


@pytest.mark.parametrize("kind,impl", CASES)
def test_collect_flat_async_batch_group_sequences_budget_and_resume(kind,
                                                                     impl):
    # the budget is checked per decision row: a lane stops at the first
    # row that starts past it, and the loop then leaves early
    for *_, tout, _, _, _, counts, _ in _collected(kind, impl):
        spent = tout.wall_times.numpy()[:, -1]
        assert (spent >= BUDGET).all() and counts["rows"] < T
        last = tout.wall_times.numpy()[np.arange(4),
                                       tout.valid.numpy().sum(1) - 1]
        assert (last < BUDGET).all()
    # without a budget: resets, their ordinals, a resumed chunk
    tp, tb = collect_env()[2:]
    with jax_impl(impl):
        t = group_lanes(17)[1]
    _, tpol, split = batch_policies(kind)
    ls = tfl.init_loop_state(core.reset_pair(tp, tb, t["seq"], t["lane"]))
    rc, pairs = torch.ones(4, dtype=torch.int32), 0
    for c in range(2):
        ro, ls = tro.collect_flat_async_batch(
            tp, tb, tpol, prng.fold_in(t["key"], 10 + c), 48, ls, 1e9,
            t["bases"], t["salts"], rc, split_policy_keys=split)
        n_resets = ro.resets.sum(1)
        assert ro.valid.sum() > 0
        if c == 0:
            assert n_resets.min() >= 1 and n_resets.sum() >= 6
            assert torch.equal(ro.final_reset_count, rc + n_resets)
        else:  # one before a resumed lane's first decision is not marked
            assert (ro.final_reset_count >= rc + n_resets).all()
        rc = ro.final_reset_count
        if impl != "threefry2x32":
            continue  # under rbg a batch draws one stream
        resets, valid = ro.resets.numpy(), ro.valid.numpy()
        tmpl = ro.obs.job_template.numpy()
        for g in (0, 2):
            at = [np.flatnonzero(resets[g + r]) + 1 for r in (0, 1)]
            for a, b in zip(*at):
                if a < 48 and b < 48 and valid[g, a] and valid[g + 1, b]:
                    assert np.array_equal(tmpl[g, a], tmpl[g + 1, b])
                    pairs += 1
    assert pairs >= 2 or impl != "threefry2x32"
