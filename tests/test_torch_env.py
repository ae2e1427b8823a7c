"""The port's sequential engine against the JAX package: `reset` must
give equal LoopStates (all 61 leaves), and repeated `apply_and_drain`
under a first-schedulable policy (knobs off: event_bulk=False,
fulfill_bulk=False) must agree with `jax.jit(apply_and_drain)` after
every decision, health masks included (the bulk engine is held against
JAX in `test_torch_bulk.py` and `test_torch_drain.py`). Integer and bool leaves must be
equal; float leaves equal on the reference fixtures (integral
durations, no sampled arrivals) and within rtol 1e-6 on synthetic-bank
episodes, whose arrival times carry last-ulp log1p differences."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.env.health import reward_health as j_reward_health
from sparksched_tpu.env.health import state_health as j_state_health
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env import core, flat_loop
from sparksched_tpu_torch.env.health import reward_health, state_health
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import (
    jax_leaves,
    mismatched_leaves,
    port_fixture_state,
    port_leaves,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .reference_fixtures import (
    make_tpu_env_state,
    spec_chain,
    spec_diamond,
    spec_multi_job,
)

N, J = 10, 12


@pytest.fixture(scope="module")
def synthetic():
    jp = JaxParams(num_executors=N, max_jobs=J, mean_time_limit=2e7)
    jb = jax_bank(N, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    tp = EnvParams(num_executors=N, max_jobs=J, max_stages=jp.max_stages,
                   max_levels=jp.max_levels, mean_time_limit=2e7)
    tb = make_workload_bank(N, tp.max_stages, device="cpu")
    return jp, jb, tp, tb


def _jax_stepper(jp, jb):
    @jax.jit
    def step(ls, si, ne):
        ls2, rec = jfl.apply_and_drain(
            jp, jb, ls, si, ne, jax.random.PRNGKey(0), auto_reset=False,
            event_bulk=False, fulfill_bulk=False,
        )
        hm = j_state_health(ls2.env, ls.env, rec[3]) | j_reward_health(rec[1])
        return ls2, rec, hm

    return step


def _action(ls, d: int) -> tuple[int, int]:
    """First schedulable stage, a cycling executor count; every 7th
    decision passes -1 (no selection: the commit-the-rest path)."""
    sch = np.asarray(ls.env.schedulable).reshape(-1)
    si = int(np.argmax(sch)) if sch.any() and d % 7 != 6 else -1
    return si, 1 + d % 3


def _run(jp, jb, tp, tb, js, ts, max_decisions: int, rtol: float) -> int:
    """Decisions served until `max_decisions` or the episode's end
    (returned as -decisions, so callers can tell the two apart)."""
    step = _jax_stepper(jp, jb)
    for d in range(max_decisions):
        if bool(jfl._lane_done(js.env)):
            return -d
        si, ne = _action(js, d)
        env0 = ts.env
        js, jrec, jhm = step(js, jnp.int32(si), jnp.int32(ne))
        ts, trec = flat_loop.apply_and_drain(
            tp, tb, ts, torch.tensor([si], dtype=torch.int32),
            torch.tensor([ne], dtype=torch.int32), prng.PRNGKey(0)[None],
            event_bulk=False, fulfill_bulk=False,
        )
        thm = state_health(ts.env, env0, trec[3]) | reward_health(trec[1])
        bad = mismatched_leaves(jax_leaves(js), port_leaves(ts), rtol)
        assert not bad, f"decision {d}: leaves differ: {bad}"
        for a, b in zip(jrec, trec):
            a, b = np.asarray(a), b[0].numpy()
            if a.dtype.kind == "f" and rtol:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-3)
            else:
                assert np.array_equal(a, b), (d, a, b)
        assert int(jhm) == int(thm[0]) == 0, (d, int(jhm), int(thm[0]))
        # the port's incremental caches equal their golden recomputations
        env = ts.env
        assert torch.equal(env.frontier, env.frontier_golden)
        assert torch.equal(env.stage_sat, env.stage_saturated)
        live = env.stage_exists & ~env.stage_completed
        assert torch.equal(torch.where(live, env.node_level, -1),
                           torch.where(live, env.node_level_golden, -1))
    return max_decisions


@pytest.mark.parametrize("seed", [0, 1, 5, 17])
def test_reset_equal_on_all_leaves(synthetic, seed):
    jp, jb, tp, tb = synthetic
    js = jfl.init_loop_state(jcore.reset(jp, jb, jax.random.PRNGKey(seed)))
    ts = flat_loop.init_loop_state(core.reset(tp, tb, prng.PRNGKey(seed)[None]))
    jl, tl = jax_leaves(js), port_leaves(ts)
    assert len(jl) == len(tl) == 61
    assert not mismatched_leaves(jl, tl, rtol=1e-6)


@pytest.mark.parametrize(
    "spec_fn,num_exec",
    [(spec_chain, 2), (spec_diamond, 4), (lambda: spec_multi_job(5, 7), 5)],
    ids=["chain", "diamond", "multi_job"],
)
def test_apply_and_drain_matches_jax_on_fixtures(spec_fn, num_exec):
    spec = spec_fn()
    jp, jb, jstate = make_tpu_env_state(spec, num_exec)
    tp, tb, ts = port_fixture_state(spec, num_exec)
    js = jfl.init_loop_state(jstate)
    assert not mismatched_leaves(jax_leaves(js), port_leaves(ts), rtol=0)
    n = _run(jp, jb, tp, tb, js, ts, 400, rtol=0)
    assert n <= -3  # the episode ran to its end


@pytest.mark.parametrize("seed", [0, 3])
def test_apply_and_drain_matches_jax_on_synthetic_bank(synthetic, seed):
    # no time limit: every episode runs the full 200 decisions
    jp, jb, tp, tb = synthetic
    jp = jp.replace(mean_time_limit=None)
    tp = tp.replace(mean_time_limit=None)
    js = jfl.init_loop_state(jcore.reset(jp, jb, jax.random.PRNGKey(seed)))
    ts = flat_loop.init_loop_state(core.reset(tp, tb, prng.PRNGKey(seed)[None]))
    assert _run(jp, jb, tp, tb, js, ts, 200, rtol=1e-6) == 200


def test_unknown_knobs_are_refused(synthetic):
    _, _, tp, tb = synthetic
    ts = flat_loop.init_loop_state(core.reset(tp, tb, prng.PRNGKey(0)[None]))
    one = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="bulk_width"):
        flat_loop.apply_and_drain(tp, tb, ts, one, one, prng.PRNGKey(0)[None],
                                  event_bulk=False, bulk_width=8)


def _fulfill_case(synthetic, bulk: bool) -> None:
    """Commit executors of the common pool to the first schedulable
    stages, then run the fulfillment phase in both packages."""
    jp, jb, tp, tb = synthetic
    for seed in (2, 4):
        js = jcore.reset(jp, jb, jax.random.PRNGKey(seed))
        ts = core.reset(tp, tb, prng.PRNGKey(seed)[None])
        sch = np.flatnonzero(np.asarray(js.schedulable).reshape(-1))[:2]
        for n_exec, flat in zip((3, 2), sch):
            j, s = int(flat) // jp.max_stages, int(flat) % jp.max_stages
            js = jcore._add_commitment(js, jnp.int32(n_exec), jnp.int32(j),
                                       jnp.int32(s))
            one = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
            ts = core._add_commitment(ts, one(n_exec), one(j), one(s),
                                      torch.tensor([True]))
        js = jcore._commit_remaining(js)
        ts = core._commit_remaining(ts, torch.tensor([True]))
        js = jcore._fulfill_from_source(jp, jb, js, jnp.bool_(True), bulk=bulk)
        ts = core._fulfill_from_source(tp, tb, ts, torch.tensor([True]),
                                       bulk=bulk)
        bad = mismatched_leaves(
            jax_leaves(jfl.init_loop_state(js)),
            port_leaves(flat_loop.init_loop_state(ts)), rtol=1e-6,
        )
        assert not bad, bad
        assert int(ts.exec_moving.sum()) == 5  # sent towards their stages


def test_fulfill_from_source_matches_jax(synthetic):
    """`core.step`'s fulfillment phase, one candidate at a time."""
    _fulfill_case(synthetic, bulk=False)


def test_fulfill_from_source_bulk_matches_jax(synthetic):
    """The same phase with its simple prefix in one `_bulk_fulfill`."""
    _fulfill_case(synthetic, bulk=True)
