"""The port's paged, grouped and stochastic session stores against the
JAX package's, at the small setup of tests/test_serve.py (5 executors,
6 jobs, embed 8, job_bucket 4, the weights scaled by 0.3 and carried
across by `params_from_flax`): integers and bools equal, floats within
rtol 1e-5 (atol 1e-6). The port against itself is bit-equal: a paged
store against an unpaged one, the page round trip on every leaf, the
pipelined window against `decide_batch`, a swap's in-flight call
against a store that never swapped, and `rollback_params`."""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.serve import SessionStore as JaxStore
from sparksched_tpu_torch.env.flat_loop import leaves, take_slot
from sparksched_tpu_torch.obs.memory import hot_set_fit
from sparksched_tpu_torch.serve import SessionQuarantined, SessionStore

from ._torch_parity import assert_same_result, serve_setup, slot_bytes
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup():
    return serve_setup()


def _port(setup, **kw) -> SessionStore:
    tp, tb, ts = setup[1]
    return SessionStore(tp, tb, ts, seed=0, device="cpu", **kw)


def _jax(setup, **kw) -> JaxStore:
    jp, jb, js = setup[0]
    return JaxStore(jp, jb, js, seed=0, **kw)


def _bare(r) -> dict:
    d = r.to_dict()
    d.pop("session_id")
    return d


def test_paged_store_matches_jax_and_unpaged(setup):
    """6 sessions over 3 slots: every decision of the port's paged store
    equals the JAX paged store's, and bit for bit the port's unpaged
    store's; the pager moves the same sessions (page counts equal)."""
    jst = _jax(setup, capacity=6, hot_capacity=3, max_batch=3)
    pst = _port(setup, capacity=6, hot_capacity=3, max_batch=3)
    ust = _port(setup, capacity=6, max_batch=3)
    sp = [pst.create(seed=600 + i) for i in range(6)]
    assert [jst.create(seed=600 + i) for i in range(6)] == sp
    su = [ust.create(seed=600 + i) for i in range(6)]
    assert pst.stats["serve_page_outs"] == jst.stats["serve_page_outs"] == 3
    for rnd in range(2):
        for i in range(6):
            rj, rp, ru = (s.decide(x[i]) for s, x in
                          ((jst, sp), (pst, sp), (ust, su)))
            assert_same_result(rj, rp)
            assert _bare(rp) == _bare(ru), (rnd, i)
    for rj, rp, ru in zip(jst.decide_batch(sp[:3]), pst.decide_batch(sp[:3]),
                          ust.decide_batch(su[:3])):
        assert_same_result(rj, rp)
        assert _bare(rp) == _bare(ru)
    for k in ("serve_page_ins", "serve_page_outs", "serve_sessions_hot",
              "serve_decisions", "serve_batch_calls"):
        assert pst.stats[k] == jst.stats[k], k
    assert set(pst.stats) == set(jst.stats)
    assert pst.stats["serve_sessions_hot"] == 3
    # maintained free lists: a closed id comes back LIFO; full rejects
    pst.close(sp[2])
    assert pst.create(seed=700) == sp[2]
    with pytest.raises(RuntimeError, match="store full"):
        pst.create()


def test_page_round_trip_bit_exact(setup):
    """page-out -> page-in gives back the slot bit for bit on every leaf
    of `LoopState`, at every dtype (a NaN leaf included)."""
    st = _port(setup, capacity=4, hot_capacity=2, max_batch=2)
    sids = [st.create(seed=40 + i) for i in range(2)]
    for _ in range(3):
        st.decide_batch(sids)  # mid-episode states, not fresh resets
    victim = sids[0]
    slot = int(st._slot_of[victim])
    st.store.env.job_t_completed[slot, -1] = float("nan")
    before = slot_bytes(st.store, slot)
    assert {d for _, d, _ in before} >= {"torch.int32", "torch.float32",
                                         "torch.bool"}
    st.create(seed=50)
    st.create(seed=51)  # the hot set is full: the LRU victim pages out
    assert not st.is_hot(victim)
    assert slot_bytes(st._cold[victim].host, 0) == before
    [back] = st._ensure_hot([victim])
    assert slot_bytes(st.store, back) == before
    assert st.stats["serve_page_ins"] == 1


@pytest.fixture(scope="module")
def jgroup(setup):
    return _jax(setup, capacity=6, groups=2, max_batch=3)


def test_grouped_dispatch_harvest_matches_jax_and_decide_batch(setup, jgroup):
    """Two groups in flight: the port's dispatch/harvest equals the JAX
    grouped store's, and bit for bit the port's own `decide_batch` on a
    twin store; cross-group batches are refused; the slot tensors stay
    the same storage across calls (the counterpart of donation)."""
    pipe = _port(setup, capacity=6, groups=2, max_batch=3)
    sync = _port(setup, capacity=6, groups=2, max_batch=3)
    pipe._calls = sync._calls = jgroup._calls  # the same key sequence
    ptrs = [[a.data_ptr() for _, a in leaves(g)] for g in pipe._stores]
    ps = [pipe.create(seed=900 + i) for i in range(6)]
    assert [jgroup.create(seed=900 + i) for i in range(6)] == ps
    assert [sync.create(seed=900 + i) for i in range(6)] == ps
    g0 = [s for s in ps if pipe.session_group(s) == 0]
    g1 = [s for s in ps if pipe.session_group(s) == 1]
    assert len(g0) == len(g1) == 3
    assert g0 == [s for s in ps if jgroup.session_group(s) == 0]
    with pytest.raises(ValueError, match="spans slot groups"):
        pipe.decide_batch([g0[0], g1[0]])
    for rnd in range(3):
        c0, c1 = pipe.dispatch_batch(g0), pipe.dispatch_batch(g1)
        j0, j1 = jgroup.dispatch_batch(g0), jgroup.dispatch_batch(g1)
        assert pipe.inflight == 2
        want = sync.decide_batch(g0) + sync.decide_batch(g1)
        done = pipe.harvest(wait=True)
        jgroup.harvest(wait=True)
        assert [c for c in done] == [c0, c1]
        got = c0.results + c1.results
        for a, b in zip(j0.results + j1.results, got):
            assert_same_result(a, b)
        assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert pipe.inflight == 0 and pipe.stats["serve_inflight_peak"] == 2
    assert pipe.wall_split["dispatch_s"] > 0.0
    assert pipe.wall_split["blocked_host_s"] > 0.0
    assert [[a.data_ptr() for _, a in leaves(g)]
            for g in pipe._stores] == ptrs
    for s in ps:
        jgroup.close(s)


def test_generation_guard_on_sid_reuse(setup):
    """A session closed and re-created while its call is in flight: the
    stale call's quarantining health mask is not applied to the
    replacement, which keeps serving."""
    st = _port(setup, capacity=4, groups=2, max_batch=2)
    sids = [st.create(seed=70 + i) for i in range(4)]
    bad = sids[0]
    g, local = divmod(int(st._slot_of[bad]), st.group_slots)
    st._stores[g].env.job_t_completed[local, 0] = float("nan")
    st.dispatch_batch([bad])
    st.close(bad)
    assert st.create(seed=80) == bad  # LIFO: the same sid, a new episode
    [done] = st.harvest(wait=True)
    assert done.results[0].health_mask != 0
    assert st.stats["serve_quarantines"] == 0
    assert st.decide(bad).health_mask == 0
    # the guard does not hide a current session's quarantine
    g, local = divmod(int(st._slot_of[bad]), st.group_slots)
    st._stores[g].env.job_t_completed[local, 0] = float("nan")
    st.dispatch_batch([bad])
    st.harvest(wait=True)
    assert st.stats["serve_quarantines"] == 1
    with pytest.raises(SessionQuarantined):
        st.decide(bad)


def test_set_params_in_flight_and_rollback(setup, jgroup):
    """dispatch, swap, harvest: the call dispatched before the swap keeps
    its version and equals a store that never swapped; the next call
    carries the new version and the new weights (as the JAX store
    does); `rollback_params` restores the last-good weights bit for
    bit."""
    st = _port(setup, capacity=6, groups=2, max_batch=3)
    twin = _port(setup, capacity=6, groups=2, max_batch=3)
    st._calls = twin._calls = jgroup._calls  # the same key sequence
    sids = [st.create(seed=970 + i) for i in range(6)]
    assert [twin.create(seed=970 + i) for i in range(6)] == sids
    jsids = [jgroup.create(seed=970 + i) for i in range(6)]
    g0 = [i for i, s in enumerate(sids) if st.session_group(s) == 0]
    g1 = [i for i, s in enumerate(sids) if st.session_group(s) == 1]
    assert g0 == [i for i, s in enumerate(jsids)
                  if jgroup.session_group(s) == 0]
    orig = {k: v.clone() for k, v in st.model_params.items()}
    new = {k: v * 1.01 for k, v in orig.items()}
    jnew = jax.tree_util.tree_map(lambda a: a * 1.01,
                                  jax.device_get(jgroup.model_params))
    # the stores share the scheduler, whose weights a swap changes in
    # place: the twin serves its call before the swap
    want = twin.decide_batch([sids[i] for i in g0])
    c_pre = st.dispatch_batch([sids[i] for i in g0])
    j_pre = jgroup.dispatch_batch([jsids[i] for i in g0])
    try:
        v1 = st.set_params(new)
        assert jgroup.set_params(jnew) == v1 == 1
        c_post = st.dispatch_batch([sids[i] for i in g1])
        j_post = jgroup.dispatch_batch([jsids[i] for i in g1])
        st.harvest(wait=True)
        jgroup.harvest(wait=True)
        assert {r.params_version for r in c_pre.results} == {0}
        assert {r.params_version for r in c_post.results} == {1}
        assert ([r.to_dict() for r in c_pre.results]
                == [r.to_dict() for r in want])
        for a, b in zip(j_pre.results + j_post.results,
                        c_pre.results + c_post.results):
            assert_same_result(a, b, same_sid=False)
        with pytest.raises(ValueError, match="do not match"):
            st.set_params({k: v[..., :1] for k, v in new.items()})
    finally:
        assert st.rollback_params(reason="test") == 0
        jgroup.rollback_params(reason="test")
    assert all(torch.equal(st.model_params[k], v) for k, v in orig.items())
    assert st.stats["serve_param_rollbacks"] == 1
    assert st.stats["serve_param_version"] == 0
    for s in jsids:
        jgroup.close(s)


def test_stochastic_store_matches_jax(setup):
    """`deterministic=False`: the single and batched paths sample with
    the call's policy key as the JAX store does (Gumbel noise may differ
    in its last ulp, ROADMAP queue C; the actions must not)."""
    jst = _jax(setup, capacity=4, max_batch=3, deterministic=False)
    pst = _port(setup, capacity=4, max_batch=3, deterministic=False)
    greedy = _port(setup, capacity=4, max_batch=3)
    sids = [pst.create(seed=20 + i) for i in range(4)]
    assert [jst.create(seed=20 + i) for i in range(4)] == sids
    assert [greedy.create(seed=20 + i) for i in range(4)] == sids
    differs = False
    for it in range(6):
        batch = sids[it % 2: it % 2 + 3]
        for a, b, c in zip(jst.decide_batch(batch), pst.decide_batch(batch),
                           greedy.decide_batch(batch)):
            assert_same_result(a, b)
            differs |= (b.stage_idx, b.num_exec) != (c.stage_idx, c.num_exec)
        assert_same_result(jst.decide(sids[3]), pst.decide(sids[3]))
        greedy.decide(sids[3])
    assert differs  # the draws are not the greedy choice


def test_hot_set_advice_monotone(setup):
    st = _port(setup, capacity=4, hot_capacity=2, max_batch=2)
    adv = st.hot_set_advice(budget_bytes=3_000_000)
    est = [c["est_bytes"] for c in adv["candidates"]]
    assert est == sorted(est) and len(set(est)) == len(est)
    one = take_slot(st.store, torch.tensor([0]))
    assert adv["slot_bytes"] == sum(a.nbytes for _, a in leaves(one))
    fit = [c["hot"] for c in adv["candidates"] if c["fits"]]
    assert adv["max_hot_fit"] == max(fit, default=0)
    assert all(c["fits"] == (c["est_bytes"] <= 3_000_000)
               for c in adv["candidates"])
    # the model: bytes(H) = fixed + H x slot bytes
    ref = hot_set_fit([a[0] for _, a in leaves(st.store)], (10, 20),
                      budget_bytes=10**9, fixed_bytes=7)
    assert [c["est_bytes"] for c in ref["candidates"]] == [
        7 + 10 * ref["slot_bytes"], 7 + 20 * ref["slot_bytes"]]
    prev = None
    for budget in (10**6, 10**7, 10**8):
        m = st.hot_set_advice(budget_bytes=budget)["max_hot_fit"]
        assert prev is None or m >= prev
        prev = m
    with pytest.raises(ValueError, match="budget_bytes"):
        st.hot_set_advice()
    assert math.isfinite(adv["slot_bytes"])
