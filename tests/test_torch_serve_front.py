"""The port's batching fronts against the JAX package's (the tests of
tests/test_serve.py on the fronts, mirrored), at its small setup (5
executors, 6 jobs, embed 8, job_bucket 4, the weights scaled by 0.3 and
carried across). A JAX store and a port store on the CPU run the same
operations side by side, so their session ids and keys agree: the same
submit sequence must form the same batches, and every ticket must
resolve alike (integers and bools equal, floats within rtol 1e-5, atol
1e-6). The pipelined front against the synchronous one is bit-equal."""

from __future__ import annotations

import math

import jax.numpy as jnp
import pytest

from sparksched_tpu.serve import ContinuousBatcher as JaxContinuous
from sparksched_tpu.serve import MicroBatcher as JaxMicro
from sparksched_tpu.serve import SessionStore as JaxStore
from sparksched_tpu.serve import front_from_config as jax_front
from sparksched_tpu.serve import store_from_config as jax_store_cfg
from sparksched_tpu_torch.obs.metrics import MetricsRegistry
from sparksched_tpu_torch.serve import (
    ContinuousBatcher,
    MicroBatcher,
    SessionError,
    SessionQuarantined,
    SessionStore,
    front_from_config,
    store_from_config,
)

from ._torch_parity import assert_same_result, serve_setup
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup():
    return serve_setup()


@pytest.fixture(scope="module")
def pair(setup):
    """(JAX store, port store): capacity 6, max_batch 3, seed 0."""
    (jp, jb, js), (tp, tb, ts) = setup
    return (JaxStore(jp, jb, js, capacity=6, max_batch=3, seed=0),
            SessionStore(tp, tb, ts, capacity=6, max_batch=3, seed=0,
                         device="cpu"))


def _record(store) -> list:
    """Log every batch the store serves (`decide_batch`, `dispatch_batch`
    and the single-session fallback) as (kind, sids)."""
    log = []
    for name in ("decide_batch", "dispatch_batch", "decide"):
        fn = getattr(store, name)

        def wrapped(arg, _fn=fn, _name=name):
            log.append((_name, list(arg) if isinstance(arg, list) else arg))
            return _fn(arg)

        setattr(store, name, wrapped)
    return log


def _unrecord(store) -> None:
    for name in ("decide_batch", "dispatch_batch", "decide"):
        vars(store).pop(name, None)


def _both(pair, fn):
    """Run `fn(store, front_classes)` on the JAX store and on the port's;
    returns (jax value, port value)."""
    jst, pst = pair
    return (fn(jst, (JaxContinuous, JaxMicro)),
            fn(pst, (ContinuousBatcher, MicroBatcher)))


def _same_tickets(jt, pt) -> None:
    assert len(jt) == len(pt)
    for a, b in zip(jt, pt):
        assert a.ready and b.ready
        assert type(a.error).__name__ == type(b.error).__name__
        if a.error is None:
            assert_same_result(a.result, b.result)


def test_continuous_batcher_forms_jax_batches(pair):
    """One tenant floods, others arrive: the same submit sequence forms
    the same batches and results as JAX's, and a newly backlogged tenant
    is admitted on the first pump after its submit (the ceil(S/K)
    bound); the flood resolves in FIFO order."""

    def run(store, cls):
        log = _record(store)
        a, b, c, d = (store.create(seed=500 + i) for i in range(4))
        cb = cls[0](store)
        ta = [cb.submit(a) for _ in range(4)]
        assert not any(t.ready for t in ta)
        tb, tc = cb.submit(b), cb.submit(c)  # K distinct: size dispatch
        assert ta[0].ready and tb.ready and tc.ready and not ta[1].ready
        td = cb.submit(d)
        assert cb.pump()
        assert td.ready and td.error is None and ta[1].ready
        cb.flush()
        walls = [t.result.wall_time for t in ta]
        assert walls == sorted(walls)
        for s in (a, b, c, d):
            store.close(s)
        _unrecord(store)
        return log, ta + [tb, tc, td]

    (jlog, jt), (plog, pt) = _both(pair, run)
    assert plog == jlog and len(plog) >= 3
    _same_tickets(jt, pt)


def test_quarantine_eviction_midstream_matches_jax(pair):
    """A decision trips the sentinel mid-stream: the session's queued
    followers fail at once with `SessionQuarantined`, a co-queued tenant
    is served, a later submit fails at dispatch, and a closed session's
    backlog fails with `SessionError`, as in the JAX front."""

    def run(store, cls):
        bad, good = store.create(seed=510), store.create(seed=511)
        if isinstance(store, JaxStore):
            env = store._store.env
            store._store = store._store.replace(env=env.replace(
                job_t_completed=env.job_t_completed.at[bad].set(jnp.nan)))
        else:
            store.store.env.job_t_completed[bad] = float("nan")
        cb = cls[0](store)
        t1, t2, tg = cb.submit(bad), cb.submit(bad), cb.submit(good)
        assert cb.pump()
        assert t1.result.health_mask != 0
        assert t2.ready and t2.error is not None
        assert tg.ready and tg.error is None and cb.pending == 0
        t3 = cb.submit(bad)
        cb.flush()
        store.close(bad)
        gone = [cb.submit(good) for _ in range(3)]
        store.close(good)
        assert cb.pump() and cb.pending == 0
        return [t1, t2, tg, t3] + gone

    jt, pt = _both(pair, run)
    _same_tickets(jt, pt)
    assert isinstance(pt[1].error, SessionQuarantined)
    assert isinstance(pt[3].error, SessionQuarantined)
    assert all(isinstance(t.error, SessionError) for t in pt[4:])


def test_micro_batcher_full_batch_and_linger(pair):
    def run(store, cls):
        sids = [store.create(seed=90 + i) for i in range(3)]
        mb = cls[1](store, linger_ms=1e6)
        t1, t2 = mb.submit(sids[0]), mb.submit(sids[1])
        assert not t1.ready and not t2.ready
        t3 = mb.submit(sids[2])  # max_batch: immediate flush
        assert t1.ready and t2.ready and t3.ready and t1.result.batched
        mb = cls[1](store, linger_ms=0.0)
        tk = mb.submit(sids[0])
        assert not tk.ready and mb.poll()
        assert tk.ready and not tk.result.batched  # lone: single path
        for s in sids:
            store.close(s)
        return [t1, t2, t3, tk]

    _same_tickets(*_both(pair, run))


def test_micro_batcher_duplicates_and_failures_resolve_every_ticket(pair):
    """Duplicate ids ride successive batch calls; a failing batch is
    re-served one by one so only the offenders fail (quarantined,
    closed); no ticket is left unresolved. Metrics count the flush
    reasons and occupancy as JAX's do."""

    def run(store, cls):
        a, b, c = (store.create(seed=300 + i) for i in range(3))
        calls0 = store.stats["serve_batch_calls"]
        mb = cls[1](store, linger_ms=1e6)
        dup = [mb.submit(a), mb.submit(b), mb.submit(a)]
        assert all(t.ready and t.error is None for t in dup)
        assert store.stats["serve_batch_calls"] == calls0 + 1
        assert not dup[2].result.batched
        if isinstance(store, JaxStore):
            env = store._store.env
            store._store = store._store.replace(env=env.replace(
                job_t_completed=env.job_t_completed.at[b].set(jnp.nan)))
        else:
            store.store.env.job_t_completed[b] = float("nan")
        assert store.decide(b).health_mask != 0
        store.close(c)
        reg = MetricsRegistry()
        mb = cls[1](store, linger_ms=1e6, metrics=reg)
        fail = [mb.submit(a), mb.submit(b), mb.submit(c)]
        assert not mb.pending
        assert fail[0].error is None and not fail[0].result.batched
        store.close(a)
        store.close(b)
        return dup + fail, reg.counters, reg.hists["serve_batch_occupancy"]

    (jt, jc, jh), (pt, pc, ph) = _both(pair, run)
    _same_tickets(jt, pt)
    assert isinstance(pt[4].error, SessionQuarantined)
    assert isinstance(pt[5].error, SessionError)
    assert pc == jc == {"serve_flush_size": 1, "serve_requests_total": 3,
                        "serve_request_errors": 2}
    assert (ph.count, ph.max) == (jh.count, jh.max)


def _grouped_paged(setup, port: bool, depth: int):
    (jp, jb, js), (tp, tb, ts) = setup
    kw = dict(capacity=8, hot_capacity=4, groups=2, max_batch=2, seed=0)
    if port:
        return SessionStore(tp, tb, ts, device="cpu", **kw)
    return JaxStore(jp, jb, js, **kw)


def _prefetch_run(store, cls, depth: int):
    """tests/test_serve.py's prefetch scenario: 8 sessions over 4 slots
    in 2 groups, one slot freed per group, 3 requests per session
    queued before any pump."""
    log = _record(store)
    sids = [store.create(seed=1300 + i) for i in range(8)]
    for g in (0, 1):
        victim = next(s for s in sids
                      if store.is_hot(s) and store.session_group(s) == g)
        store.close(victim)
        sids.remove(victim)
    front = cls(store, depth=depth, prefetch=True)
    k = store.max_batch
    store.max_batch = 10 ** 6  # no size dispatch while queueing
    tickets = [front.submit(s) for _ in range(3) for s in sids]
    store.max_batch = k
    while front.pending or store.inflight:
        front.flush()
    _unrecord(store)
    return log, tickets


def test_pipelined_front_matches_jax_and_synchronous(setup):
    """The pipelined front (depth 2, prefetch) over a paged 2-group store
    forms the JAX pipelined front's batches with its results and
    prefetches as often; replaying its admission sequence through the
    synchronous `decide_batch` on a twin store gives the same decisions
    bit for bit."""
    jst = _grouped_paged(setup, False, 2)
    pst = _grouped_paged(setup, True, 2)
    twin = _grouped_paged(setup, True, 1)
    jlog, jt = _prefetch_run(jst, JaxContinuous, 2)
    plog, pt = _prefetch_run(pst, ContinuousBatcher, 2)
    assert plog == jlog
    _same_tickets(jt, pt)
    assert pst.stats["serve_prefetches"] == jst.stats["serve_prefetches"] > 0
    assert all(t.error is None for t in pt)
    sids = [twin.create(seed=1300 + i) for i in range(8)]
    for g in (0, 1):
        twin.close(next(s for s in sids if twin.is_hot(s)
                        and twin.session_group(s) == g))
    replay = [r for _, batch in plog for r in twin.decide_batch(batch)]
    by_sid: dict[int, list] = {}
    for r in replay:
        by_sid.setdefault(r.session_id, []).append(r.to_dict())
    got: dict[int, list] = {}
    for t in pt:
        got.setdefault(t.session_id, []).append(t.result.to_dict())
    assert got == by_sid


def test_pipelined_front_equals_synchronous_front(setup):
    """tests/test_serve.py's acceptance pin: depth 2 over an unpaged
    2-group store resolves every ticket bit-equal to the synchronous
    front (depth 1) under the same submission order."""
    tp, tb, ts = setup[1]
    arms = {}
    for depth in (1, 2):
        st = SessionStore(tp, tb, ts, capacity=6, groups=2, max_batch=3,
                          seed=0, device="cpu")
        front = ContinuousBatcher(st, depth=depth, prefetch=True)
        assert front.front_name == ("pipelined" if depth > 1
                                    else "continuous")
        sids = [st.create(seed=950 + i) for i in range(6)]
        tickets = [front.submit(s) for _ in range(3) for s in sids]
        while front.pending or st.inflight:
            front.flush()
        assert all(t.ready and t.error is None for t in tickets)
        arms[depth] = [t.result.to_dict() for t in tickets]
    assert arms[1] == arms[2]


def test_starvation_bound_under_skip_exhaustion(setup):
    """6 backlogged sessions over 4 slots at width 2, hot preference on:
    every queue head is admitted within ceil(S/K) + max_skips pumps, and
    `serve_page_churn` counts exactly the page-ins the cold admissions
    cost."""
    tp, tb, ts = setup[1]
    store = SessionStore(tp, tb, ts, capacity=12, hot_capacity=4,
                         max_batch=2, seed=0, device="cpu")
    S, R, max_skips = 6, 6, 2
    bound = math.ceil(S / store.max_batch) + max_skips
    sids = [store.create(seed=1200 + i) for i in range(S)]
    reg = MetricsRegistry()
    front = ContinuousBatcher(store, pager_aware=True, max_skips=max_skips,
                              metrics=reg)
    store.max_batch = 10 ** 6
    tickets = {s: [front.submit(s) for _ in range(R)] for s in sids}
    store.max_batch = 2
    ins0 = store.stats["serve_page_ins"]
    resolved_at: dict[int, list[int]] = {s: [] for s in sids}
    pumps = 0
    while front.pending:
        assert front.pump(reason="occupancy")
        pumps += 1
        assert pumps < S * R + 10
        for s in sids:
            n_ready = sum(t.ready for t in tickets[s])
            resolved_at[s] += [pumps] * (n_ready - len(resolved_at[s]))
    for s in sids:
        assert all(t.ready and t.error is None for t in tickets[s])
        prev = 0
        for p in resolved_at[s]:
            assert p - prev <= bound, (s, p - prev, bound)
            prev = p
    churn = int(reg.counters.get("serve_page_churn", 0))
    assert churn > 0
    assert store.stats["serve_page_ins"] - ins0 == churn


def _err(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_config_errors_match_jax(setup, pair):
    (jp, jb, js), (tp, tb, ts) = setup
    jst, pst = pair
    assert (_err(lambda: store_from_config({"capcity": 4}, tp, tb, ts,
                                           device="cpu"))
            == _err(lambda: jax_store_cfg({"capcity": 4}, jp, jb, js)))
    for cfg in ({"front": "warp"}, {"front": "pipelined", "depth": 1},
                {"front": "continuous", "depth": 2},
                {"front": "linger", "prefetch": True},
                {"attribution": True}):
        assert _err(lambda: front_from_config(cfg, pst)) == _err(
            lambda: jax_front(cfg, jst)), cfg
    for cfg, name in (({}, "continuous"), ({"front": "linger"}, "linger"),
                      ({"front": "pipelined"}, "pipelined")):
        pf, jf = front_from_config(cfg, pst), jax_front(cfg, jst)
        assert pf.front_name == jf.front_name == name
        assert getattr(pf, "depth", 1) == getattr(jf, "depth", 1)
    traced = front_from_config({"trace": True}, pst)
    jtraced = jax_front({"trace": True}, jst)
    assert traced.critpath is not None and jtraced.critpath is not None
    assert traced.trace == jtraced.trace


@pytest.mark.parametrize("knob", [
    {"shard_dp": 2}, {"shard_dp": "auto", "record": True},
    {"donate": False, "record": True, "ring": 8},
    {"shard_dp": 2, "ring": 8, "record": True}, {"donate": False},
])
def test_unported_store_knobs_raise(setup, knob):
    """A store knob still unported raises, naming it, also beside the
    record path's knobs (which build: tests/test_torch_serve_ring.py)."""
    tp, tb, ts = setup[1]
    key = next(iter(knob))
    with pytest.raises(NotImplementedError, match=f"serve: {key}.*not ported"):
        store_from_config({"capacity": 2, "max_batch": 2, **knob}, tp, tb,
                          ts, device="cpu")


def test_store_from_config_builds_the_documented_block(setup):
    """The config's documented `serve:` block at the small setup's
    capacity: paged, 2 groups, metrics on; the pipelined front."""
    tp, tb, ts = setup[1]
    cfg = {"capacity": 8, "max_batch": 2, "front": "pipelined",
           "hot_capacity": 4, "groups": 2, "depth": 2, "harvester": False,
           "prefetch": True, "pager_aware": True, "deterministic": True,
           "donate": True, "seed": 0, "metrics": True, "trace": False}
    st = store_from_config(cfg, tp, tb, ts, device="cpu")
    fr = front_from_config(cfg, st)
    assert (st.capacity, st.hot_capacity, st.groups, st.group_slots) == (
        8, 4, 2, 2)
    assert isinstance(st.metrics, MetricsRegistry)
    assert fr.front_name == "pipelined" and fr.depth == 2 and fr.prefetch
    sid = st.create(seed=1)
    tk = fr.submit(sid)
    fr.flush()
    assert tk.ready and tk.error is None and tk.result.decided
