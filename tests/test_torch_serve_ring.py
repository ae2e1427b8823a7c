"""The port's device trajectory ring against the JAX package's (the tests
of tests/test_serve_ring.py, mirrored, its slow parity pin included at
tier-1 size): `ring_append` (scalar mask, batch mask, the wrap), the
store's ring configuration errors, `TrajectoryBuffer.ingest_chunk`
replaying `add()` on the same synthetic stream as JAX's buffer, a port
ring store's drained chunks and close events against a JAX ring store's
under the same operations (ring wrap, two slot groups, a mid-stream
quarantine, a swap mid-ring), and the port's ring path against its own
per-decision record path, trajectory for trajectory, plus the overrun
accounting. Sizes: tests/test_serve.py's small setup (5 executors, 6
jobs, embed 8, job_bucket 4, the weights scaled by 0.3 and carried
across)."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.env.flat_loop import TrajRing as JaxRing
from sparksched_tpu.env.flat_loop import ring_append as jax_ring_append
from sparksched_tpu.online import TrajectoryBuffer as JaxBuffer
from sparksched_tpu.serve import SessionStore as JaxStore
from sparksched_tpu.serve.aot import RingRec as JaxRingRec
from sparksched_tpu_torch.config import SERVE_KEYS
from sparksched_tpu_torch.env.flat_loop import make_ring, ring_append
from sparksched_tpu_torch.online import TrajectoryBuffer
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.serve import SessionStore, store_from_config
from sparksched_tpu_torch.serve.aot import RingRec

from ._torch_parity import serve_setup
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

REC_FIELDS = ("sid", "seq", "params_version", "stage_idx", "job_idx",
              "num_exec", "lgprob", "reward", "dt", "wall_time", "done",
              "health_mask")
# the served floats: XLA and torch evaluate the policy's log-softmax and
# the engine's clock arithmetic in other orders, so these agree to the
# serve tests' rtol 1e-5 / atol 1e-6, not always to the last bit
FLOAT_FIELDS = ("lgprob", "reward", "dt", "wall_time")
OBS_FIELDS = ("remaining", "duration", "schedulable", "node_mask",
              "job_mask", "job_template", "exec_supplies",
              "num_committable", "source_job")


@pytest.fixture(scope="module")
def setup():
    return serve_setup()


# ---------------------------------------------------------------------------
# ring_append
# ---------------------------------------------------------------------------


def _appends(case: str):
    """(R, [(record dict of numpy, mask)]) for one append sequence."""
    if case == "scalar_wrap":
        seq = [({"a": np.int32(k + 1),
                 "b": np.full((2,), k + 1, np.float32)}, np.bool_(True))
               for k in range(5)]
        seq.append(({"a": np.int32(99), "b": np.zeros(2, np.float32)},
                    np.bool_(False)))
        return 3, seq
    rng = np.random.default_rng(7 if case == "batch" else 11)
    seq = []
    for k in range(4 if case == "batch" else 9):
        recs = {"a": rng.integers(0, 1000, 4).astype(np.int32),
                "b": rng.normal(size=(4, 2)).astype(np.float32)}
        seq.append((recs, rng.random(4) < 0.6))
    return 8 if case == "batch" else 5, seq


@pytest.mark.parametrize("case", ["scalar_wrap", "batch", "batch_wrap"])
def test_ring_append_matches_jax(case):
    """The same masked appends into a JAX ring and a port ring: the
    cursor and every record row bit-equal (the wrap included; the port's
    sink row R is not part of the ring)."""
    R, seq = _appends(case)
    jr = JaxRing(cursor=jnp.int32(0),
                 rec={"a": jnp.zeros((R,), jnp.int32),
                      "b": jnp.zeros((R, 2), jnp.float32)})
    pr = make_ring(R, {"a": torch.zeros((), dtype=torch.int32),
                       "b": torch.zeros(2)})
    for recs, mask in seq:
        jr = jax_ring_append(jr, jax.tree_util.tree_map(jnp.asarray, recs),
                             jnp.asarray(mask))
        out = ring_append(pr, {k: torch.from_numpy(np.asarray(v))
                               for k, v in recs.items()},
                          torch.from_numpy(np.asarray(mask)))
        assert out is pr  # in place
        assert int(pr.cursor) == int(jr.cursor)
    assert int(jr.cursor) > R or case == "batch"
    for k in ("a", "b"):
        np.testing.assert_array_equal(pr.rec[k][:R].numpy(),
                                      np.asarray(jr.rec[k]))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(max_batch=2, ring=8), "requires record=True"),
    (dict(max_batch=3, record=True, ring=2), "must be >= max_batch"),
    (dict(max_batch=2, record=True, ring_drain=4), "ring_drain requires ring"),
    (dict(max_batch=2, record=True, ring=4, ring_drain=9), "ring_drain"),
])
def test_ring_config_validation_matches_jax(setup, kw, match):
    """The JAX package's four ring configuration errors, raised by both
    stores before anything is built."""
    (jp, jb, js), (tp, tb, ts) = setup
    with pytest.raises(ValueError, match=match):
        JaxStore(jp, jb, js, capacity=4, **kw)
    with pytest.raises(ValueError, match=match):
        SessionStore(tp, tb, ts, capacity=4, device="cpu", **kw)
    assert {"record", "ring", "ring_drain"} <= set(SERVE_KEYS)


def test_ring_default_cadence(setup):
    """The default cadence max(1, min(R // 2, R - K + 1)), as in JAX."""
    (_, _, _), (tp, tb, ts) = setup
    for ring, k, want in ((32, 8, 16), (8, 3, 4), (3, 3, 1), (9, 8, 2)):
        st = SessionStore(tp, tb, ts, capacity=8, max_batch=k, record=True,
                          ring=ring, device="cpu")
        assert st.ring_drain == want, (ring, k, st.ring_drain)


# ---------------------------------------------------------------------------
# ingest_chunk == n x add(), against the JAX buffer
# ---------------------------------------------------------------------------


class _Rec:
    """One synthetic served decision, as an `add()` result and as a row
    of a drained chunk (test_serve_ring.py's)."""

    def __init__(self, sid, seq, k, *, done=False, health=0, version=0):
        self.session_id = sid
        self.seq = seq
        self.stage_idx = k
        self.job_idx = k % 3
        self.num_exec = 2 + (k % 2)
        self.lgprob = -0.25 * (k + 1)
        self.reward = -float(k)
        self.dt = 1.5
        self.wall_time = float(10 * seq + sid)
        self.done = done
        self.decided = True
        self.health_mask = health
        self.params_version = version
        self.obs = {"x": np.full((2, 3), 100 * sid + seq, np.float32)}


def _chunk_of(cls, recs: list[_Rec]):
    f = {
        "sid": np.asarray([r.session_id for r in recs], np.int32),
        "seq": np.asarray([r.seq for r in recs], np.int32),
        "params_version": np.asarray([r.params_version for r in recs],
                                     np.int32),
        "stage_idx": np.asarray([r.stage_idx for r in recs], np.int32),
        "job_idx": np.asarray([r.job_idx for r in recs], np.int32),
        "num_exec": np.asarray([r.num_exec for r in recs], np.int32),
        "lgprob": np.asarray([r.lgprob for r in recs], np.float32),
        "reward": np.asarray([r.reward for r in recs], np.float32),
        "dt": np.asarray([r.dt for r in recs], np.float32),
        "wall_time": np.asarray([r.wall_time for r in recs], np.float32),
        "done": np.asarray([r.done for r in recs], bool),
        "health_mask": np.asarray([r.health_mask for r in recs], np.int32),
    }
    obs = {"x": (np.stack([r.obs["x"] for r in recs]) if recs
                 else np.zeros((0, 2, 3), np.float32))}
    return cls(**f, obs=obs)


def _obs_leaves(obs) -> list[np.ndarray]:
    if isinstance(obs, dict):
        return [np.asarray(obs[k]) for k in sorted(obs)]
    return [np.asarray(getattr(obs, f)) for f in OBS_FIELDS]


def assert_traj_equal(a, b) -> None:
    """Two trajectories (either package's) equal bit for bit."""
    assert a.session_id == b.session_id
    assert a.length == b.length and a.done == b.done
    for f in ("stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
              "wall_times", "params_version"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    la, lb = _obs_leaves(a.obs), _obs_leaves(b.obs)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def drain_sorted(buf):
    return sorted(buf.drain(10 ** 6),
                  key=lambda t: (t.session_id, t.wall_times[0]))


STREAM = [
    _Rec(1, 1, 0), _Rec(2, 1, 0), _Rec(1, 2, 1),
    _Rec(2, 2, 1, version=1), _Rec(1, 3, 2, done=True),
    # session 3 trips the sentinel mid-episode: dropped
    _Rec(3, 1, 0), _Rec(3, 2, 1, health=4),
    # session 2 runs into the max_steps=3 segment cut
    _Rec(2, 3, 2, version=1), _Rec(2, 4, 3, version=1),
]


def test_ingest_chunk_replays_add_like_jax():
    """The synthetic stream through add() and through two chunks, into
    the port's buffers and JAX's: the four assemble the same
    trajectories and counters."""
    bufs = {}
    for name, cls, rec_cls in (("jax", JaxBuffer, JaxRingRec),
                               ("port", TrajectoryBuffer, RingRec)):
        a = cls(capacity=16, max_steps=3, min_decisions=1)
        b = cls(capacity=16, max_steps=3, min_decisions=1)
        for r in STREAM:
            a.add(r)
        b.ingest_chunk(_chunk_of(rec_cls, STREAM[:4]))
        b.ingest_chunk(_chunk_of(rec_cls, STREAM[4:]))
        a.on_close(2)
        b.on_close(2)
        assert a.stats == b.stats
        bufs[name] = (a, b)
    assert bufs["jax"][0].stats == bufs["port"][0].stats
    assert bufs["port"][0].stats["online_dropped_quarantined"] == 1
    trajs = [drain_sorted(b) for pair in bufs.values() for b in pair]
    assert all(len(t) == 3 for t in trajs)
    for other in trajs[1:]:
        for x, y in zip(trajs[0], other):
            assert_traj_equal(x, y)


def test_ingest_chunk_seq_gap_drops_open_episode():
    """A per-session seq hole (an overrun ate records) drops the
    corrupted open episode and restarts after it, as JAX's buffer
    does."""
    out = []
    for cls, rec_cls in ((JaxBuffer, JaxRingRec),
                         (TrajectoryBuffer, RingRec)):
        buf = cls(capacity=8, max_steps=8, min_decisions=1)
        buf.ingest_chunk(_chunk_of(rec_cls, [_Rec(7, 1, 0), _Rec(7, 2, 1)]))
        buf.ingest_chunk(_chunk_of(rec_cls, [_Rec(7, 5, 4),
                                             _Rec(7, 6, 5, done=True)]))
        assert buf.stats["online_dropped_gap"] == 1
        [tr] = buf.drain(4)
        assert tr.length == 2 and tr.done
        np.testing.assert_array_equal(tr.stage_idx, [4, 5])
        buf.ingest_chunk(_chunk_of(rec_cls, []))
        assert buf.stats["online_decisions"] == 4
        out.append((buf.stats, tr))
    assert out[0][0] == out[1][0]
    assert_traj_equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# ring stores
# ---------------------------------------------------------------------------


class _Log:
    """A collector that logs what reaches it, in order."""

    def __init__(self) -> None:
        self.events: list = []

    def add(self, res) -> None:
        self.events.append(("add", res))

    def ingest_chunk(self, chunk) -> None:
        self.events.append(("chunk", chunk))

    def on_close(self, sid: int, quarantined: bool = False) -> None:
        self.events.append(("close", int(sid), bool(quarantined)))


def _poison(store, sid: int) -> None:
    """NaN one session's per-job completion clock (tests/test_serve.py's
    poison): its next decision trips the health sentinel."""
    g, local = divmod(int(store._slot_of[sid]), store.group_slots)
    if isinstance(store, JaxStore):
        st = store._stores[g]
        store._stores[g] = st.replace(env=st.env.replace(
            job_t_completed=st.env.job_t_completed.at[local].set(jnp.nan)))
    else:
        store._stores[g].env.job_t_completed[local] = float("nan")


def _bumped(js):
    """The JAX weights x1.01 as numpy, and the same bits for the port."""
    jw = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(1.01),
                                jax.device_get(js.params))
    return jw, params_from_flax(jw)


def _drive(store, swap, rounds: int = 10) -> list:
    """The parity pin's operations on one store: 4 sessions over 2
    groups, batched decides per group (a single decide when a group has
    one session), rotation on episode end or quarantine, a poisoned
    session in round 3 and a swap to version 9 in round 5; every
    session closed at the end and the ring drained. Returns the
    decisions as dicts."""
    got = []
    sids = [store.create(seed=500 + i) for i in range(4)]
    fresh = [600]

    def rotate(j):
        store.close(sids[j])
        sids[j] = store.create(seed=fresh[0])
        fresh[0] += 1

    for rnd in range(rounds):
        if rnd == 3:
            _poison(store, sids[1])
            r = store.decide(sids[1])
            assert r.health_mask != 0
            got.append(r.to_dict())
            rotate(1)
        if rnd == 5:
            assert store.set_params(swap, version=9) == 9
        for g in (0, 1):
            gsids = [s for s in sids if store.session_group(s) == g]
            rs = (store.decide_batch(gsids) if len(gsids) > 1 else
                  [store.decide(s) for s in gsids])
            for r in rs:
                got.append(r.to_dict())
                if r.done or r.health_mask:
                    rotate(sids.index(r.session_id))
    for s in sids:
        store.close(s)
    store.drain_ring(wait=True)
    return got


@pytest.fixture(scope="module")
def jax_ring_run(setup):
    """The operations through a JAX ring store (ring 8, cadence 4, two
    groups): (decisions, collector events, store stats)."""
    (jp, jb, js), _ = setup
    log = _Log()
    st = JaxStore(jp, jb, js, capacity=6, max_batch=3, groups=2, seed=0,
                  record=True, ring=8, ring_drain=4, collector=log)
    got = _drive(st, _bumped(js)[0])
    return got, log.events, dict(st.stats)


def _port_store(setup, **kw):
    """A port store on its own copy of the scheduler: a swap through one
    store must not move another's weights."""
    (_, _, _), (tp, tb, ts) = setup
    return SessionStore(tp, tb, copy.deepcopy(ts), capacity=6, max_batch=3,
                        groups=2, seed=0, device="cpu", **kw)


def test_ring_store_chunks_match_jax(setup, jax_ring_run):
    """The same operations through a port ring store: the decisions
    agree with the JAX store's (integers equal, floats within rtol
    1e-5), the drains cut the same chunks with the same records (every
    stamp, integer, bool and StoredObs field bit-equal; the served
    floats within rtol 1e-5), the same close events come out, and the
    ring counters equal (it wrapped, nothing was dropped). Chunks and
    closes are matched as sets: the JAX store ingests each group's
    queue as its asynchronous copies land, so its order across groups
    follows the host's timing."""
    (_, _, js), _ = setup
    want, jev, jstats = jax_ring_run
    log = _Log()
    st = _port_store(setup, record=True, ring=8, ring_drain=4,
                     collector=log)
    got = _drive(st, _bumped(js)[1])
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for k, v in a.items():
            if isinstance(v, float):
                np.testing.assert_allclose(b[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=k)
            else:
                assert b[k] == v, (k, a, b)

    def stamps(c):
        return [(int(c.sid[i]), int(c.seq[i]), int(c.params_version[i]))
                for i in range(len(c.sid))]

    closes = [sorted(e for e in ev if e[0] == "close")
              for ev in (log.events, jev)]
    assert closes[0] == closes[1] and closes[0]
    pcs, jcs = ([e[1] for e in ev if e[0] == "chunk"]
                for ev in (log.events, jev))
    assert len(pcs) == len(jcs)
    n_rec = 0
    for pc, jc in zip(sorted(pcs, key=stamps), sorted(jcs, key=stamps)):
        for f in REC_FIELDS:
            a, b = np.asarray(getattr(jc, f)), getattr(pc, f)
            assert a.dtype == b.dtype, f
            if f in FLOAT_FIELDS:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(b, a, f)
        for f in OBS_FIELDS:
            a, b = np.asarray(getattr(jc.obs, f)), getattr(pc.obs, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, f)
        n_rec += len(pc.sid)
    for k in ("serve_ring_drains", "serve_ring_records",
              "serve_ring_dropped", "serve_quarantines"):
        assert st.stats[k] == jstats[k], k
    assert n_rec == st.stats["serve_ring_records"] > 2 * st.ring_size
    assert st.stats["serve_ring_dropped"] == 0
    assert {e[2] for e in log.events if e[0] == "close"} == {False, True}


def test_ring_trajectories_equal_per_decision_path(setup):
    """The port's ring path against its own per-decision record path
    (the JAX package's slow parity pin, at tier-1 size): bit-identical
    trajectories and equal buffer counters across the ring's wrap, the
    groups, a mid-stream quarantine and a swap mid-ring; the ring
    results carry no record, every other field equal."""
    (_, _, js), _ = setup
    swap = _bumped(js)[1]
    bufs, runs = [], []
    for kw in ({}, {"ring": 8, "ring_drain": 4}):
        buf = TrajectoryBuffer(capacity=64, max_steps=6, min_decisions=1)
        st = _port_store(setup, record=True, collector=buf, **kw)
        runs.append(_drive(st, swap))
        bufs.append(buf)
    np.testing.assert_equal(runs[0], runs[1])  # NaN == NaN (the poison)
    assert bufs[0].stats == bufs[1].stats
    assert bufs[0].stats["online_dropped_quarantined"] >= 1
    ta, tb = drain_sorted(bufs[0]), drain_sorted(bufs[1])
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert_traj_equal(x, y)
    versions = {int(v) for t in ta for v in t.params_version}
    assert {0, 9} <= versions


def test_ring_pipelined_window_matches_synchronous(setup):
    """Ring records of calls dispatched through the in-flight window
    (`dispatch_batch` + `harvest`) equal the synchronous store's: the
    append happens at dispatch, the drain at the idle harvest."""
    logs = []
    for pipelined in (False, True):
        log = _Log()
        st = _port_store(setup, record=True, ring=8, ring_drain=4,
                         collector=log)
        sids = [st.create(seed=900 + i) for i in range(4)]
        for _ in range(3):
            groups = [[s for s in sids if st.session_group(s) == g]
                      for g in (0, 1)]
            if pipelined:
                for b in groups:
                    st.dispatch_batch(b)
                st.harvest(wait=True)
            else:
                for b in groups:
                    st.decide_batch(b)
                st.drain_ring(wait=True)
        for s in sids:
            st.close(s)
        st.drain_ring(wait=True)
        recs = [(int(c.sid[i]), int(c.seq[i]), float(c.wall_time[i]))
                for kind, c, *_ in log.events if kind == "chunk"
                for i in range(len(c.sid))]
        logs.append(sorted(recs))
    assert logs[0] == logs[1] and len(logs[0]) == 4 * 3


def test_close_reaches_collector_before_a_reused_sids_records(
        setup, monkeypatch):
    """A session in group 1 closes while its group's snapshot has not
    landed; its id is reused at once by a session in group 0, whose
    records are snapshotted and land first. The collector must still
    see the closed session's records, then its close, then the new
    session's records (the JAX store's per-group queues would hand over
    group 0's chunk first)."""
    from sparksched_tpu_torch.serve import aot, session

    held = []

    class Snapshot(aot.RingSnapshot):
        __slots__ = ("hold",)

        def __init__(self, ring):
            super().__init__(ring)
            self.hold = not held
            held.append(self)

        def ready(self):
            return not self.hold

    monkeypatch.setattr(session, "RingSnapshot", Snapshot)
    log = _Log()
    st = SessionStore(*setup[1], capacity=6, max_batch=2, groups=2, seed=0,
                      record=True, ring=4, collector=log, device="cpu")
    sids = [st.create(seed=40 + i) for i in range(5)]
    assert [st.session_group(s) for s in sids] == [0, 1, 0, 1, 0]
    st.decide(sids[1])
    st.close(sids[0])
    st.close(sids[2])  # no records: both closes pass at once
    assert log.events == [("close", sids[0], False),
                          ("close", sids[2], False)]
    st.close(sids[1])  # group 1's snapshot is held
    reused = st.create(seed=50)
    assert reused == sids[1] and st.session_group(reused) == 0
    st.decide(reused)
    st.drain_ring(wait=False)  # group 0's snapshot lands at once
    assert len(log.events) == 2  # nothing passes the held snapshot
    held[0].hold = False
    st.drain_ring(wait=False)
    rest = [(e[0], int(e[1].sid[0]) if e[0] == "chunk" else e[1])
            for e in log.events[2:]]
    assert rest == [("chunk", reused), ("close", reused),
                    ("chunk", reused)], rest
    first, second = (e[1] for e in log.events if e[0] == "chunk")
    assert int(first.seq[0]) == int(second.seq[0]) == 1


def test_ring_overrun_is_counted_never_spliced(setup):
    """An explicit cadence tighter than safe overruns: the store counts
    exactly the overwritten records, and the buffer's seq-gap guard
    drops the corrupted episode instead of splicing across the hole."""
    (_, _, _), (tp, tb, ts) = setup
    buf = TrajectoryBuffer(capacity=16, max_steps=16, min_decisions=1)
    st = SessionStore(tp, tb, ts, capacity=4, max_batch=3, seed=0,
                      record=True, ring=3, ring_drain=3, collector=buf,
                      device="cpu")
    s0 = st.create(seed=800)
    others = [st.create(seed=801 + i) for i in range(3)]
    st.decide(s0)
    st.drain_ring(wait=True)
    st.decide(s0)
    st.decide(s0)
    st.decide_batch(others)
    st.decide(s0)
    st.drain_ring(wait=True)
    assert st.stats["serve_ring_dropped"] == 2
    assert buf.stats["online_dropped_gap"] == 1
    for s in [s0, *others]:
        st.close(s)
    st.drain_ring(wait=True)
    t0 = [t for t in drain_sorted(buf) if t.session_id == s0]
    assert [t.length for t in t0] == [1]


@pytest.mark.parametrize("knob", [
    {"record": True}, {"record": True, "ring": 8},
    {"record": True, "ring": 8, "ring_drain": 2},
])
def test_store_from_config_builds_the_record_knobs(setup, knob):
    """`record`, `ring` and `ring_drain` pass through `store_from_config`
    to a store that records (they raised before the record path was
    ported)."""
    (_, _, _), (tp, tb, ts) = setup
    st = store_from_config({"capacity": 4, "max_batch": 2, **knob}, tp, tb,
                           ts, device="cpu")
    assert st.record and st.ring_size == knob.get("ring", 0)
    if "ring_drain" in knob:
        assert st.ring_drain == knob["ring_drain"]
    sid = st.create(seed=5)
    r = st.decide(sid)
    assert (r.obs is not None) == (st.ring_size == 0)
    st.close(sid)
