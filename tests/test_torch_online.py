"""The port's online learning loop against the JAX package's (the tests
of tests/test_online.py, mirrored): a record-on store's results and
`StoredObs` records against a JAX record-on store's under the same
operations, the trajectories their buffers assemble, the buffer's
assembly, eviction, staleness guard and record-off refusal fed the same
results as JAX's buffer, `online_from_config`'s errors, the learner's
padded rollout (equal to JAX's) and one `OnlineLearner.step()` from the
same trajectories and weights (the stats within test_torch_ppo.py's
`TOL`, rtol 1e-4 / atol 1e-6; every parameter within it but the policy
heads, held to Adam's step bound), and the swap side on the port: the
version at dispatch, rollback, a refused change of structure, the bus's
publish and its probation rollback, a rejected poisoned update. Sizes:
tests/test_serve.py's small setup (5 executors, 6 jobs, embed 8,
job_bucket 4, the weights scaled by 0.3 and carried across)."""

from __future__ import annotations

import copy
import json
import types

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.online import OnlineLearner as JaxLearner
from sparksched_tpu.online import TrajectoryBuffer as JaxBuffer
from sparksched_tpu.online import make_learner_trainer as jax_learner_trainer
from sparksched_tpu.online import online_from_config as jax_online_cfg
from sparksched_tpu.serve import SessionStore as JaxStore
from sparksched_tpu_torch.obs.runlog import RunLog
from sparksched_tpu_torch.online import (
    OnlineLearner,
    ParamBus,
    TrajectoryBuffer,
    make_learner_trainer,
    online_from_config,
)
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.serve import ContinuousBatcher, SessionStore

from ._torch_parity import assert_same_result, assert_update_close, serve_setup
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_serve_ring import OBS_FIELDS, assert_traj_equal

AGENT_CFG = {
    "agent_cls": "DecimaScheduler",
    "embed_dim": 8,
    "gnn_mlp_kwargs": {"hid_dims": [16]},
    "policy_mlp_kwargs": {"hid_dims": [16]},
    "job_bucket": 4,
}
TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_ppo.py's
ONLINE = {"max_steps": 8, "batch_trajectories": 2, "min_decisions": 2,
          "max_param_lag": 4, "probation_decisions": 4,
          "max_quarantine_rate": 0.5}


@pytest.fixture(scope="module")
def setup():
    return serve_setup()


def _port_store(setup, **kw):
    """A port record-on store on its own copy of the scheduler (a swap
    moves only its own weights)."""
    (_, _, _), (tp, tb, ts) = setup
    kw = dict(capacity=8, max_batch=3, seed=0, record=True) | kw
    return SessionStore(tp, tb, copy.deepcopy(ts), device="cpu", **kw)


def _assert_obs_equal(a, b) -> None:
    """Two StoredObs records (either package's) bit-equal."""
    for f in OBS_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, f)


def _serve(store, buf, rounds: int = 40) -> list:
    """Decide two sessions in batches (a single decide every fifth
    round), rotating on episode end, until the buffer holds 2
    trajectories; returns the results."""
    store.collector = buf
    sids = [store.create(seed=300 + i) for i in range(2)]
    out = []
    for rnd in range(rounds):
        rs = ([store.decide(sids[0])] if rnd % 5 == 4
              else store.decide_batch(sids))
        out += rs
        for r in rs:
            if r.done or r.health_mask:
                j = sids.index(r.session_id)
                store.close(sids[j])
                sids[j] = store.create(seed=320 + 4 * rnd + j)
        if len(buf) >= 2:
            break
    for s in sids:
        store.close(s)
    store.collector = None
    return out


@pytest.fixture(scope="module")
def served(setup):
    """The same operations through a JAX record-on store and the port's,
    each feeding its own buffer: (JAX results, port results, JAX
    trajectories, port trajectories, JAX store)."""
    (jp, jb, js), _ = setup
    jst = JaxStore(jp, jb, js, capacity=8, max_batch=3, seed=0, record=True)
    pst = _port_store(setup)
    jbuf = JaxBuffer(capacity=16, max_steps=8, min_decisions=2)
    pbuf = TrajectoryBuffer(capacity=16, max_steps=8, min_decisions=2)
    jres, pres = _serve(jst, jbuf), _serve(pst, pbuf)
    return jres, pres, jbuf.drain(64), pbuf.drain(64), jst


def test_record_results_match_jax(served):
    """Record-on decisions (batched and single) agree with the JAX
    store's, each carries its StoredObs record bit-equal to JAX's and the
    version live at dispatch, and a batch's results share one version."""
    jres, pres, *_ = served
    assert len(jres) == len(pres) >= 8
    assert any(not r.batched for r in pres) and any(r.batched for r in pres)
    for a, b in zip(jres, pres):
        assert_same_result(a, b)
        assert b.params_version == a.params_version == 0
        assert (a.obs is None) == (b.obs is None) and b.obs is not None
        _assert_obs_equal(a.obs, b.obs)
        assert b.obs.node_mask.shape == (6, 20)
        assert "obs" not in b.to_dict()


def test_buffered_trajectories_match_jax(served):
    """The buffers' trajectories from the two stores' results: stamps,
    actions and records bit-equal, the served floats within rtol 1e-5."""
    _, _, jt, pt, _ = served
    assert len(jt) == len(pt) == 2
    for a, b in zip(jt, pt):
        assert (a.session_id, a.length, a.done) == (b.session_id, b.length,
                                                    b.done)
        for f in ("stage_idx", "job_idx", "num_exec_k", "params_version"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        for f in ("lgprob", "reward", "wall_times"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        _assert_obs_equal(a.obs, b.obs)


# ---------------------------------------------------------------------------
# the buffer, fed the same results as JAX's
# ---------------------------------------------------------------------------


class _FakeResult:
    def __init__(self, sid, k, *, done=False, decided=True, health_mask=0,
                 version=0):
        self.session_id = sid
        self.stage_idx = k
        self.job_idx = 0
        self.num_exec = 2
        self.lgprob = -0.5
        self.decided = decided
        self.done = done
        self.reward = -float(k)
        self.dt = 1.0
        self.wall_time = float(k + 1)
        self.health_mask = health_mask
        self.params_version = version
        self.obs = {"x": np.full((2, 3), k, np.float32)}


def _assembly(cls):
    """test_online.py's assembly, segment, eviction script on one
    buffer class; returns (buffer, first drained trajectory)."""
    buf = cls(capacity=2, max_steps=3, min_decisions=2)
    buf.add(_FakeResult(10, 0))
    buf.add(_FakeResult(10, 1, done=True, version=1))
    assert len(buf) == 1
    [tr] = buf.drain(1)
    assert tr.length == 2 and tr.done
    for k in range(3):
        buf.add(_FakeResult(11, k))  # max_steps segment cut
    assert len(buf) == 1 and buf.stats["online_trajectories"] == 2
    buf.add(_FakeResult(12, 0))
    buf.on_close(12)  # too short: dropped
    buf.add(_FakeResult(13, 0))
    buf.add(_FakeResult(13, 1, health_mask=4))  # quarantine drops it
    for sid in (14, 15):
        buf.add(_FakeResult(sid, 0))
        buf.add(_FakeResult(sid, 1, done=True))
    assert len(buf) == 2  # FIFO eviction at capacity 2
    return buf, tr


def test_buffer_assembly_and_eviction_match_jax():
    (jb, jtr), (pb, ptr) = _assembly(JaxBuffer), _assembly(TrajectoryBuffer)
    assert pb.stats == jb.stats
    assert pb.stats["online_dropped_overflow"] == 1
    assert pb.stats["online_dropped_short"] == 1
    assert pb.stats["online_dropped_quarantined"] == 1
    np.testing.assert_array_equal(ptr.params_version, [0, 1])
    assert ptr.wall_times[0] == 0.0  # t0 = wall - dt
    assert_traj_equal(jtr, ptr)
    for a, b in zip(jb.drain(8), pb.drain(8)):
        assert_traj_equal(a, b)


def test_buffer_staleness_guard_matches_jax():
    got = []
    for cls in (JaxBuffer, TrajectoryBuffer):
        buf = cls(capacity=8, max_steps=4, min_decisions=1)
        buf.add(_FakeResult(1, 0, version=0))
        buf.add(_FakeResult(1, 1, done=True, version=0))
        buf.add(_FakeResult(2, 0, version=5))
        buf.add(_FakeResult(2, 1, done=True, version=5))
        out = buf.drain(2, current_version=6, max_lag=2)
        got.append(([t.session_id for t in out], buf.stats))
    assert got[0] == got[1]
    assert got[1][0] == [2] and got[1][1]["online_dropped_stale"] == 1


def test_buffer_refuses_record_off_results():
    for cls in (JaxBuffer, TrajectoryBuffer):
        r = _FakeResult(1, 0)
        r.obs = None
        with pytest.raises(ValueError, match="record-on"):
            cls().add(r)


# ---------------------------------------------------------------------------
# online_from_config
# ---------------------------------------------------------------------------


def test_online_from_config_errors_match_jax(setup):
    """Unknown keys, `enabled: false` wiring nothing and a record-off
    store refused, as in the JAX package."""
    for fn in (jax_online_cfg, online_from_config):
        with pytest.raises(ValueError, match="unknown online"):
            fn({"max_step": 4}, types.SimpleNamespace(record=True),
               AGENT_CFG)
        off = types.SimpleNamespace(record=False, collector=None)
        with pytest.raises(ValueError, match="record-on"):
            fn({"max_steps": 4}, off, AGENT_CFG)
        on = types.SimpleNamespace(record=True, collector=None)
        assert fn({"enabled": False, "max_steps": 4}, on, AGENT_CFG) is None
        assert on.collector is None
    st = _port_store(setup, record=False)
    with pytest.raises(ValueError, match="record-on"):
        online_from_config({}, st, AGENT_CFG)


# ---------------------------------------------------------------------------
# the learner against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def learners(setup, served):
    """(JAX learner, port learner, the JAX trajectories): B = 2, T = 8,
    both from the JAX store's serving weights."""
    (jp, _, _), (tp, _, _) = setup
    jst = served[4]
    jl = JaxLearner(jax_learner_trainer(AGENT_CFG, jp, 2, 8, seed=0),
                    JaxBuffer(), init_params=jst.model_params)
    w = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                jst.model_params))
    pl = OnlineLearner(make_learner_trainer(AGENT_CFG, tp, 2, 8, seed=0,
                                            device="cpu"),
                       TrajectoryBuffer(), init_params=w)
    return jl, pl, served[2]


def test_pad_rollout_matches_jax(learners):
    """The padded [B, T] rollout of the same two trajectories: every
    field bit-equal to JAX's, the records included."""
    jl, pl, trajs = learners
    a, b = jl._pad_rollout(trajs), pl._pad_rollout(trajs)
    for f in ("stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
              "wall_times", "valid", "resets", "final_reset_count"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, f)
    _assert_obs_equal(jax.tree_util.tree_map(np.asarray, a.obs),
                      b.obs.map(lambda t: t.numpy()))
    assert int(b.valid.sum()) == sum(t.length for t in trajs)
    # the padding template (unused by the update): the reset of
    # PRNGKey(17), whose arrival clocks the two engines sum to 1 ulp
    for f in ("wall_time", "num_jobs", "job_arrival_time"):
        np.testing.assert_allclose(getattr(b.final_state, f).numpy(),
                                   np.asarray(getattr(a.final_state, f)),
                                   rtol=1e-6, err_msg=f)


def test_learner_step_matches_jax(learners):
    """One `step()` of each learner from the same trajectories and
    weights: accepted, version 1, the stats within TOL and the updated
    weights within test_torch_ppo.py's bounds (policy heads to Adam's
    step bound)."""
    jl, pl, trajs = learners
    p0 = {k: v.detach().clone() for k, v in pl.state.params.items()}
    jl.buffer.requeue(trajs)
    pl.buffer.requeue(trajs)
    ji, pi = jl.step(), pl.step()
    assert ji["accepted"] and pi["accepted"], (ji, pi)
    assert ji["version"] == pi["version"] == 1
    assert pi["health_mask"] == ji["health_mask"] == 0
    for k in ("policy_loss", "approx_kl_div", "entropy"):
        np.testing.assert_allclose(pi[k], ji[k], err_msg=k, **TOL)
    for k in ("decisions", "max_lag"):
        assert pi[k] == ji[k], k
    np.testing.assert_allclose(pi["traj_reward_mean"],
                               ji["traj_reward_mean"], rtol=1e-6)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jl.state.params))
    assert_update_close(want, pl.state.params, p0,
                        int(pi["minibatches_applied"]), 3e-4, False)
    moved = max(float((pl.state.params[k].detach() - p0[k]).abs().max())
                for k in p0)
    assert moved > 1e-6


# ---------------------------------------------------------------------------
# the swap side, on the port
# ---------------------------------------------------------------------------


def test_swap_mid_stream_uses_dispatch_version(setup, tmp_path):
    """Tickets queued BEFORE a swap but dispatched after it carry the NEW
    version, every decision of the batch the same one; the swap and the
    per-request stamps land in the run log."""
    st = _port_store(setup)
    sids = [st.create(seed=200 + i) for i in range(3)]
    st.decide_batch(sids)
    new = {k: v * 1.01 for k, v in st.model_params.items()}
    rl = RunLog(str(tmp_path / "online.jsonl"))
    st._runlog = rl
    st.trace = True
    front = ContinuousBatcher(st, runlog=rl, trace=True)
    pre = [front.submit(s) for s in sids[:2]]  # 2 < max_batch: queued
    v1 = st.set_params(new)
    assert v1 == 1
    front.pump()
    assert all(t.ready and t.error is None for t in pre)
    assert {t.result.params_version for t in pre} == {v1}
    rl.close()
    recs = [json.loads(ln) for ln in open(rl.path)]
    swaps = [r for r in recs if r["ev"] == "params_swap"]
    assert swaps and swaps[0]["version"] == v1
    assert swaps[0]["prev_version"] == 0
    traces = [r for r in recs if r["ev"] == "trace"]
    assert traces and all(t["params_version"] == v1 for t in traces)


def test_rollback_restores_last_good_and_structure_is_refused(setup):
    st = _port_store(setup)
    good = {k: v.clone() for k, v in st.model_params.items()}
    st.set_params({k: v * 2.0 for k, v in good.items()})
    assert st.rollback_params(reason="test") == 0
    for k, v in st.model_params.items():
        assert torch.equal(v, good[k]), k
    with pytest.raises(ValueError, match="parameter names"):
        st.set_params({"mlp_stage.0.weight": good["mlp_stage.0.weight"]}
                      if "mlp_stage.0.weight" in good else {})
    with pytest.raises(ValueError, match="never shapes"):
        st.set_params({k: torch.zeros(3, 3) for k in good})
    for k, v in st.model_params.items():
        assert torch.equal(v, good[k]), k


def _poison(store, sid: int) -> None:
    g, local = divmod(int(store._slot_of[sid]), store.group_slots)
    store._stores[g].env.job_t_completed[local] = float("nan")


def test_learner_publishes_and_bus_rolls_back_a_spike(setup):
    """The loop on a port ring store: served decisions become
    trajectories, the learner's accepted update reaches the store on the
    next pump as the store's own copy (the learner keeps its tensors),
    later decisions carry it; then a published version whose probation
    window sees a quarantine spike is rolled back to the proven one."""
    st = _port_store(setup, ring=6)
    buf, learner, bus = online_from_config(ONLINE, st, AGENT_CFG)
    assert st.collector is buf and learner.version == 0
    sids = [st.create(seed=400 + i) for i in range(2)]
    for rnd in range(60):
        for r in st.decide_batch(sids):
            if r.done or r.health_mask:
                j = sids.index(r.session_id)
                st.close(sids[j])
                sids[j] = st.create(seed=430 + 4 * rnd + j)
        st.drain_ring(wait=True)
        if learner.ready():
            break
    assert learner.ready(), buf.stats
    before = {k: v.clone() for k, v in st.model_params.items()}
    info = learner.step()
    assert info["accepted"] and np.isfinite(info["policy_loss"])
    assert bus.pump() == {"event": "swap", "version": 1}
    assert st.params_version == 1
    lp = learner.state.params
    assert max(float((st.model_params[k] - before[k]).abs().max())
               for k in before) > 0
    for k, v in st.model_params.items():
        assert torch.equal(v, lp[k]) and v.data_ptr() != lp[k].data_ptr()
    assert all(r.params_version == 1 for r in st.decide_batch(sids))
    # prove v1 over a healthy probation window
    for _ in range(2):
        st.decide_batch(sids)
    assert bus.pump()["event"] == "proven"
    good = {k: v.clone() for k, v in st.model_params.items()}
    learner.bus.publish({k: v * 1.5 for k, v in good.items()}, 2)
    assert bus.pump() == {"event": "swap", "version": 2}
    for s in sids:
        st.close(s)
    bad = [st.create(seed=470 + i) for i in range(4)]
    for s in bad[:3]:
        _poison(st, s)
    quarantined = sum(bool(st.decide(s).health_mask) for s in bad)
    assert quarantined >= 2
    ev = bus.pump()
    assert ev["event"] == "rollback" and ev["to_version"] == 1, ev
    assert st.params_version == 1 and bus.stats["bus_rollbacks"] == 1
    for k, v in st.model_params.items():
        assert torch.equal(v, good[k]), k
    for s in bad:
        st.close(s)


def test_learner_rejects_a_poisoned_update(served, learners):
    """A trajectory with a NaN reward trips the update's health gate:
    the step is rejected, the learner's weights and Adam state stay as
    they were, and nothing is published."""
    _, pl, trajs = learners
    bad = copy.deepcopy(trajs)
    bad[0].reward = bad[0].reward.copy()
    bad[0].reward[0] = np.nan
    bus = types.SimpleNamespace(published=[])
    bus.publish = lambda *a, **k: bus.published.append(a)
    pl.bus = bus
    w0 = {k: v.detach().clone() for k, v in pl.state.params.items()}
    opt0 = pl.state.opt_state.count
    v0 = pl.version
    pl.buffer.requeue(bad)
    info = pl.step()
    pl.bus = None
    assert info is not None and not info["accepted"], info
    assert info["health_mask"] != 0
    assert pl.version == v0 and pl.stats["learner_rejected"] == 1
    assert bus.published == [] and pl.state.opt_state.count == opt0
    for k, v in pl.state.params.items():
        assert torch.equal(v, w0[k]), k


# ---------------------------------------------------------------------------
# the two threads' shared state, under a short switch interval
# ---------------------------------------------------------------------------


def test_buffer_and_bus_under_concurrent_threads():
    """More threads than cores add to one buffer while another drains
    it, and a publisher races the pump on one bus, with the interpreter
    switching threads every microsecond: no decision, trajectory or
    version is lost or counted twice."""
    import sys
    import threading

    buf = TrajectoryBuffer(capacity=10 ** 6, max_steps=4, min_decisions=1)
    drained, adders, steps = [], 12, 200
    done = threading.Event()

    def add(worker: int) -> None:
        for k in range(steps):
            buf.add(_FakeResult(worker, k, done=k % 4 == 3))

    def drain() -> None:
        while not done.is_set() or len(buf):
            drained.extend(buf.drain(3))

    class Store:
        stats = {"serve_decisions": 0, "serve_quarantines": 0}
        versions: list[int] = []

        def set_params(self, params, version, **kw):
            self.versions.append(version)
            return version

    bus = ParamBus(Store(), probation_decisions=10 ** 9)
    n_pub = 500

    def publish() -> None:
        for v in range(1, n_pub + 1):
            bus.publish({}, v)

    def pump() -> None:
        while not done.is_set():
            bus.pump()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=add, args=(w,))
                   for w in range(adders)]
        workers.append(threading.Thread(target=publish))
        others = [threading.Thread(target=drain), threading.Thread(target=pump)]
        for t in workers + others:
            t.start()
        for t in workers:
            t.join(timeout=60)
        done.set()
        for t in others:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers + others)
    finally:
        sys.setswitchinterval(old)
    bus.pump()
    assert buf.stats["online_decisions"] == adders * steps
    assert buf.stats["online_trajectories"] == adders * steps // 4
    assert len(drained) == adders * steps // 4
    assert sorted((t.session_id, int(t.stage_idx[0])) for t in drained) == [
        (w, k) for w in range(adders) for k in range(0, steps, 4)]
    st = bus.stats
    assert st["bus_published"] == n_pub
    assert st["bus_applied"] + st["bus_skipped"] == n_pub
    assert Store.versions[-1] == n_pub and Store.versions == sorted(
        Store.versions)
