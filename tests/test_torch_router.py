"""The port's replica router (`serve/router.py`) on one real, spawned
2-replica CPU fleet (`device="cpu"` replicas that rebuild the stack from
`tests._torch_parity:fleet_builder` and import no JAX): decisions through
the router against the JAX package's in-process `SessionStore` on the
same session seeds, session affinity, fleet-wide swaps and rollbacks,
quarantine isolated to one replica, the registry and the per-replica
samples, the scoreboard / SLO / rollback path with `/fleet` and the
replica-labeled `/metrics` over HTTP, the ring-on fleet feeding one
`TrajectoryBuffer` and an `OnlineLearner` whose update reaches both
replicas, `server_from_config` building a fleet with the collector, the
SLO monitor and the host profiler, and, last, replica death (the mirror
of tests/test_serve_net.py:354-483, tests/test_serve_ring.py:430 and
tests/test_fleet_obs.py:640, which the JAX package marks slow). Sizes:
tests/test_serve.py's small setup."""

from __future__ import annotations

import json
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sparksched_tpu_torch.obs.fleet import FleetCollector, labeled_prometheus
from sparksched_tpu_torch.obs.hostprof import HostProfiler
from sparksched_tpu_torch.obs.metrics import MetricsRegistry
from sparksched_tpu_torch.obs.runlog import RunLog
from sparksched_tpu_torch.obs.slo import OnlineLoopProbe, SLOMonitor, SLOSpec
from sparksched_tpu_torch.online import (
    OnlineLearner,
    ParamBus,
    TrajectoryBuffer,
    make_learner_trainer,
)
from sparksched_tpu_torch.schedulers import DecimaScheduler
from sparksched_tpu_torch.serve import (
    ReplicaDied,
    ReplicaSpec,
    Router,
    SessionError,
    SessionQuarantined,
)
from sparksched_tpu_torch.serve.server import (
    ServeClient,
    ServeServer,
    server_from_config,
)

from ._torch_parity import SERVE_AGENT, assert_same_result
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

BUILDER = "tests._torch_parity:fleet_builder"
# tests/test_serve_ring.py's ring-fleet block (capacity 6, max_batch 3,
# ring 8 drained every 4)
FLEET_CFG = {"capacity": 6, "max_batch": 3, "record": True, "ring": 8,
             "ring_drain": 4}
AGENT_CFG = {"agent_cls": "DecimaScheduler", **SERVE_AGENT}


def _weights() -> dict[str, np.ndarray]:
    """The port's seed-42 init scaled by 0.3, as numpy (the serving
    tests' scale: the Tanh heads stay out of saturation)."""
    ts = DecimaScheduler(**SERVE_AGENT, num_executors=5, device="cpu")
    return {k: v.detach().numpy() * np.float32(0.3)
            for k, v in ts.params.items()}


def _jax_store(weights):
    """The JAX package's in-process store at the same weights."""
    import jax
    import jax.numpy as jnp

    from sparksched_tpu.config import EnvParams as JaxParams
    from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
    from sparksched_tpu.serve import SessionStore as JaxStore
    from sparksched_tpu.workload import make_workload_bank
    from sparksched_tpu_torch.serialization import params_to_flax

    jb = make_workload_bank(5, 20)
    jp = JaxParams(num_executors=5, max_jobs=6, max_stages=jb.max_stages,
                   max_levels=jb.max_stages, mean_time_limit=None)
    js = JaxDecima(**SERVE_AGENT, num_executors=5)
    js.params = jax.tree_util.tree_map(
        jnp.asarray, type(js.params)(params_to_flax(weights)))
    return JaxStore(jp, jb, js, capacity=6, max_batch=3, seed=0)


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def jax_ref(weights):
    """The JAX store, built on a thread while the fleet tests run."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_jax_store, weights)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def spec(weights):
    return ReplicaSpec(builder=BUILDER, builder_kwargs={"weights": weights},
                       serve_cfg=FLEET_CFG, trace=True, device="cpu")


@pytest.fixture(scope="module")
def fleet(spec, jax_ref):
    router = Router(spec, replicas=2, metrics=MetricsRegistry(),
                    collector=TrajectoryBuffer(capacity=64, max_steps=8,
                                               min_decisions=2))
    yield router
    router.stop()
    assert all(not r.proc.is_alive() for r in router._replicas)


def _serve(router, sids):
    tks = [router.submit(s) for s in sids]
    router.flush()
    return tks


def test_router_boots_replicas_on_the_asked_device(fleet):
    info = fleet.replica_info()
    assert [i["replica"] for i in info] == [0, 1]
    assert all(i["device"] == "cpu" and i["capacity"] == 6
               and i["boot_s"] > 0 for i in info)
    assert len({i["pid"] for i in info}) == 2
    assert fleet.front_name == "router2"


def test_router_refuses_a_missing_card(weights):
    """A replica asked for the card that finds none fails its boot; the
    router raises and reaps the fleet. No replica serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    spec = ReplicaSpec(builder=BUILDER, builder_kwargs={"weights": weights},
                       serve_cfg={"capacity": 2, "max_batch": 1})
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        Router(spec, replicas=1)


def test_router_session_affinity(fleet):
    """A sid always lands on the same replica (gsid % n), and every
    served decision reports the replica that owned it."""
    sids = [fleet.create(seed=100 + i) for i in range(4)]
    assert sorted({fleet.replica_of(s) for s in sids}) == [0, 1]
    try:
        for _round in range(3):
            for s, tk in zip(sids, _serve(fleet, sids)):
                assert tk.error is None, tk.error
                assert tk.result.replica == fleet.replica_of(s)
                assert tk.result.session_id * 2 + tk.result.replica == s
    finally:
        for s in sids:
            fleet.close(s)


def test_router_param_swap_reaches_all_replicas(fleet, weights):
    """One `set_params` lands on EVERY replica and the version rides each
    later result; the rollback is fleet-wide too."""
    bumped = {k: torch.from_numpy(v * np.float32(1.01))
              for k, v in weights.items()}
    v0 = fleet.params_version
    sids = [fleet.create(seed=200 + i) for i in range(2)]
    assert {fleet.replica_of(s) for s in sids} == {0, 1}
    try:
        assert fleet.set_params(bumped, version=41) == 41 == \
            fleet.params_version
        tks = _serve(fleet, sids)
        assert all(tk.error is None for tk in tks)
        assert {tk.result.params_version for tk in tks} == {41}
        assert {tk.result.replica for tk in tks} == {0, 1}
        assert fleet.rollback_params(reason="test") == v0
        tks = _serve(fleet, sids)
        assert {tk.result.params_version for tk in tks} == {v0}
        st = fleet.fleet_stats()
        assert st["serve_param_swaps"] >= 1 + 2  # router + 2 replicas
        with pytest.raises(ValueError, match="never shapes"):
            fleet.set_params({k: np.zeros((1,), np.float32)
                              for k in weights})
    finally:
        for s in sids:
            fleet.close(s)


def test_router_quarantine_isolated_to_one_replica(fleet):
    a = fleet.create(seed=300)
    b = fleet.create(seed=301)
    assert fleet.replica_of(a) != fleet.replica_of(b)
    q0 = fleet.stats["serve_quarantines"]
    fleet.poison(a)
    (tk,) = _serve(fleet, [a])
    assert tk.error is None and tk.result.health_mask != 0
    assert fleet.stats["serve_quarantines"] == q0 + 1
    (tk2,) = _serve(fleet, [a])
    assert isinstance(tk2.error, SessionQuarantined)
    (tk3,) = _serve(fleet, [b])  # the other replica's session serves
    assert tk3.error is None and tk3.result.health_mask == 0
    fleet.close(a)  # close reclaims a quarantined session
    fleet.close(b)
    c = fleet.create(seed=302)
    (tk4,) = _serve(fleet, [c])
    assert tk4.error is None
    fleet.close(c)
    with pytest.raises(SessionError):
        fleet.close(c)
    (tk5,) = _serve(fleet, [c])
    assert isinstance(tk5.error, SessionError)


def test_router_registry_and_replica_samples(fleet):
    sids = [fleet.create(seed=320 + i) for i in range(2)]
    _serve(fleet, sids)
    samples = fleet.replica_samples()
    assert [s["replica"] for s in samples] == ["0", "1"]
    assert all(s["alive"] and s["stats"]["serve_decisions"] > 0
               for s in samples)
    text = labeled_prometheus(samples)
    assert 'replica="0"' in text and 'replica="1"' in text
    merged = fleet.registry()
    assert merged.counters == pytest.approx(
        MetricsRegistry().merge(samples[0]["registry"])
        .merge(samples[1]["registry"]).merge(fleet.metrics).counters)
    stats = fleet.fleet_stats()
    assert stats["serve_decisions"] == fleet.stats["serve_decisions"] + sum(
        s["stats"]["serve_decisions"] for s in samples)
    counts = fleet.kernel_counts()
    assert all(c["decima_node_encoder"] == 0  # the CPU: plain calls
               and c["decima_node_encoder_plain"] > 0 for c in counts)
    for s in sids:
        fleet.close(s)


def test_fleet_scoreboard_slo_rollback_and_http(fleet, weights, tmp_path):
    """A seeded quarantine regression (a poisoned session on each
    replica) trips the burn-rate rule, lands an `alert` record and rolls
    the whole fleet back; then the same router behind a `ServeServer`
    answers `/fleet` and the replica-labeled `/metrics`."""
    rl = RunLog(str(tmp_path / "fleet.jsonl"))
    mon = SLOMonitor([SLOSpec("quarantine_rate", "ratio", 0.05)],
                     windows=((60.0, 15.0, 1.0),), cooldown_s=0.0,
                     rollback=fleet, rollback_on=("quarantine_rate",),
                     runlog=rl)
    col = FleetCollector(fleet, period_s=0.0, runlog=rl, slo=mon)
    v_before = fleet.params_version
    bumped = {k: v * np.float32(1.01) for k, v in weights.items()}
    assert fleet.set_params(bumped, version=9) == 9
    sids = [fleet.create(seed=600 + i) for i in range(4)]
    assert {fleet.replica_of(s) for s in sids} == {0, 1}
    col.scrape()  # the baseline
    for _ in range(2):
        assert all(tk.error is None for tk in _serve(fleet, sids))
    status = col.scrape()
    assert status["alerts"] == []
    rows = {r["replica"]: r for r in status["replicas"]}
    assert set(rows) == {"0", "1"}
    assert all(r["alive"] and r["decisions"] > 0 and r["rps"] > 0
               and r["params_version"] == 9 and r["params_lag"] == 0
               for r in rows.values())
    assert status["fleet"]["replicas_alive"] == 2
    for s in sids[:2]:
        fleet.poison(s)
    tks = _serve(fleet, sids)
    assert sum(1 for tk in tks if tk.result.health_mask) == 2
    status = col.scrape()
    (alert,) = status["alerts"]
    assert alert["slo"] == "quarantine_rate" and alert["burn_long"] >= 1.0
    assert alert["action"] == "rollback"
    assert alert["rolled_back_to_version"] == v_before == fleet.params_version
    rl.close()
    with open(rl.path) as fp:
        evs = [json.loads(line)["ev"] for line in fp]
    assert "fleet" in evs and "alert" in evs
    for s in sids:
        fleet.close(s)

    prof = HostProfiler(hz=200.0)
    server = ServeServer(fleet, fleet, metrics=MetricsRegistry(),
                         collector=col, hostprof=prof).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/fleet", timeout=30) as r:
            doc = json.loads(r.read().decode())
        assert [row["replica"] for row in doc["replicas"]] == ["0", "1"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            prom = r.read().decode()
        assert 'replica="0"' in prom and 'replica="1"' in prom
        with ServeClient("127.0.0.1", server.port) as client:
            sid = client.create(seed=650)
            tk = client.submit(sid)
            client.flush()
            assert tk.error is None and tk.result.replica in (0, 1)
            client.close(sid)
    finally:
        server.stop()
    roles = prof.tables()["roles"]
    assert "serve-pump" in roles and "serve-http" in roles


def test_server_from_config_builds_a_fleet(spec):
    """`replicas: 2` with the collector, an `slo:` block and the host
    profiler builds the fleet behind HTTP, serves, and reaps it."""
    cfg = {"replicas": 2, "collect": True, "collect_period_s": 0.05,
           "slo": {"quarantine_rate_max": 0.05,
                   "rollback_on": ["quarantine_rate"]},
           "hostprof": True, "capacity": 4, "max_batch": 2,
           "host": "127.0.0.1", "port": 0}
    server = server_from_config(
        cfg, None, None, None,
        replica_spec=ReplicaSpec(builder=BUILDER,
                                 builder_kwargs=spec.builder_kwargs,
                                 device="cpu"))
    router = server.store
    assert isinstance(router, Router) and server.front is router
    assert [s.name for s in server.collector.slo.specs] == [
        "quarantine_rate"]
    assert server.collector.slo.rollback is router
    with server:
        assert server.hostprof.running
        with ServeClient("127.0.0.1", server.port) as client:
            sids = [client.create(seed=800 + i) for i in range(2)]
            for _ in range(2):
                tks = [client.submit(s) for s in sids]
                client.flush()
                assert all(tk.error is None for tk in tks)
            assert {tk.result.replica for tk in tks} == {0, 1}
            for s in sids:
                client.close(s)
        deadline = time.monotonic() + 30.0
        while True:  # the scoreboard catches up on the pump's cadence
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/fleet",
                    timeout=30) as r:
                doc = json.loads(r.read().decode())
            seen = sum(row["decisions"] for row in doc["replicas"])
            if seen == 4 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert seen == 4 and doc["fleet"]["replicas_alive"] == 2
    assert not server.hostprof.running
    assert server.hostprof.tables()["samples"] > 0
    assert all(not r.proc.is_alive() for r in router._replicas)


def test_router_decisions_match_jax_store(fleet, weights, jax_ref):
    """Decisions through the router equal the JAX package's in-process
    store's on the same session seeds (integers equal, floats to rtol
    1e-5), one request at a time: each is a single decide on its
    replica. One JAX store stands for both replicas: its call counter,
    which keys each call, is set to the owning replica's before each
    decision (a store's counter is 2 + its calls)."""
    jstore = jax_ref.result()
    fleet.set_params(weights, version=0)  # the weights both were built at
    calls = []
    for smp in fleet.replica_samples():
        st = smp["stats"]
        calls.append(2 + st["serve_batch_calls"] + st["serve_decisions"]
                     - st["serve_batched_decisions"])
    sids = [fleet.create(seed=900 + i) for i in range(4)]
    jsids = [jstore.create(seed=900 + i) for i in range(4)]
    assert {fleet.replica_of(s) for s in sids} == {0, 1}
    try:
        for _round in range(8):
            for s, js in zip(sids, jsids):
                r = fleet.replica_of(s)
                (tk,) = _serve(fleet, [s])
                assert tk.error is None and tk.result.replica == r
                jstore._calls = calls[r]
                want = jstore.decide(js)
                calls[r] += 1
                assert_same_result(want, tk.result, same_sid=False)
    finally:
        for s in sids:
            fleet.close(s)


def test_ring_fleet_streams_chunks_to_one_learner(fleet, weights):
    """Ring-on replicas ship drained chunks over the pipes in batches;
    the router remaps whole sid arrays into the global space, ONE buffer
    assembles trajectories from both replicas, the learner's update is
    accepted and `bus.pump()` lands it on both replicas."""
    from sparksched_tpu_torch.config import EnvParams

    fleet.ring_pump(force=True)  # the earlier tests' records
    buf = TrajectoryBuffer(capacity=64, max_steps=8, min_decisions=2)
    fleet.collector = buf
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=20,
                   max_levels=20)
    trainer = make_learner_trainer(AGENT_CFG, tp, 2, 8, seed=0,
                                   device="cpu")
    probe = OnlineLoopProbe(store=fleet)
    bus = ParamBus(fleet, probation_decisions=4, max_quarantine_rate=0.9,
                   on_event=probe.on_bus_event)
    v0 = fleet.params_version
    learner = OnlineLearner(
        trainer, buf, bus, max_param_lag=16, swap_every=1,
        init_params={k: torch.from_numpy(v) for k, v in weights.items()},
        version0=v0)
    sids = [fleet.create(seed=700 + i) for i in range(4)]
    assert {fleet.replica_of(s) for s in sids} == {0, 1}
    created = set(sids)
    guard = 0
    while len(buf) < learner.B and guard < 200:
        guard += 1
        for j, (s, tk) in enumerate(zip(sids, _serve(fleet, sids))):
            if tk.error is not None or tk.result.done \
                    or tk.result.health_mask:
                fleet.close(s)
                sids[j] = fleet.create(seed=730 + guard * 4 + j)
                created.add(sids[j])
        fleet.ring_pump(force=True)
    assert len(buf) >= learner.B, (buf.stats, fleet.fleet_stats())
    # the buffer speaks GLOBAL sids only
    assert set(buf._open) <= created
    assert learner.ready()
    info = learner.step()
    assert info is not None and info["accepted"], info
    assert np.isfinite(info["policy_loss"])
    assert learner.version == v0 + 1
    assert bus.pump() == {"event": "swap", "version": v0 + 1}
    assert fleet.params_version == v0 + 1
    tks = _serve(fleet, sids[:2])
    assert {tk.result.replica for tk in tks} == {0, 1}
    assert all(tk.error is None and tk.result.params_version == v0 + 1
               for tk in tks)
    for tk in tks:  # the probe's swap-to-first-decision clock
        probe.add(tk.result)
    assert probe.stats["probe_swaps"] == 1
    assert probe.stats["probe_first_decisions"] == 1
    assert probe.summary()["staleness"]["count"] == 2
    fs = fleet.fleet_stats()
    assert fs["serve_ring_records"] >= buf.stats["online_decisions"]
    assert fs["serve_ring_dropped"] == 0
    assert fs["serve_ring_drains"] >= 2  # both replicas drained
    for s in sids:
        fleet.close(s)
    fleet.ring_pump(force=True)
    assert not buf._open


def test_router_replica_death_fails_sessions_not_rerouted(fleet):
    """Replica death marks its sessions FAILED (`ReplicaDied`, a
    SessionError), never rerouted; the survivor serves on and placement
    avoids the dead replica. Runs LAST: it kills replica 1."""
    sids = [fleet.create(seed=400 + i) for i in range(4)]
    on_dead = [s for s in sids if fleet.replica_of(s) == 1]
    on_live = [s for s in sids if fleet.replica_of(s) == 0]
    assert on_dead and on_live
    victim = fleet._replicas[1]
    victim.proc.kill()
    victim.proc.join(timeout=10.0)
    assert fleet.stats["router_replica_deaths"] == 0
    tks = [fleet.submit(s) for s in on_dead]
    deadline = time.monotonic() + 10.0
    while (fleet.stats["router_replica_deaths"] == 0
           and time.monotonic() < deadline):
        fleet.poll()
        time.sleep(0.05)
    assert fleet.stats["router_replica_deaths"] == 1
    tks += [fleet.submit(s) for s in on_dead]
    for tk in tks:
        assert tk.ready and isinstance(tk.error, ReplicaDied), tk.error
        assert isinstance(tk.error, SessionError)
    assert fleet.stats["router_sessions_failed"] >= len(on_dead)
    for tk in _serve(fleet, on_live):
        assert tk.error is None and tk.result.replica == 0
    for s in on_dead:
        fleet.close(s)  # a no-op reclaim
    for s in on_live:
        fleet.close(s)
    fresh = [fleet.create(seed=500 + i) for i in range(2)]
    assert {fleet.replica_of(s) for s in fresh} == {0}
    assert [s["alive"] for s in fleet.replica_samples()] == [True, False]
    assert fleet.kernel_counts()[1] is None
    for s in fresh:
        fleet.close(s)
