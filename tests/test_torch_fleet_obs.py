"""The port's fleet plane against the JAX package's, on inputs made from a
seed with numpy (the tests of tests/test_fleet_obs.py and
tests/test_critpath.py, mirrored): the replica-labeled Prometheus
exposition byte for byte, the `FleetCollector` scoreboard, fleet window
and `fleet` run-log records over a fake two-replica backend with the
clock injected and over an in-process port store (the pseudo-replica
"0"), the `SLOMonitor`'s alerts over the same window sequences (cooldown,
the short-window gate, latency, floor, ceiling and idle windows,
rollback), `slo_from_config`'s errors, `OnlineLoopProbe.summary`, the
host profiler's role table, `render_status` and the CLI's `--runlog`
mode. Host-only code: nothing here needs the card."""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sparksched_tpu.obs import fleet as jfleet
from sparksched_tpu.obs import hostprof as jhostprof
from sparksched_tpu.obs import metrics as jmetrics
from sparksched_tpu.obs import slo as jslo
from sparksched_tpu.obs.runlog import RunLog as JaxRunLog
from sparksched_tpu_torch.obs import fleet as tfleet
from sparksched_tpu_torch.obs import hostprof as thostprof
from sparksched_tpu_torch.obs import metrics as tmetrics
from sparksched_tpu_torch.obs import slo as tslo
from sparksched_tpu_torch.obs.runlog import RunLog

from ._torch_parity import serve_setup
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

# (fleet module, metrics module, slo module, RunLog) of each package
JAX = (jfleet, jmetrics, jslo, JaxRunLog)
PORT = (tfleet, tmetrics, tslo, RunLog)


def _records(path) -> list[dict]:
    with open(path) as fp:
        return [json.loads(line) for line in fp if line.strip()]


def _strip_time(recs: list[dict]) -> list[dict]:
    """Run-log records without their wall-clock stamps."""
    return [{k: v for k, v in r.items() if k not in ("t", "ts", "wall")}
            for r in recs]


# ---------------------------------------------------------------------------
# the labeled exposition
# ---------------------------------------------------------------------------


def _registries(metrics, seed: int):
    rng = np.random.default_rng(seed)
    regs = []
    for _ in range(2):
        r = metrics.MetricsRegistry()
        r.counter("serve_decisions_total", int(rng.integers(1, 50)))
        r.gauge("serve_inflight_depth", float(rng.integers(0, 4)))
        for v in rng.lognormal(2.0, 1.0, 40):
            r.observe("serve_span_device_ms", float(v))
        regs.append(r)
    return regs


@pytest.mark.parametrize("seed", [0, 1])
def test_labeled_prometheus_matches_jax(seed):
    texts = []
    for fleet, metrics, _slo, _rl in (JAX, PORT):
        regs = _registries(metrics, seed)
        extra = metrics.MetricsRegistry()
        extra.counter("serve_http_requests", 7)
        samples = [
            {"replica": "0", "alive": True, "registry": regs[0], "stats": {}},
            {"replica": "1", "alive": True, "registry": regs[1], "stats": {}},
            {"replica": "2", "alive": False, "registry": None, "stats": None},
        ]
        texts.append(fleet.labeled_prometheus(samples, extra=extra))
    assert texts[0] == texts[1]
    assert 'serve_decisions_total{replica="1"}' in texts[1]
    assert 'replica="2"' not in texts[1]
    assert texts[1].count("# TYPE serve_decisions_total counter") == 1


def test_registry_pickles_for_the_pipe():
    """A replica ships its registry to the router: the copy keeps every
    series and gets a lock of its own."""
    import pickle

    reg = _registries(tmetrics, 3)[0]
    back = pickle.loads(pickle.dumps(reg))
    assert back.to_prometheus() == reg.to_prometheus()
    back.counter("serve_decisions_total")
    assert back.counters != reg.counters


# ---------------------------------------------------------------------------
# the collector's scoreboard (a fake two-replica backend, manual clock)
# ---------------------------------------------------------------------------


class _FakeFleet:
    """Router-shaped fake: `replica_samples()` from mutable counters."""

    def __init__(self, metrics):
        self.reg = {r: metrics.MetricsRegistry() for r in ("0", "1")}
        self.stats_by = {
            r: {"serve_decisions": 0, "serve_quarantines": 0,
                "serve_sessions_live": 2, "serve_sessions_hot": 1,
                "serve_page_ins": 0, "serve_page_outs": 0,
                "serve_param_version": 0, "serve_ring_occupancy": 0,
                "serve_ring_drains": 0, "serve_ring_dropped": 0}
            for r in ("0", "1")
        }
        self.dead: set[str] = set()

    def advance(self, rep, decisions=0, quarantines=0, pages=0,
                lat_ms=(), segs=None, version=None, ring=0):
        st = self.stats_by[rep]
        st["serve_decisions"] += decisions
        st["serve_quarantines"] += quarantines
        st["serve_page_ins"] += pages
        st["serve_ring_occupancy"] = ring
        st["serve_ring_drains"] += 1 if ring else 0
        if version is not None:
            st["serve_param_version"] = version
        for v in lat_ms:
            self.reg[rep].observe("serve_span_device_ms", float(v))
        for seg, vals in (segs or {}).items():
            for v in vals:
                self.reg[rep].observe(f"serve_seg_{seg}_ms", float(v))

    def replica_samples(self):
        out = []
        for r in ("0", "1"):
            if r in self.dead:
                out.append({"replica": r, "alive": False, "sessions": 0,
                            "registry": None, "stats": None})
            else:
                out.append({"replica": r, "alive": True, "sessions": 2,
                            "registry": self.reg[r],
                            "stats": dict(self.stats_by[r])})
        return out


def _collector_run(pkg, tmp_path, seed: int):
    """A seeded scrape sequence through one package's collector and SLO
    monitor: (statuses as JSON, rendered tables, run-log records)."""
    fleet, metrics, slo, runlog_cls = pkg
    rng = np.random.default_rng(seed)
    fake = _FakeFleet(metrics)
    t = [100.0]
    rl = runlog_cls(str(tmp_path / f"{fleet.__name__}.jsonl"))
    mon = slo.SLOMonitor(
        [slo.SLOSpec("quarantine_rate", "ratio", 0.05),
         slo.SLOSpec("p99_ms", "latency", 200.0)],
        windows=((60.0, 15.0, 1.0),), cooldown_s=0.0, runlog=rl,
        clock=lambda: t[0],
    )
    col = fleet.FleetCollector(fake, period_s=1.0, runlog=rl, slo=mon,
                               log_every=1, clock=lambda: t[0])
    statuses, tables = [], []
    for step in range(6):
        for rep in ("0", "1"):
            n = int(rng.integers(5, 40))
            fake.advance(
                rep, decisions=n,
                quarantines=int(rng.integers(0, n // 3 + 1)),
                pages=int(rng.integers(0, 6)),
                lat_ms=rng.lognormal(3.0 + (rep == "1"), 1.0, n),
                segs={"queue_wait": rng.lognormal(2.0, 1.0, n),
                      "device_compute": rng.lognormal(2.5, 0.5, n)},
                version=step // 2 + (rep == "0"),
                ring=int(rng.integers(0, 8)),
            )
        if step == 4:
            fake.dead.add("1")
        t[0] += float(rng.uniform(0.5, 2.5))
        st = col.maybe_scrape()
        if st is None:
            continue
        statuses.append(json.loads(json.dumps(fleet._json_safe(st))))
        tables.append(fleet.render_status(st))
    assert col.maybe_scrape(now=t[0] + 0.1) is None  # rate-limited
    rl.close()
    return statuses, tables, _strip_time(_records(rl.path))


@pytest.mark.parametrize("seed", [0, 5])
def test_fleet_collector_matches_jax(tmp_path, seed):
    want = _collector_run(JAX, tmp_path, seed)
    got = _collector_run(PORT, tmp_path, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    statuses = got[0]
    assert len(statuses) >= 3
    assert any(s["alerts"] for s in statuses)
    last = statuses[-1]
    assert [r["alive"] for r in last["replicas"]] == [True, False]
    assert {"ring_occ", "tail_seg"} <= set(last["replicas"][0])
    evs = {r["ev"] for r in got[2]}
    assert {"fleet", "alert"} <= evs


def test_fleet_collector_over_a_port_store(tmp_path):
    """An in-process port store is the pseudo-replica "0"; the JAX
    collector reading the same store gives the same rows."""
    from sparksched_tpu_torch.serve import ContinuousBatcher, SessionStore

    tp, tb, ts = serve_setup()[1]
    reg = tmetrics.MetricsRegistry()
    store = SessionStore(tp, tb, ts, capacity=4, max_batch=2, seed=0,
                         device="cpu", metrics=reg, trace=True)
    front = ContinuousBatcher(store, metrics=reg, trace=True)
    t = [0.0]
    cols = [fleet.FleetCollector(store, period_s=0.0, clock=lambda: t[0])
            for fleet in (jfleet, tfleet)]
    for c in cols:
        c.scrape()
    sids = [store.create(seed=10 + i) for i in range(3)]
    for _ in range(2):
        tks = [front.submit(s) for s in sids]
        front.flush()
        assert all(tk.error is None for tk in tks)
    t[0] += 2.0
    want, got = (c.scrape() for c in cols)
    assert tfleet._json_safe(got) == jfleet._json_safe(want)
    (row,) = got["replicas"]
    assert row["replica"] == "0" and row["alive"]
    assert row["decisions"] == 6 and row["rps"] == pytest.approx(3.0)
    assert row["p99_ms"] is not None and row["sessions"] == 3
    assert cols[1].fleet_status() is got


# ---------------------------------------------------------------------------
# the SLO monitor: the same windows give the same alerts
# ---------------------------------------------------------------------------


def _hist(metrics, xs):
    h = metrics.StreamingHistogram()
    h.add_many(float(x) for x in xs)
    return h


def _win(metrics, decisions=100, quarantines=0, dt=5.0, rps=None,
         lat=None, lag=None):
    return {
        "dt_s": dt, "decisions": decisions, "quarantines": quarantines,
        "goodput_rps": decisions / dt if rps is None else rps,
        "latency_hist": None if lat is None else _hist(metrics, lat),
        "params_lag_max": lag,
    }


class _Rollback:
    def __init__(self):
        self.calls = []

    def rollback_params(self, reason=""):
        self.calls.append(reason)
        return 7


def _scenario(name, slo, metrics, rl):
    """(monitor, [(now, window)]) of one scenario of
    tests/test_fleet_obs.py:307-433."""
    W = lambda **kw: _win(metrics, **kw)  # noqa: E731
    if name == "cooldown":
        mon = slo.SLOMonitor(
            [slo.SLOSpec("quarantine_rate", "ratio", 0.05)],
            windows=((60.0, 15.0, 2.0),), cooldown_s=100.0, runlog=rl,
            clock=lambda: 0.0)
        seq = [(5.0 * (i + 1), W(quarantines=1)) for i in range(12)]
        seq += [(65.0, W(decisions=1000, quarantines=500)),
                (70.0, W(decisions=1000, quarantines=500)),
                (171.0, W(decisions=1000, quarantines=500))]
        return mon, seq
    if name == "short_window_gate":
        mon = slo.SLOMonitor(
            [slo.SLOSpec("quarantine_rate", "ratio", 0.05)],
            windows=((60.0, 15.0, 2.0),), cooldown_s=0.0,
            clock=lambda: 0.0)
        return mon, [(5.0, W(quarantines=50))] + [
            (t, W(quarantines=0)) for t in (21.0, 26.0, 31.0)]
    if name == "latency":
        mon = slo.SLOMonitor(
            [slo.SLOSpec("p99_ms", "latency", 100.0, budget=0.01)],
            windows=((60.0, 15.0, 2.0),), clock=lambda: 0.0)
        return mon, [(5.0, W(lat=[5.0] * 99 + [500.0])),
                     (10.0, W(lat=[5.0] * 70 + [500.0] * 30))]
    if name == "floor_ceiling_idle":
        mon = slo.SLOMonitor(
            [slo.SLOSpec("goodput_rps", "floor", 50.0),
             slo.SLOSpec("params_staleness", "ceiling", 2.0)],
            windows=((60.0, 15.0, 1.0),), cooldown_s=30.0,
            clock=lambda: 0.0)
        return mon, [(5.0, W(decisions=0, rps=0.0)),
                     (10.0, W(decisions=0, rps=0.0)),
                     (15.0, W(decisions=10, rps=2.0)),
                     (20.0, W(decisions=10, rps=2.0)),
                     (25.0, W(lag=5)), (30.0, W(lag=5))]
    if name == "rollback":
        mon = slo.slo_from_config(
            {"quarantine_rate_max": 0.05, "p99_ms": 200.0,
             "windows": [[60, 15, 2.0]], "rollback_on": ["quarantine_rate"],
             "cooldown_s": 0.0, "min_events": 50},
            rollback=_Rollback(), runlog=rl, clock=lambda: 0.0)
        return mon, [(5.0, W(decisions=40, quarantines=20)),
                     (10.0, W(quarantines=50, lat=[5.0] * 90 + [900.0] * 10)),
                     (12.0, W(quarantines=50))]
    if name == "seeded":
        rng = np.random.default_rng(11)
        mon = slo.SLOMonitor(
            [slo.SLOSpec("quarantine_rate", "ratio", 0.05),
             slo.SLOSpec("p99_ms", "latency", 150.0),
             slo.SLOSpec("goodput_rps", "floor", 8.0),
             slo.SLOSpec("params_staleness", "ceiling", 1.0)],
            cooldown_s=20.0, runlog=rl, clock=lambda: 0.0)
        seq, t = [], 0.0
        for _ in range(60):
            t += float(rng.uniform(1.0, 9.0))
            n = int(rng.integers(0, 80))
            seq.append((t, W(
                decisions=n, quarantines=int(rng.integers(0, n // 4 + 1)),
                dt=float(rng.uniform(1.0, 9.0)),
                lat=rng.lognormal(4.0, 1.0, n) if n else None,
                lag=int(rng.integers(0, 3)) if rng.random() < 0.7 else None,
            )))
        return mon, seq
    raise KeyError(name)


@pytest.mark.parametrize("name", ["cooldown", "short_window_gate", "latency",
                                  "floor_ceiling_idle", "rollback", "seeded"])
def test_slo_monitor_matches_jax(tmp_path, name):
    runs = []
    for _fleet, metrics, slo, runlog_cls in (JAX, PORT):
        rl = runlog_cls(str(tmp_path / f"{slo.__name__}.jsonl"))
        mon, seq = _scenario(name, slo, metrics, rl)
        fired = [mon.ingest(w, now=t) for t, w in seq]
        rl.close()
        runs.append((fired, dict(mon.stats),
                     _strip_time(_records(rl.path)),
                     getattr(mon.rollback, "calls", None)))
    assert runs[1] == runs[0]
    fired = [a for batch in runs[1][0] for a in batch]
    want_alerts = {"cooldown": 2, "short_window_gate": 1, "latency": 1,
                   "floor_ceiling_idle": 2}
    if name in want_alerts:
        assert len(fired) == want_alerts[name]
    else:
        assert fired  # the sequence breaches something
    if name == "rollback":
        assert runs[1][0][0] == []  # under min_events: no signal
        rolled = [a for a in fired if a["action"] == "rollback"]
        assert rolled and all(a["slo"] == "quarantine_rate"
                              and a["rolled_back_to_version"] == 7
                              for a in rolled)
        assert len(runs[1][3]) == len(rolled)


@pytest.mark.parametrize("cfg,kw", [
    ({"quarantine_rate_mx": 0.05}, {}),
    ({"p99_ms": 100, "windows": [[10, 60, 1.0]]}, {}),
    ({"p99_ms": 100, "rollback_on": ["nope"]}, {}),
    ({"p99_ms": 100, "p99_budget": 1.5}, {}),
    ({"quarantine_rate_max": 0.0}, {}),
    (None, {}),
    ({"cooldown_s": 5.0}, {}),
])
def test_slo_from_config_matches_jax(cfg, kw):
    out = []
    for slo in (jslo, tslo):
        try:
            mon = slo.slo_from_config(cfg, **kw)
            out.append(("ok", None if mon is None else
                        [s.describe() for s in mon.specs]))
        except Exception as e:  # the same type and message
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]


def test_slo_spec_kind_error_matches_jax():
    msgs = []
    for slo in (jslo, tslo):
        with pytest.raises(ValueError) as e:
            slo.SLOSpec("x", "p99", 1.0)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# the online loop's depth probe
# ---------------------------------------------------------------------------


class _Res:
    def __init__(self, version, reward=None):
        self.params_version = version
        self.reward = reward


def _probe_run(slo, metrics):
    class _Inner:
        def __init__(self):
            self.added, self.closed = [], []

        def add(self, res):
            self.added.append(res.params_version)

        def on_close(self, sid, quarantined=False):
            self.closed.append((sid, quarantined))

    class _Store:
        stats = {"serve_param_version": 0}

    rng = np.random.default_rng(4)
    inner, store, t = _Inner(), _Store(), [1000.0]
    probe = slo.OnlineLoopProbe(store=store, inner=inner,
                                metrics=metrics.MetricsRegistry(),
                                clock=lambda: t[0])
    version = 0
    for i in range(200):
        t[0] += float(rng.uniform(0.01, 0.5))
        if rng.random() < 0.05:
            version += 1
            store.stats["serve_param_version"] = version
            probe.on_bus_event({"event": "swap", "version": version})
        if rng.random() < 0.01:
            probe.on_bus_event({"event": "rollback"})
        lag = int(rng.integers(0, 2))
        probe.add(_Res(max(0, version - lag),
                       reward=float(rng.normal()) if i % 3 else None))
        if rng.random() < 0.05:
            probe.on_close(i, quarantined=bool(rng.random() < 0.3))
    return (probe.summary(), inner.added, inner.closed,
            probe.metrics.snapshot())


def test_online_loop_probe_matches_jax():
    want = _probe_run(jslo, jmetrics)
    got = _probe_run(tslo, tmetrics)
    assert got == want
    s = got[0]
    assert s["probe_decisions"] == 200 and s["probe_swaps"] > 0
    assert s["swap_to_first_decision"]["count"] > 0


# ---------------------------------------------------------------------------
# the host profiler
# ---------------------------------------------------------------------------

THREAD_NAMES = ("MainThread", "serve-pump", "serve-http",
                "serve-harvester", "serve-client-3", "online-learner",
                "fleet-collector", "host-profiler", "serve-replica-1",
                "serve-pumpkin", "Thread-7", "", "serve-client")


@pytest.mark.parametrize("name", THREAD_NAMES)
def test_role_of_thread_name_matches_jax(name):
    assert (thostprof.role_of_thread_name(name)
            == jhostprof.role_of_thread_name(name))
    assert thostprof.PROFILE_ROLES == jhostprof.PROFILE_ROLES


def test_host_profiler_attributes_roles_and_costs_nothing_off(tmp_path):
    off = thostprof.HostProfiler()
    assert not off.running
    assert off.stop() == {"samples": 0, "hz": 67.0, "elapsed_s": 0.0,
                          "roles": {}}
    assert not any(t.name == "host-profiler" for t in threading.enumerate())

    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(2000))

    workers = [threading.Thread(target=spin, name=n, daemon=True)
               for n in ("serve-pump", "online-learner")]
    rl = RunLog(str(tmp_path / "hp.jsonl"))
    prof = thostprof.HostProfiler(hz=200.0, runlog=rl).start()
    for w in workers:
        w.start()
    deadline = time.monotonic() + 10.0
    while prof._samples < 20 and time.monotonic() < deadline:
        time.sleep(0.02)
    stop.set()
    for w in workers:
        w.join()
    tables = prof.stop()
    rl.close()
    assert not prof.running
    assert tables["samples"] >= 20
    roles = tables["roles"]
    assert {"serve-pump", "online-learner", "main"} <= set(roles)
    assert "host-profiler" not in roles  # never samples itself
    assert sum(r["share"] for r in roles.values()) == pytest.approx(
        1.0, abs=1e-3)
    assert roles["serve-pump"]["top"][0]["site"].startswith(
        "test_torch_fleet_obs.py:")
    (rec,) = [r for r in _records(rl.path) if r["ev"] == "hostprof"]
    assert rec["roles"]["serve-pump"]["samples"] \
        == roles["serve-pump"]["samples"]


# ---------------------------------------------------------------------------
# rendering and the CLI
# ---------------------------------------------------------------------------


def test_render_status_matches_jax(tmp_path):
    statuses, _tables, _recs = _collector_run(PORT, tmp_path, 2)
    statuses += [{"replicas": [], "fleet": {}, "alerts": []}, {}]
    for st in statuses:
        assert tfleet.render_status(st) == jfleet.render_status(st)


def test_fleet_cli_runlog_mode(tmp_path, capsys):
    statuses, _tables, _recs = _collector_run(PORT, tmp_path, 3)
    path = tmp_path / f"{tfleet.__name__}.jsonl"
    assert tfleet.main(["--runlog", str(path)]) == 0
    out = capsys.readouterr().out
    assert jfleet.main(["--runlog", str(path)]) == 0
    assert capsys.readouterr().out == out
    assert "fleet: alive 1/2" in out
    assert tfleet.main(["--runlog", str(path), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["replicas"] == statuses[-1]["replicas"]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert tfleet.main(["--runlog", str(empty)]) == 1
    # and as the documented module CLI, in a process of its own
    proc = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "sparksched_tpu_torch.obs.fleet", "--runlog", str(path)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == out
