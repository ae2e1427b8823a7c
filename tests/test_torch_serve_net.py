"""The port's HTTP front (`serve/server.py`) on the CPU, at the small
setup of tests/test_serve.py: decisions through the wire equal an
in-process store's at the same seeds bit for bit, per-tenant quotas
answer 429 with the two rejection counters kept apart, `/metrics` and
`/healthz` answer, the wire client's open loop reconciles, and
`server_from_config` refuses what the JAX package refuses (`shard_dp`
is not ported and raises)."""

from __future__ import annotations

import pytest

from sparksched_tpu_torch.obs.metrics import MetricsRegistry
from sparksched_tpu_torch.serve import (
    ContinuousBatcher,
    SessionError,
    SessionStore,
    generate_arrivals,
    run_open_loop,
)
from sparksched_tpu_torch.serve.server import (
    ServeClient,
    ServeServer,
    server_from_config,
)

from ._torch_parity import serve_setup
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup():
    return serve_setup()[1]


def _store(setup, **kw) -> SessionStore:
    tp, tb, ts = setup
    kw = dict(capacity=6, max_batch=3, seed=0) | kw
    return SessionStore(tp, tb, ts, device="cpu", **kw)


@pytest.fixture(scope="module")
def http_stack(setup):
    """A paged store behind a loopback HTTP front, and a traced client."""
    reg = MetricsRegistry()
    store = _store(setup, hot_capacity=4, groups=2, max_batch=2,
                   metrics=reg, trace=True)
    front = ContinuousBatcher(store, metrics=reg, trace=True)
    server = ServeServer(store, front, metrics=MetricsRegistry()).start()
    client = ServeClient("127.0.0.1", server.port,
                         metrics=MetricsRegistry(), trace=True)
    yield store, front, server, client
    client.stop()
    server.stop()


def test_http_decisions_equal_in_process(setup, http_stack):
    """A sequential client gets the decision sequence an in-process twin
    store gives at the same seeds, every field bit-equal, and the
    server's spans ride each reply."""
    store, _front, _server, client = http_stack
    twin = _store(setup, hot_capacity=4, groups=2, max_batch=2)
    twin._calls = store._calls
    sids = [client.create(seed=40 + i) for i in range(6)]
    assert [twin.create(seed=40 + i) for i in range(6)] == sids
    for rnd in range(3):
        for sid in sids:
            tk = client.submit(sid)
            client.flush()
            assert tk.error is None
            want = twin.decide(sid).to_dict()
            got = tk.result.to_dict()
            assert {k: got[k] for k in want} == want, (rnd, sid)
            spans = tk.trace.spans
            assert {"wire_submit", "submit", "dispatch", "reply",
                    "wire_reply"} <= set(spans)
    assert store.stats["serve_page_outs"] > 0
    for sid in sids:
        client.close(sid)
    tk = client.submit(sids[0])
    client.flush()
    assert isinstance(tk.error, SessionError)


def test_http_metrics_and_healthz(http_stack):
    _store_, front, _server, client = http_stack
    sid = client.create(seed=11)
    tk = client.submit(sid)
    client.flush()
    assert tk.error is None
    text = client.metrics_text()
    assert "# TYPE" in text and "_count" in text
    assert "serve_requests_total" in text
    assert "serve_http_requests" in text
    assert "serve_page_outs" in text or "serve_page_ins" in text
    h = client.healthz()
    assert h["ok"] is True and h["front"] == front.front_name
    assert h["stats"]["serve_decisions"] >= 1
    client.close(sid)


def test_open_loop_client_mode_reconciles(http_stack):
    _store_, _front, _server, client = http_stack
    arrivals = generate_arrivals(200.0, 40, 3, seed=5)
    out = run_open_loop(client, client, arrivals, slo_ms=1000.0,
                        session_seed=900)
    assert out["front"] == "http"
    assert out["completed"] + out["capacity_rejections"] == 40
    assert out["reconcile"]["requests"] == 40
    assert out["reconcile"]["served"] == out["completed"]
    assert out["errors"] == 0 and out["hist"].count == out["completed"]


def test_http_quotas_429_counters_distinct(setup):
    """A session quota rejects creates (`serve_capacity_rejections`, one
    per failed create), an in-flight quota rejects decides
    (`serve_requests_rejected`, one per request); another tenant is not
    collateral damage."""
    store = _store(setup, capacity=4, max_batch=2)
    reg = MetricsRegistry()
    with ServeServer(store, ContinuousBatcher(store), quota_sessions=1,
                     quota_inflight=2, metrics=reg) as server:
        with ServeClient("127.0.0.1", server.port) as client:
            sid = client.create(seed=1, tenant=5)
            with pytest.raises(RuntimeError, match="session quota"):
                client.create(seed=2, tenant=5)
            other = client.create(seed=3, tenant=6)
            assert reg.counters["serve_capacity_rejections"] == 1
            tks = [client.submit(sid) for _ in range(6)]
            client.flush()
            rejected = [t for t in tks if t.error is not None]
            assert rejected and len(rejected) < len(tks)
            assert all("in-flight quota" in str(t.error) for t in rejected)
            assert reg.counters["serve_requests_rejected"] == len(rejected)
            assert reg.counters["serve_capacity_rejections"] == 1
            assert store.stats["serve_capacity_rejections"] == 0
            client.close(sid)
            client.close(other)


@pytest.mark.parametrize("cfg,exc,match", [
    ({"replicas": 2}, ValueError, "needs a ReplicaSpec"),
    ({"collect": True, "slo": {"p99_mx": 5}}, ValueError, "unknown slo"),
    ({"slo": {"p99_ms": 5}}, ValueError, "needs collect"),
    ({"shard_dp": 2}, NotImplementedError, "shard_dp.*ROADMAP A12"),
    ({"prot": 1}, ValueError, "unknown serve"),
])
def test_server_from_config_refuses(setup, cfg, exc, match):
    tp, tb, ts = setup
    with pytest.raises(exc, match=match):
        server_from_config(cfg, tp, tb, ts, device="cpu")


def test_server_from_config_serves(setup):
    tp, tb, ts = setup
    cfg = {"capacity": 4, "max_batch": 2, "hot_capacity": 2, "port": 0,
           "host": "127.0.0.1", "quota_sessions": 0, "front": "linger",
           "linger_ms": 1}
    with server_from_config(cfg, tp, tb, ts, device="cpu") as server:
        assert server.front.front_name == "linger"
        assert server.store.hot_capacity == 2
        with ServeClient("127.0.0.1", server.port) as client:
            sid = client.create(seed=3)
            tk = client.submit(sid)
            client.flush()
            assert tk.error is None and tk.result.decided
