"""The port's open-loop load generator, streaming metrics and
critical-path attribution against the JAX package's: arrival schedules
equal exactly (Poisson and MMPP, from the same seeded numpy generator),
histogram summaries and percentile blocks equal on the same samples,
`critpath.decompose` and the analyzer's snapshot equal on spans
recorded from a traced port front; `run_open_loop` on a port store
reconciles its counters."""

from __future__ import annotations

import numpy as np
import pytest

from sparksched_tpu.obs import critpath as jax_critpath
from sparksched_tpu.obs import metrics as jax_metrics
from sparksched_tpu.serve.loadgen import generate_arrivals as jax_arrivals
from sparksched_tpu_torch.obs import critpath, metrics
from sparksched_tpu_torch.obs.metrics import MetricsRegistry
from sparksched_tpu_torch.serve import (
    ContinuousBatcher,
    MicroBatcher,
    SessionStore,
    generate_arrivals,
    run_open_loop,
)

from ._torch_parity import serve_setup
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("process,kw", [
    ("poisson", {}),
    ("mmpp", {"burst_factor": 8.0, "burst_fraction": 0.1,
              "burst_dwell_s": 0.5}),
    ("mmpp", {"burst_factor": 3.0, "burst_fraction": 0.3,
              "burst_dwell_s": 0.05}),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_arrivals_equal_jax(process, kw, seed):
    a = generate_arrivals(40.0, 3000, 64, process=process, seed=seed, **kw)
    b = jax_arrivals(40.0, 3000, 64, process=process, seed=seed, **kw)
    assert a == b
    assert a != generate_arrivals(40.0, 3000, 64, process=process,
                                  seed=seed + 1, **kw)


def test_arrivals_errors_equal_jax():
    for args, kw in (((10.0, 5, 2), {"process": "weibull"}),
                     ((0.0, 5, 2), {}),
                     ((10.0, 5, 2), {"process": "mmpp",
                                     "burst_factor": 1.0}),
                     ((10.0, 5, 2), {"process": "mmpp",
                                     "burst_fraction": 1.5})):
        with pytest.raises(ValueError) as ours:
            generate_arrivals(*args, **kw)
        with pytest.raises(ValueError) as theirs:
            jax_arrivals(*args, **kw)
        assert str(ours.value) == str(theirs.value)


def _samples() -> np.ndarray:
    rng = np.random.default_rng(11)
    return np.concatenate([rng.lognormal(2.0, 1.0, 4000),
                           [0.0, 1e-6, 3e7], rng.exponential(50.0, 500)])


def test_histograms_and_blocks_equal_jax():
    xs = _samples()
    assert metrics.hist_summary(xs) == jax_metrics.hist_summary(xs)
    assert (metrics.percentile_block(xs, reps=9)
            == jax_metrics.percentile_block(xs, reps=9))
    h, jh = metrics.StreamingHistogram(), jax_metrics.StreamingHistogram()
    h.add_many(xs[:3000])
    jh.add_many(xs[:3000])
    snap, jsnap = h.copy(), jh.copy()
    h.add_many(xs[3000:])
    jh.add_many(xs[3000:])
    assert h.summary("_ms") == jh.summary("_ms")
    assert h.delta(snap).summary() == jh.delta(jsnap).summary()
    assert h.nonzero_buckets() == jh.nonzero_buckets()
    assert h.count_above(100.0) == jh.count_above(100.0)
    reg, jreg = MetricsRegistry(), jax_metrics.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("serve_requests_total", 3)
        r.gauge("serve_inflight_depth", 2)
        for x in xs[:50]:
            r.observe("serve_span_total_ms", x)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    offs, ons = [1.0, 1.1, 0.9], [1.2, 1.0, 1.05]
    assert metrics.paired_ab_pct(offs, ons) == jax_metrics.paired_ab_pct(
        offs, ons)


@pytest.fixture(scope="module")
def store():
    tp, tb, ts = serve_setup()[1]
    return SessionStore(tp, tb, ts, capacity=6, hot_capacity=4, groups=2,
                        max_batch=2, seed=0, device="cpu")


def test_critpath_equals_jax_on_recorded_spans(store):
    """Spans recorded by a traced port front decompose as the JAX
    package decomposes them (segments summing to the wall), and the two
    analyzers fed the same spans give the same snapshot."""
    store.trace = True
    try:
        front = ContinuousBatcher(store, trace=True, depth=2)
        sids = [store.create(seed=60 + i) for i in range(4)]
        tickets = [front.submit(s) for _ in range(3) for s in sids]
        front.flush()
    finally:
        store.trace = False
        store.last_spans = None
    ana = critpath.CritPathAnalyzer()
    jana = jax_critpath.CritPathAnalyzer()
    for t in tickets:
        assert t.error is None
        spans = t.trace.spans
        assert {"submit", "batch_admit", "dispatch", "harvest",
                "device_compute", "scatter_back", "reply"} <= set(spans)
        d, jd = critpath.decompose(spans), jax_critpath.decompose(spans)
        assert d == jd
        assert abs(sum(d["segments"].values()) - d["wall_ms"]) < 1e-6
        offs = t.trace.offsets_ms()
        assert critpath.decompose(offs, scale_ms=1.0) == \
            jax_critpath.decompose(offs, scale_ms=1.0)
        ana.observe(offs, scale_ms=1.0, tenant=t.session_id)
        jana.observe(offs, scale_ms=1.0, tenant=t.session_id)
    assert ana.snapshot() == jana.snapshot()
    assert critpath.SEG_HIST == jax_critpath.SEG_HIST
    for s in sids:
        store.close(s)


@pytest.mark.parametrize("front", ["continuous", "pipelined", "linger"])
def test_run_open_loop_reconciles(store, front):
    """Every scheduled request is served or rejected, the counters
    reconcile, the histogram holds every served request, and the run
    closes its sessions behind itself."""
    reg = MetricsRegistry()
    store.metrics = reg
    try:
        fr = (MicroBatcher(store, linger_ms=1.0, metrics=reg)
              if front == "linger" else
              ContinuousBatcher(store, metrics=reg,
                                depth=2 if front == "pipelined" else 1))
        arrivals = generate_arrivals(150.0, 24, 5, seed=7)
        out = run_open_loop(store, fr, arrivals, slo_ms=10_000.0,
                            session_seed=30_000)
    finally:
        store.metrics = None
    assert out["front"] == front
    assert out["requests"] == out["completed"] + out["capacity_rejections"]
    assert out["completed"] == 24 and out["errors"] == 0
    assert out["good"] == 24 and out["hist"].count == 24
    assert len(out["samples_ms"]) == 24
    rec = out["reconcile"]
    assert rec["requests"] == 24 and rec["served"] == 24
    assert rec["serve_requests_rejected"] == 0
    assert reg.counters["serve_requests_total"] == 24
    assert store.stats["serve_sessions_live"] == 0
