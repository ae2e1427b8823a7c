"""The network serving front: requests arrive as bytes (counterpart of
`sparksched_tpu/serve/server.py`).

A thin HTTP/1.1 + JSON wire (stdlib `http.server` / `http.client`,
keep-alive connections, one JSON object per request and reply) over
the serving stack. A `SessionStore` is single-threaded by design, so
handler threads never touch it: every handler enqueues an op and
waits on its event; ONE pump thread (`serve-pump`) owns the store and
the batching front and runs the same submit/poll loop `run_open_loop`
runs in-process.

Wire surface (bodies JSON):

- ``POST /v1/session``  ``{"tenant": int, "seed": int?}`` ->
  ``{"sid": n}``; 429 when the tenant's session quota or the store's
  capacity is exhausted (`serve_capacity_rejections`).
- ``POST /v1/decide``   ``{"sid": n}`` -> `ServeResult.to_dict()`
  (+ ``spans_ms`` under tracing, + ``replica`` behind a router); 429
  over the tenant's in-flight quota (`serve_requests_rejected`), 404
  unknown or closed session, 409 quarantined.
- ``POST /v1/close``    ``{"sid": n}`` -> ``{"closed": n}``.
- ``GET /metrics``      Prometheus text of the store's and the
  server's `MetricsRegistry`; behind a router, the merged totals and
  then each replica's own series labeled `replica="N"`.
- ``GET /healthz``      liveness + scalar stats.
- ``GET /fleet``        the fleet collector's scoreboard (404 without
  one).

The backend is duck-typed: an in-process `(SessionStore, front)` pair
or a `serve.router.Router` passed as both (its `poll` also ships the
replicas' ring chunks). Admission control runs ON the pump thread, so
quota state needs no locks. The fleet collector's scrapes ride the pump
thread too, and the host profiler brackets the server's lifetime. `ServeClient` speaks the same
duck-typed store and front protocols as the in-process stack, so
`run_open_loop(client, client, ...)` drives a server over the wire; it
brackets the server's spans with `wire_submit`/`wire_reply`.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..obs.critpath import SEG_HIST, decompose
from ..obs.tracing import RequestTrace
from ..ownership import assert_owner
from .session import (
    RemoteResult,
    _check_keys,
    SessionError,
    SessionQuarantined,
    front_from_config,
    store_from_config,
)

_JSON = "application/json"
_PROM = "text/plain; version=0.0.4; charset=utf-8"


class _Op:
    """One queued wire op, owned by a handler thread until the pump
    fills `status`/`payload` and sets `event`."""

    __slots__ = ("kind", "body", "event", "status", "payload")

    def __init__(self, kind: str, body: dict[str, Any]) -> None:
        self.kind = kind
        self.body = body
        self.event = threading.Event()
        self.status = 500
        self.payload: Any = {"error": "unhandled", "etype": ""}


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "ServeServer"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: one conn, many ops
    server_version = "sparksched-serve/18"
    # Nagle + delayed ACK turns the handler's small unbuffered writes
    # into ~40 ms stalls per response on loopback keep-alive — measured
    # 43.8 ms/healthz round-trip with it on, sub-ms with it off
    disable_nagle_algorithm = True

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # the runlog/metrics are the observability surface

    def _reply(self, status: int, payload: Any,
               ctype: str = _JSON) -> None:
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        srv: ServeServer = self.server.owner
        if self.path == "/metrics":
            op = srv._submit_op("metrics", {})
            self._reply(op.status, op.payload["text"].encode(), _PROM)
        elif self.path == "/healthz":
            op = srv._submit_op("healthz", {})
            self._reply(op.status, op.payload)
        elif self.path == "/fleet":
            op = srv._submit_op("fleet", {})
            self._reply(op.status, op.payload)
        else:
            self._reply(404, {"error": f"unknown path {self.path}",
                              "etype": "KeyError"})

    def do_POST(self) -> None:
        srv: ServeServer = self.server.owner
        kind = {"/v1/session": "create", "/v1/decide": "decide",
                "/v1/close": "close"}.get(self.path)
        if kind is None:
            self._reply(404, {"error": f"unknown path {self.path}",
                              "etype": "KeyError"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}",
                              "etype": type(e).__name__})
            return
        op = srv._submit_op(kind, body)
        self._reply(op.status, op.payload)


class ServeServer:
    """The HTTP front over one serving backend: an in-process
    `(SessionStore, front)` pair, or a `Router` passed as both.
    `on_poll` is called once per pump iteration, between serve calls
    (where a weight publisher hangs). `collector` (a `FleetCollector`)
    scrapes on the pump thread and answers `/fleet`; `hostprof` (a
    `HostProfiler`) samples from `start()` to `stop()`."""

    def __init__(self, store, front, *, host: str = "127.0.0.1",
                 port: int = 0, quota_sessions: int = 0,
                 quota_inflight: int = 0, metrics=None, runlog=None,
                 on_poll=None, collector=None, hostprof=None,
                 op_timeout_s: float = 120.0) -> None:
        self.store = store
        self.front = front
        self.host = host
        self.requested_port = int(port)
        self.port: int | None = None
        self.quota_sessions = int(quota_sessions)
        self.quota_inflight = int(quota_inflight)
        self.metrics = metrics
        self.runlog = runlog
        self.on_poll = on_poll
        # rides THIS pump thread (`maybe_scrape` between polls): the
        # store or router stays single-owner
        self.collector = collector
        # brackets the server's lifetime; None: never sampled, no cost
        self.hostprof = hostprof
        # a router `server_from_config` spawned: stopped with the server
        self._owned_backend = None
        self.op_timeout_s = float(op_timeout_s)
        self._q: queue.Queue[_Op] = queue.Queue()
        self._stop = threading.Event()
        self._httpd: _HTTPServer | None = None
        self._threads: list[threading.Thread] = []
        # pump-thread-only state (no locks by construction)
        self._tenant_of: dict[int, int] = {}
        self._sessions_by_tenant: dict[int, int] = {}
        self._inflight_by_tenant: dict[int, int] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeServer":
        self._httpd = _HTTPServer(
            (self.host, self.requested_port), _Handler)
        self._httpd.owner = self
        self.port = self._httpd.server_address[1]
        t_http = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="serve-http", daemon=True,
        )
        t_pump = threading.Thread(
            target=self._pump, name="serve-pump", daemon=True)
        self._threads = [t_http, t_pump]
        for t in self._threads:
            t.start()
        if self.hostprof is not None:
            self.hostprof.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        self._threads = []
        if self.hostprof is not None:
            # after the join: the tables cover the serving threads'
            # whole lifetime
            self.hostprof.stop()
        if self._owned_backend is not None:
            self._owned_backend.stop()

    def __enter__(self) -> "ServeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- handler side ------------------------------------------------------

    def _submit_op(self, kind: str, body: dict[str, Any]) -> _Op:
        op = _Op(kind, body)
        self._q.put(op)
        if not op.event.wait(self.op_timeout_s):
            op.status = 504
            op.payload = {"error": f"{kind} timed out server-side",
                          "etype": "TimeoutError"}
        return op

    # -- pump thread -------------------------------------------------------

    def _pump(self) -> None:
        tracked: list[tuple[_Op, Any, int]] = []
        while not (self._stop.is_set() and self._q.empty()
                   and not tracked):
            busy = bool(tracked) or bool(self.front.pending)
            try:
                op = self._q.get(timeout=2e-4 if busy else 0.02)
            except queue.Empty:
                op = None
            while op is not None:
                self._handle_op(op, tracked)
                try:
                    op = self._q.get_nowait()
                except queue.Empty:
                    op = None
            try:
                if self.on_poll is not None:
                    self.on_poll()
                self.front.poll()
                if self.collector is not None:
                    self.collector.maybe_scrape()
            except Exception:  # keep pumping: one bad poll must not
                self._count("serve_http_errors")  # strand handlers
                time.sleep(0.01)
            still: list[tuple[_Op, Any, int]] = []
            for op, tk, tenant in tracked:
                if tk.ready:
                    self._finish_decide(op, tk, tenant)
                else:
                    still.append((op, tk, tenant))
            tracked = still

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name)

    def _reject(self, op: _Op, counter: str, msg: str) -> None:
        self._count(counter)
        op.status = 429
        op.payload = {"error": msg, "etype": "RuntimeError"}
        op.event.set()

    def _handle_op(self, op: _Op, tracked: list) -> None:
        assert_owner(self, "serve-pump")
        self._count("serve_http_requests")
        try:
            handler = {
                "create": self._op_create, "decide": self._op_decide,
                "close": self._op_close, "metrics": self._op_metrics,
                "healthz": self._op_healthz, "fleet": self._op_fleet,
            }[op.kind]
            handler(op, tracked)
        except Exception as e:  # never kill the pump on one bad op
            self._count("serve_http_errors")
            if isinstance(e, SessionQuarantined):
                op.status = 409
            elif isinstance(e, SessionError):
                op.status = 404
            else:
                op.status = 500
            op.payload = {"error": str(e), "etype": type(e).__name__}
            op.event.set()

    def _op_create(self, op: _Op, tracked: list) -> None:
        tenant = int(op.body.get("tenant", 0))
        if (self.quota_sessions > 0
                and self._sessions_by_tenant.get(tenant, 0)
                >= self.quota_sessions):
            # per-create admission rejection: same unit as the
            # store's own counter (one per failed create)
            self._reject(
                op, "serve_capacity_rejections",
                f"tenant {tenant} at its session quota "
                f"({self.quota_sessions})",
            )
            return
        try:
            sid = self.store.create(seed=op.body.get("seed"))
        except RuntimeError as e:
            # the store already counted its serve_capacity_rejections
            op.status = 429
            op.payload = {"error": str(e), "etype": "RuntimeError"}
            op.event.set()
            return
        self._tenant_of[sid] = tenant
        self._sessions_by_tenant[tenant] = (
            self._sessions_by_tenant.get(tenant, 0) + 1)
        op.status = 200
        op.payload = {"sid": sid, "tenant": tenant}
        op.event.set()

    def _op_decide(self, op: _Op, tracked: list) -> None:
        sid = int(op.body["sid"])
        tenant = self._tenant_of.get(sid)
        if tenant is None:
            op.status = 404
            op.payload = {
                "error": f"unknown or closed session {sid}",
                "etype": "SessionError",
            }
            op.event.set()
            return
        if (self.quota_inflight > 0
                and self._inflight_by_tenant.get(tenant, 0)
                >= self.quota_inflight):
            # per-request rejection: turned-away traffic, the
            # loadgen's `serve_requests_rejected` unit
            self._reject(
                op, "serve_requests_rejected",
                f"tenant {tenant} at its in-flight quota "
                f"({self.quota_inflight})",
            )
            return
        self._inflight_by_tenant[tenant] = (
            self._inflight_by_tenant.get(tenant, 0) + 1)
        try:
            tk = self.front.submit(sid)
        except BaseException:
            # a failed submit never became in-flight: release the
            # quota slot or the tenant leaks budget permanently (the
            # generic 500 handler knows nothing about the increment) —
            self._inflight_by_tenant[tenant] = max(
                0, self._inflight_by_tenant.get(tenant, 1) - 1)
            raise
        tracked.append((op, tk, tenant))

    def _finish_decide(self, op: _Op, tk, tenant: int) -> None:
        self._inflight_by_tenant[tenant] = max(
            0, self._inflight_by_tenant.get(tenant, 1) - 1)
        if tk.error is not None:
            self._count("serve_http_errors")
            if isinstance(tk.error, SessionQuarantined):
                op.status = 409
            elif isinstance(tk.error, SessionError):
                op.status = 404
            else:
                op.status = 500
            op.payload = {"error": str(tk.error),
                          "etype": type(tk.error).__name__}
        else:
            op.status = 200
            op.payload = tk.result.to_dict()
            spans = (tk.trace.offsets_ms() if tk.trace is not None
                     else getattr(tk.result, "spans_ms", None))
            if spans:
                op.payload["spans_ms"] = spans
        op.event.set()

    def _op_close(self, op: _Op, tracked: list) -> None:
        sid = int(op.body["sid"])
        tenant = self._tenant_of.pop(sid, None)
        if tenant is None:
            op.status = 404
            op.payload = {
                "error": f"unknown or closed session {sid}",
                "etype": "SessionError",
            }
            op.event.set()
            return
        self._sessions_by_tenant[tenant] = max(
            0, self._sessions_by_tenant.get(tenant, 1) - 1)
        self.store.close(sid)
        op.status = 200
        op.payload = {"closed": sid}
        op.event.set()

    def _op_metrics(self, op: _Op, tracked: list) -> None:
        from ..obs.metrics import MetricsRegistry

        if hasattr(self.store, "replica_samples"):
            # a router: the merged totals first, then each replica's own
            # series labeled `replica="N"`
            from ..obs.fleet import labeled_prometheus

            extra = MetricsRegistry()
            own = getattr(self.store, "metrics", None)
            if own is not None:
                extra.merge(own)
            if self.metrics is not None:
                extra.merge(self.metrics)
            op.status = 200
            op.payload = {"text": labeled_prometheus(
                self.store.replica_samples(), extra=extra)}
            op.event.set()
            return
        agg = MetricsRegistry()
        back = getattr(self.store, "metrics", None)
        if back is not None:
            agg.merge(back)
        if self.metrics is not None:
            agg.merge(self.metrics)
        op.status = 200
        op.payload = {"text": agg.to_prometheus()}
        op.event.set()

    def _op_fleet(self, op: _Op, tracked: list) -> None:
        """The `/fleet` scoreboard: the collector's last status (scraping
        now if there is none yet), on the pump thread like every op."""
        if self.collector is None:
            op.status = 404
            op.payload = {"error": "no fleet collector configured "
                                   "(serve: collect: true)",
                          "etype": "KeyError"}
            op.event.set()
            return
        from ..obs.fleet import _json_safe

        op.status = 200
        op.payload = _json_safe(self.collector.fleet_status())
        op.event.set()

    def _op_healthz(self, op: _Op, tracked: list) -> None:
        stats = getattr(self.store, "stats", {})
        op.status = 200
        op.payload = {
            "ok": True,
            "pending": int(self.front.pending),
            "front": getattr(self.front, "front_name", "unknown"),
            "stats": {k: v for k, v in stats.items()
                      if isinstance(v, (int, float))},
        }
        op.event.set()


class WireTicket:
    """`Ticket`'s client twin: resolved by a `ServeClient` worker
    thread when the HTTP reply lands. Under tracing it carries the
    client-side `RequestTrace` bracketed by `wire_submit`/
    `wire_reply`, with the server's spans re-anchored in between."""

    __slots__ = ("session_id", "submitted_at", "result", "error",
                 "trace", "_done")

    def __init__(self, session_id: int, traced: bool) -> None:
        self.session_id = session_id
        self.submitted_at = time.perf_counter()
        self.result: RemoteResult | None = None
        self.error: Exception | None = None
        self.trace: RequestTrace | None = None
        self._done = threading.Event()
        if traced:
            self.trace = RequestTrace()
            self.trace.stamp("wire_submit", self.submitted_at)

    @property
    def ready(self) -> bool:
        return self._done.is_set()


class ServeClient:
    """Wire client speaking the same duck-typed store + front
    protocols the in-process stack speaks, so `run_open_loop(client,
    client, ...)` drives a remote server with latency still clocked
    from SCHEDULED arrival: `create`/`close` are synchronous HTTP
    round-trips (the store facade), `submit` hands the request to a
    small worker pool holding persistent keep-alive connections (the
    front facade — `poll` is a no-op because resolution is push-based,
    `flush` waits the in-flight set out).

    Error mapping mirrors the in-process contract: 429 -> RuntimeError
    (capacity/quota — rotation handles it), 404 -> SessionError,
    409 -> SessionQuarantined."""

    front_name = "http"

    def __init__(self, host: str, port: int, *, tenant: int = 0,
                 workers: int = 4, metrics=None, runlog=None,
                 trace: bool = False, timeout_s: float = 60.0) -> None:
        self.host = host
        self.port = int(port)
        self.tenant = int(tenant)
        self.metrics = metrics
        self.runlog = runlog
        self.trace = bool(trace)
        self.timeout_s = float(timeout_s)
        self._outbox: queue.Queue[WireTicket | None] = queue.Queue()
        self._n_inflight = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._sync_conn: HTTPConnection | None = None
        self._sync_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker,
                             name=f"serve-client-{i}", daemon=True)
            for i in range(max(1, int(workers)))
        ]
        for t in self._workers:
            t.start()

    # -- raw HTTP ----------------------------------------------------------

    def _connect(self) -> HTTPConnection:
        conn = HTTPConnection(self.host, self.port,
                              timeout=self.timeout_s)
        conn.connect()
        # mirror the server handler's disable_nagle_algorithm: the
        # request side has the same small-write + delayed-ACK hazard
        conn.sock.setsockopt(
            socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _request(self, conn: HTTPConnection, method: str, path: str,
                 body: dict[str, Any] | None) -> tuple[int, dict]:
        payload = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": _JSON} if payload else {}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            decoded = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            decoded = {"error": raw.decode(errors="replace"),
                       "etype": "RuntimeError"}
        return resp.status, decoded

    def _sync_request(self, method: str, path: str,
                      body: dict[str, Any] | None
                      ) -> tuple[int, dict]:
        with self._sync_lock:
            for attempt in (0, 1):
                if self._sync_conn is None:
                    self._sync_conn = self._connect()
                try:
                    return self._request(
                        self._sync_conn, method, path, body)
                except (ConnectionError, OSError):
                    # stale keep-alive: reconnect once, then raise
                    self._sync_conn.close()
                    self._sync_conn = None
                    if attempt:
                        raise
        raise RuntimeError("unreachable")

    @staticmethod
    def _error_for(status: int, decoded: dict) -> Exception:
        etype = decoded.get("etype", "")
        msg = decoded.get("error", f"HTTP {status}")
        if status == 409 or etype == "SessionQuarantined":
            return SessionQuarantined(msg)
        if status == 404 or etype in ("SessionError", "ReplicaDied"):
            return SessionError(msg)
        return RuntimeError(msg)

    # -- store facade ------------------------------------------------------

    def create(self, seed: int | None = None,
               tenant: int | None = None) -> int:
        status, decoded = self._sync_request("POST", "/v1/session", {
            "tenant": self.tenant if tenant is None else int(tenant),
            "seed": seed,
        })
        if status != 200:
            raise self._error_for(status, decoded)
        return int(decoded["sid"])

    def close(self, sid: int) -> None:
        status, decoded = self._sync_request(
            "POST", "/v1/close", {"sid": sid})
        if status != 200:
            raise self._error_for(status, decoded)

    def healthz(self) -> dict[str, Any]:
        status, decoded = self._sync_request("GET", "/healthz", None)
        if status != 200:
            raise self._error_for(status, decoded)
        return decoded

    def metrics_text(self) -> str:
        with self._sync_lock:
            if self._sync_conn is None:
                self._sync_conn = self._connect()
            self._sync_conn.request("GET", "/metrics")
            resp = self._sync_conn.getresponse()
            return resp.read().decode()

    # -- front facade ------------------------------------------------------

    def submit(self, sid: int) -> WireTicket:
        tk = WireTicket(sid, traced=self.trace)
        with self._lock:
            self._n_inflight += 1
        self._outbox.put(tk)
        return tk

    @property
    def pending(self) -> int:
        with self._lock:
            return self._n_inflight

    def poll(self) -> bool:
        return False  # push-based: worker threads resolve tickets

    def flush(self, timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._n_inflight > 0:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    raise RuntimeError(
                        f"flush: {self._n_inflight} request(s) still "
                        f"in flight after {timeout_s:g}s"
                    )
                self._idle.wait(budget)

    def stop(self) -> None:
        for _ in self._workers:
            self._outbox.put(None)
        for t in self._workers:
            t.join(timeout=10.0)
        with self._sync_lock:
            if self._sync_conn is not None:
                self._sync_conn.close()
                self._sync_conn = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- worker side -------------------------------------------------------

    def _worker(self) -> None:
        conn: HTTPConnection | None = None
        while True:
            tk = self._outbox.get()
            if tk is None:
                if conn is not None:
                    conn.close()
                return
            try:
                for attempt in (0, 1):
                    if conn is None:
                        conn = self._connect()
                    try:
                        status, decoded = self._request(
                            conn, "POST", "/v1/decide",
                            {"sid": tk.session_id})
                        break
                    except (ConnectionError, OSError):
                        conn.close()
                        conn = None
                        if attempt:
                            raise
            except Exception as e:
                tk.error = e
                self._resolve(tk, None)
                continue
            if status != 200:
                # NOTE: a 429 is counted by the SERVER's registry
                # (`serve_requests_rejected`), never here — the
                # client-side counter of the same name belongs to the
                # loadgen's no-session rejections, and the open-loop
                # reconcile block asserts it moves in lockstep with
                # the summary (double-counting would trip it)
                tk.error = self._error_for(status, decoded)
            else:
                tk.result = RemoteResult(decoded)
            self._resolve(tk, decoded if status == 200 else None)

    def _resolve(self, tk: WireTicket, decoded: dict | None) -> None:
        if tk.trace is not None:
            spans = (decoded or {}).get("spans_ms")
            if spans:
                # re-anchor: server `submit` coincides with the
                # client's `wire_submit` (offsets, never one clock
                # across two processes — see obs/tracing.py)
                base = tk.trace.spans["wire_submit"]
                for k, v in spans.items():
                    tk.trace.spans[k] = base + float(v) / 1e3
            tk.trace.stamp("wire_reply")
            s = tk.trace.spans
            wire_total = (s["wire_reply"] - s["wire_submit"]) * 1e3
            if self.metrics is not None:
                self.metrics.counter("serve_requests_total")
                if tk.error is not None:
                    self.metrics.counter("serve_request_errors")
                self.metrics.observe(
                    "serve_span_wire_total_ms", wire_total)
                if "submit" in s and "reply" in s:
                    self.metrics.observe(
                        "serve_span_wire_ms",
                        wire_total - (s["reply"] - s["submit"]) * 1e3,
                    )
                # client-side attribution over the
                # re-anchored walk — the pure decomposition feeding
                # the (locked) registry. No analyzer here: resolve
                # runs on EVERY client worker thread, and the
                # analyzer is single-owner by design; a 429/transport
                # failure (wire brackets only) lands its whole wall
                # in the `wire_submit` segment by the telescoping
                # rule, which is exactly where a rejected request
                # spent it.
                for seg, ms in decompose(s)["segments"].items():
                    self.metrics.observe(SEG_HIST[seg], ms)
            if self.runlog is not None:
                self.runlog.trace(
                    tk.trace.trace_id, tk.trace.offsets_ms(),
                    session_id=tk.session_id,
                    params_version=(
                        None if tk.result is None
                        else tk.result.params_version
                    ),
                    error=None if tk.error is None
                    else type(tk.error).__name__,
                )
        elif self.metrics is not None:
            self.metrics.counter("serve_requests_total")
            if tk.error is not None:
                self.metrics.counter("serve_request_errors")
        with self._idle:
            self._n_inflight -= 1
            tk._done.set()
            if self._n_inflight == 0:
                self._idle.notify_all()


def server_from_config(
    cfg: dict[str, Any] | None,
    params,
    bank,
    scheduler,
    *,
    replica_spec=None,
    device="cuda",
    **overrides: Any,
) -> ServeServer:
    """Build the network front a `serve:` YAML block names, fail-loud
    against `config.SERVE_KEYS`. `replicas: 0` (the default) serves an
    in-process store and front (on `device`, the card unless the caller
    asks for the CPU) behind the HTTP listener; `replicas: N` needs a
    `ReplicaSpec` (`replica_spec=`) naming the builder each replica
    process rebuilds the stack from (`params` / `bank` / `scheduler` are
    used only in process; the replicas' device is the spec's).
    `collect: true` attaches the fleet collector (with the `slo:`
    monitor), `hostprof: true` the host profiler. The caller `start()`s
    (or context-manages) the returned server."""
    cfg = dict(cfg or {})
    _check_keys(cfg)
    replicas = int(cfg.get("replicas", 0))
    net_kw = {
        "host": str(cfg.get("host", "127.0.0.1")),
        "port": int(cfg.get("port", 0)),
        "quota_sessions": int(cfg.get("quota_sessions", 0)),
        "quota_inflight": int(cfg.get("quota_inflight", 0)),
    }
    net_kw.update(overrides)
    # an `slo:` block without the collector would be silently disarmed
    collect = bool(cfg.get("collect", False))
    if cfg.get("slo") and not collect:
        raise ValueError(
            "serve: slo: needs collect: true (the SLO monitor is "
            "evaluated by the fleet collector's scrape loop)"
        )

    def _attach_collector(backend, front=None) -> None:
        if not collect:
            return
        from ..obs.fleet import FleetCollector
        from ..obs.slo import slo_from_config

        runlog = net_kw.get("runlog")
        monitor = slo_from_config(
            cfg.get("slo"), rollback=backend, runlog=runlog)
        net_kw["collector"] = FleetCollector(
            backend,
            period_s=float(cfg.get("collect_period_s", 1.0)),
            runlog=runlog, slo=monitor,
            # the in-process front's attribution analyzer enriches the
            # fleet window (behind a router the replicas' segment
            # histograms arrive through the scraped registries)
            critpath=getattr(front, "critpath", None),
        )

    if bool(cfg.get("hostprof", False)) and "hostprof" not in net_kw:
        from ..obs.hostprof import HostProfiler

        net_kw["hostprof"] = HostProfiler(runlog=net_kw.get("runlog"))

    if replicas > 0:
        from .router import Router

        if replica_spec is None:
            raise ValueError(
                f"serve: replicas: {replicas} needs a ReplicaSpec "
                "(pass replica_spec=): replica processes REBUILD the "
                "stack from its builder, they cannot adopt live "
                "params/bank/scheduler objects"
            )
        router = Router(replica_spec, replicas=replicas)
        try:
            _attach_collector(router)
            server = ServeServer(router, router, **net_kw)
            server._owned_backend = router
            return server
        except BaseException:
            router.stop()
            raise
    store_cfg = {k: v for k, v in cfg.items()
                 if k not in ("host", "port", "replicas",
                              "quota_sessions", "quota_inflight",
                              "collect", "collect_period_s", "slo",
                              "hostprof")}
    store = store_from_config(store_cfg, params, bank, scheduler,
                              device=device)
    front = front_from_config(store_cfg, store)
    if getattr(front, "critpath", None) is not None:
        # tail exemplars flow to the server's run log without turning
        # on the per-request `trace` record firehose
        front.critpath.runlog = net_kw.get("runlog")
    _attach_collector(store, front)
    return ServeServer(store, front, **net_kw)
