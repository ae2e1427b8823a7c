"""Session-affinity scale-out: a router sharding sessions across N
replica processes, each a whole serving stack (counterpart of
`sparksched_tpu/serve/router.py`).

One `SessionStore` is single-threaded by contract, so scaling out means
PROCESSES: each replica owns its store, its batching front (the
config's `front:`), its pager and its `MetricsRegistry`, and drives its
device from its own host thread. Replicas are spawned (never forked: a
CUDA context does not survive a fork) and REBUILD their stack from a
builder (`ReplicaSpec.builder`), so a seeded builder gives every
replica the same weights bit for bit. Replica `i` serves on
`cuda:{i % device_count}`; on one card every replica shares it, each
with its own CUDA context (the contexts time-slice the card). A replica
asked for the card that finds none fails its boot, and the router
raises; no replica falls back to the CPU.

Affinity is structural: a session created on replica `i` gets the
global id `lsid * n + i`, so `replica_of(gsid) == gsid % n` for the
session's whole life. Replica DEATH fails the replica's sessions
(`ReplicaDied`, a `SessionError`) and never reroutes them: the session's
device state died with the process.

The router speaks both serving protocols, so the in-process consumers
work across the process boundary unchanged:

- the batching-front protocol (`submit` / `poll` / `flush` /
  `pending`) for `run_open_loop` and the HTTP front's pump;
- the store facade (`create` / `close` / `set_params` /
  `rollback_params` / `stats`) for session lifecycle and for
  `online.ParamBus`: a publish lands on EVERY replica as host numpy
  (never a CUDA tensor through a pipe), applied by each replica between
  calls.

Ring-on replicas park drained trajectory chunks (host numpy) in an
outbox; `ring_pump` fetches every replica's backlog in one round trip
each and feeds one `TrajectoryBuffer` with the session ids remapped to
the global space.

Kernel counters are per process: the parent's stay 0 for fleet calls,
and each replica reports its own (`kernel_counts`).
"""

from __future__ import annotations

import dataclasses
import importlib
import multiprocessing as mp
import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..obs.runlog import emit
from ..ownership import assert_owner
from .session import (
    RemoteResult,
    SessionError,
    SessionQuarantined,
)


class ReplicaDied(SessionError):
    """The replica owning this session exited: the session's device
    state is gone, so the session is FAILED, never rerouted."""


# error type names a replica may send back; anything else degrades to
# RuntimeError (the generic store failure class)
_ERROR_TYPES: dict[str, type[Exception]] = {
    "SessionError": SessionError,
    "SessionQuarantined": SessionQuarantined,
    "KeyError": SessionError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}

# `serve:` keys of the router and server layers: a replica's store and
# front never see them
_NET_KEYS = ("host", "port", "replicas", "quota_sessions",
             "quota_inflight", "collect", "collect_period_s", "slo",
             "hostprof")


# the poll-cadence ring sweep, and how long a fleet may take to boot
RING_PERIOD_S = 0.25
START_TIMEOUT_S = 300.0


def _rebuild_error(etype: str, msg: str) -> Exception:
    return _ERROR_TYPES.get(etype, RuntimeError)(msg)


@dataclass(frozen=True)
class ReplicaSpec:
    """Everything a replica process needs to rebuild a serving stack,
    picklable across a spawn. `builder` names a module-level callable
    (`"module.path:function"`) called as `builder(**builder_kwargs,
    device=<the replica's device>)` and returning `(env_params, bank,
    scheduler)` on that device; it must not need the parent's objects,
    so weights come from a seed or as numpy in `builder_kwargs`.

    `device`: `"cuda"` (replica i on `cuda:{i % device_count}`; a
    replica that finds no card fails its boot), `"cpu"` (the tests), or
    an explicit device string every replica uses.

    The kernels' shared objects are built once into
    `sparksched_tpu_torch/_build/` and loaded by every replica; build
    them before spawning a fleet, or concurrent first uses build them
    twice."""

    builder: str
    builder_kwargs: dict[str, Any] = field(default_factory=dict)
    serve_cfg: dict[str, Any] = field(default_factory=dict)
    trace: bool = False
    device: str = "cuda"


def resolve_builder(path: str):
    mod, sep, fn = path.partition(":")
    if not sep or not mod or not fn:
        raise ValueError(
            f"builder must be 'module.path:function', got {path!r}"
        )
    return getattr(importlib.import_module(mod), fn)


def _replica_device(spec: ReplicaSpec, idx: int):
    import torch

    if spec.device != "cuda":
        return torch.device(spec.device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"replica {idx} was asked for device 'cuda' and finds no "
            "CUDA device (pass device='cpu' to serve on the CPU)"
        )
    dev = torch.device("cuda", idx % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _poison_session(store, sid: int) -> None:
    """Test hook: NaN one resident session's per-job completion clock,
    so its next decision trips the health sentinel (the poison the
    in-process store tests inject), reachable across the process
    boundary so quarantine isolation is testable against a real
    fleet."""
    slot = int(store._slot_of[sid])
    if slot < 0:
        raise SessionError(f"session {sid} is not resident")
    g, local = divmod(slot, store.group_slots)
    store._stores[g].env.job_t_completed[local] = float("nan")


class _Outbox:
    """A ring-on replica's collector: the store's chunk and close
    hand-offs, appended in order to a list the router drains."""

    def __init__(self, out: list) -> None:
        self.out = out

    def ingest_chunk(self, chunk) -> None:
        self.out.append(("chunk", chunk))

    def on_close(self, sid: int, quarantined: bool = False) -> None:
        self.out.append(("close", int(sid), bool(quarantined)))


def _replica_main(conn, idx: int, spec: ReplicaSpec) -> None:
    """The replica process body: build the serving stack, handshake,
    then loop: drain pipe commands, pump the front, ship resolved
    tickets back. Runs until a `stop` command or pipe EOF."""
    try:
        t0 = time.perf_counter()
        import torch

        from ..kernels import kernel_counts
        from ..obs.metrics import MetricsRegistry
        from .session import front_from_config, store_from_config

        dev = _replica_device(spec, idx)
        params, bank, scheduler = resolve_builder(spec.builder)(
            **spec.builder_kwargs, device=str(dev)
        )
        registry = MetricsRegistry()
        cfg = {k: v for k, v in spec.serve_cfg.items()
               if k not in _NET_KEYS}
        store = store_from_config(
            cfg, params, bank, scheduler, metrics=registry,
            trace=spec.trace, device=dev,
        )
        front = front_from_config(
            cfg, store, metrics=registry, trace=spec.trace,
        )
        # a ring-on replica's collector parks drained chunks (host
        # numpy, in stream order) and close events here; the router's
        # `ring_pump` fetches the backlog in ONE `ring_chunks` round trip
        ring_out: list[tuple] = []
        if store._ring_on:
            store.collector = _Outbox(ring_out)
        info = {
            "capacity": store.capacity, "pid": os.getpid(),
            "front": front.front_name, "device": str(dev),
            "boot_s": time.perf_counter() - t0,
        }
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            info["cuda_allocated_bytes"] = torch.cuda.memory_allocated(dev)
            info["cuda_reserved_bytes"] = torch.cuda.memory_reserved(dev)
        conn.send(("ready", idx, info))
    except Exception as e:
        try:
            conn.send(("boot_error", idx, type(e).__name__, str(e)))
        finally:
            conn.close()
        return

    def reply(rid: int, payload: Any) -> None:
        conn.send(("reply", rid, payload))

    def reply_err(rid: int, e: Exception) -> None:
        conn.send(("reply_err", rid, type(e).__name__, str(e)))

    tracked: dict[int, Any] = {}  # rid -> Ticket
    stop = False
    try:
        while True:
            timeout = 0.0 if (tracked or front.pending) else 0.05
            while conn.poll(timeout):
                msg = conn.recv()
                op, rid = msg[0], msg[1]
                try:
                    if op == "submit":
                        tracked[rid] = front.submit(msg[2])
                    elif op == "create":
                        reply(rid, {"sid": store.create(seed=msg[2])})
                    elif op == "close":
                        store.close(msg[2])
                        reply(rid, {"closed": msg[2]})
                    elif op == "set_params":
                        _, _, p, version, origin, reason, good = msg
                        reply(rid, {"version": store.set_params(
                            {k: torch.from_numpy(v).to(dev)
                             for k, v in p.items()},
                            version=version, origin=origin,
                            reason=reason, mark_good=good,
                        )})
                    elif op == "rollback":
                        reply(rid, {
                            "version": store.rollback_params(msg[2])
                        })
                    elif op == "metrics":
                        reply(rid, (registry, dict(store.stats)))
                    elif op == "kernels":
                        reply(rid, kernel_counts())
                    elif op == "poison":
                        _poison_session(store, msg[2])
                        reply(rid, {"poisoned": msg[2]})
                    elif op == "ring_chunks":
                        # msg[2] (force) drains the device rings into
                        # the outbox first; otherwise ship what the
                        # normal triggers (cadence, idle harvest, close,
                        # swap) already landed there
                        if msg[2]:
                            store.drain_ring(wait=True)
                        ents = list(ring_out)
                        ring_out.clear()
                        reply(rid, ents)
                    elif op == "stop":
                        stop = True
                        front.flush()
                        store.drain_ring(wait=True)
                        reply(rid, {"stopped": idx})
                    else:
                        reply_err(rid, ValueError(
                            f"unknown replica op {op!r}"
                        ))
                except Exception as e:
                    reply_err(rid, e)
                timeout = 0.0
            front.poll()
            for rid in [r for r, t in tracked.items() if t.ready]:
                t = tracked.pop(rid)
                if t.error is not None:
                    conn.send(("result", rid, None,
                               (type(t.error).__name__, str(t.error))))
                else:
                    d = t.result.to_dict()
                    d["replica"] = idx
                    if t.trace is not None:
                        d["spans_ms"] = t.trace.offsets_ms()
                    conn.send(("result", rid, d, None))
            if stop and not tracked and not front.pending:
                return
    except (EOFError, BrokenPipeError, OSError):
        return  # the router side went away: exit quietly
    finally:
        conn.close()


class _Replica:
    __slots__ = ("idx", "proc", "conn", "dead", "sessions", "info")

    def __init__(self, idx, proc, conn) -> None:
        self.idx = idx
        self.proc = proc
        self.conn = conn
        self.dead = False
        self.sessions = 0  # live sessions, the placement load signal
        self.info: dict[str, Any] = {}


class RouterTicket:
    """`Ticket`'s fleet twin: resolved by `Router.poll` when the owning
    replica ships the result (or dies)."""

    __slots__ = ("session_id", "submitted_at", "result", "error",
                 "trace")

    def __init__(self, session_id: int) -> None:
        self.session_id = session_id
        self.submitted_at = time.perf_counter()
        self.result: RemoteResult | None = None
        self.error: Exception | None = None
        self.trace = None

    @property
    def ready(self) -> bool:
        return self.result is not None or self.error is not None


def _host_params(model_params) -> dict[str, np.ndarray]:
    """A state dict as host numpy (what crosses a pipe): a CUDA tensor is
    copied on the current stream, so a caller that made that stream wait
    on the writer's event (`ParamBus.pump`) gets the published bits."""
    out = {}
    for k, v in model_params.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


class Router:
    """The session-affinity fleet front. Construction SPAWNS `replicas`
    worker processes and blocks until every one handshakes ready
    (raising, and reaping the fleet, if any fails to boot)."""

    def __init__(self, spec: ReplicaSpec, replicas: int = 2, *,
                 metrics=None, runlog=None, collector=None) -> None:
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.spec = spec
        self.n = int(replicas)
        self.metrics = metrics
        self.runlog = runlog
        # the fleet-level trajectory sink (a `TrajectoryBuffer`:
        # `ingest_chunk` / `on_close`); every replica's ring chunks land
        # here with session ids in the global space
        self.collector = collector
        self._ring_next = 0.0
        self.front_name = f"router{self.n}"
        self.params_version = 0
        self.stats: dict[str, int] = {
            "serve_decisions": 0,
            "serve_quarantines": 0,
            "serve_capacity_rejections": 0,
            "serve_param_swaps": 0,
            "serve_param_rollbacks": 0,
            "serve_param_version": 0,
            "router_replica_deaths": 0,
            "router_sessions_failed": 0,
        }
        self._rid = 0
        self._tickets: dict[int, tuple[int, RouterTicket]] = {}
        self._replies: dict[int, tuple[Any, Exception | None]] = {}
        self._reply_owner: dict[int, int] = {}
        self._sid_map: dict[int, int] = {}  # gsid -> local sid
        self._failed: set[int] = set()
        self._stopped = False
        ctx = mp.get_context("spawn")
        self._replicas: list[_Replica] = []
        try:
            for i in range(self.n):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_replica_main, args=(child, i, spec),
                    daemon=True, name=f"serve-replica-{i}",
                )
                proc.start()
                child.close()
                self._replicas.append(_Replica(i, proc, parent))
            deadline = time.monotonic() + START_TIMEOUT_S
            for r in self._replicas:
                budget = deadline - time.monotonic()
                if budget <= 0 or not r.conn.poll(budget):
                    raise RuntimeError(
                        f"replica {r.idx} did not come up within "
                        f"{START_TIMEOUT_S:g}s"
                    )
                try:
                    msg = r.conn.recv()
                except (EOFError, OSError) as e:
                    raise RuntimeError(
                        f"replica {r.idx} died during boot (spawned "
                        "processes re-import __main__: run from a real "
                        "script or module, under `if __name__ == "
                        "'__main__'`)"
                    ) from e
                if msg[0] != "ready":
                    r.dead = True  # it closed its end after the report
                    raise RuntimeError(
                        f"replica {r.idx} failed to boot: "
                        f"{msg[2] if len(msg) > 2 else msg!r}: "
                        f"{msg[3] if len(msg) > 3 else ''}"
                    )
                r.info = msg[2]
        except BaseException:
            self.stop(timeout_s=5.0)
            raise
        emit(
            f"[router] fleet up: {self.n} replica(s), capacity "
            f"{sum(r.info.get('capacity', 0) for r in self._replicas)}"
            f" sessions, front {self._replicas[0].info.get('front')}, "
            f"device {self._replicas[0].info.get('device')}"
        )

    # -- plumbing ----------------------------------------------------------

    def replica_of(self, gsid: int) -> int:
        return gsid % self.n

    def replica_info(self) -> list[dict[str, Any]]:
        """Each replica's boot handshake: capacity, pid, front, device,
        boot seconds and (on the card) CUDA bytes after the boot."""
        return [dict(r.info, replica=r.idx, alive=not r.dead)
                for r in self._replicas]

    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    def _send(self, r: _Replica, msg: tuple) -> None:
        try:
            r.conn.send(msg)
        except (BrokenPipeError, OSError, EOFError):
            self._mark_dead(r)
            raise ReplicaDied(
                f"replica {r.idx} died (send failed)"
            ) from None

    def _mark_dead(self, r: _Replica) -> None:
        if r.dead:
            return
        r.dead = True
        self.stats["router_replica_deaths"] += 1
        try:
            r.conn.close()
        except OSError:
            pass
        # fail everything the replica owned: in-flight tickets error,
        # its sessions join the failed set, NOT rerouted
        failed_sids = [g for g in self._sid_map
                       if self.replica_of(g) == r.idx]
        for g in failed_sids:
            self._failed.add(g)
            del self._sid_map[g]
        self.stats["router_sessions_failed"] += len(failed_sids)
        for rid, (owner, tk) in list(self._tickets.items()):
            if owner == r.idx:
                tk.error = ReplicaDied(
                    f"replica {r.idx} died with the request in flight"
                )
                del self._tickets[rid]
        for rid, owner in list(self._reply_owner.items()):
            if owner == r.idx:
                self._replies[rid] = (None, ReplicaDied(
                    f"replica {r.idx} died before replying"
                ))
                del self._reply_owner[rid]
        if self.metrics is not None:
            self.metrics.counter("router_replica_deaths")
        emit(
            f"[router] replica {r.idx} died; {len(failed_sids)} "
            "session(s) marked failed (sessions are never rerouted)"
        )

    def _dispatch(self, r: _Replica, msg: tuple) -> bool:
        kind, rid = msg[0], msg[1]
        if kind == "result":
            owner_tk = self._tickets.pop(rid, None)
            if owner_tk is None:
                return False
            tk = owner_tk[1]
            if msg[3] is not None:
                tk.error = _rebuild_error(*msg[3])
            else:
                tk.result = RemoteResult(msg[2])
                self.stats["serve_decisions"] += 1
                if tk.result.health_mask:
                    self.stats["serve_quarantines"] += 1
            return True
        if kind == "reply":
            self._reply_owner.pop(rid, None)
            self._replies[rid] = (msg[2], None)
            return True
        if kind == "reply_err":
            self._reply_owner.pop(rid, None)
            self._replies[rid] = (None, _rebuild_error(msg[2], msg[3]))
            return True
        return False

    def _drain(self) -> bool:
        moved = False
        for r in self._replicas:
            if r.dead:
                continue
            try:
                while r.conn.poll(0):
                    moved |= self._dispatch(r, r.conn.recv())
            except (EOFError, BrokenPipeError, OSError):
                if self._stopped:  # clean shutdown: EOF is expected
                    r.dead = True
                else:
                    self._mark_dead(r)
                moved = True
                continue
            # a replica exiting AFTER its stop reply is a clean shutdown,
            # not a death: only an exit nobody asked for fails sessions
            if not self._stopped and not r.proc.is_alive():
                self._mark_dead(r)
                moved = True
        return moved

    def _call(self, r: _Replica, msg_tail: tuple,
              timeout_s: float = 120.0) -> Any:
        """One synchronous round trip to a replica (create / close /
        set_params / metrics ...). Results for OTHER requests keep
        flowing while it waits: the pipes are drained, not blocked."""
        rid = self._next_rid()
        self._reply_owner[rid] = r.idx
        self._send(r, (msg_tail[0], rid, *msg_tail[1:]))
        deadline = time.monotonic() + timeout_s
        while rid not in self._replies:
            self._drain()
            if rid in self._replies:
                break
            if time.monotonic() > deadline:
                del self._reply_owner[rid]
                raise RuntimeError(
                    f"replica {r.idx} did not answer {msg_tail[0]!r} "
                    f"within {timeout_s:g}s"
                )
            time.sleep(2e-4)
        payload, err = self._replies.pop(rid)
        if err is not None:
            raise err
        return payload

    def _alive(self) -> list[_Replica]:
        return [r for r in self._replicas if not r.dead]

    # -- store facade ------------------------------------------------------

    def create(self, seed: int | None = None) -> int:
        """Place a new session on the least-loaded live replica; returns
        the GLOBAL session id (`gsid % n` names the owner for the
        session's whole life). Raises RuntimeError when the fleet is out
        of capacity, as a store does."""
        alive = self._alive()
        if not alive:
            self.stats["serve_capacity_rejections"] += 1
            raise RuntimeError("serve fleet has no live replicas")
        for r in sorted(alive, key=lambda r: r.sessions):
            try:
                payload = self._call(r, ("create", seed))
            except ReplicaDied:
                continue
            except RuntimeError as e:
                if "full" in str(e):
                    continue  # try the next-least-loaded replica
                raise
            lsid = payload["sid"]
            gsid = lsid * self.n + r.idx
            self._sid_map[gsid] = lsid
            self._failed.discard(gsid)
            r.sessions += 1
            return gsid
        self.stats["serve_capacity_rejections"] += 1
        if self.metrics is not None:
            self.metrics.counter("serve_capacity_rejections")
        raise RuntimeError(
            f"serve fleet full ({self.n} replicas); close sessions "
            "first"
        )

    def close(self, gsid: int) -> None:
        if gsid in self._failed:
            # the owning replica is gone: closing a failed session is a
            # no-op reclaim, not an error
            self._failed.discard(gsid)
            return
        lsid = self._sid_map.pop(gsid, None)
        if lsid is None:
            raise SessionError(f"unknown session {gsid}")
        r = self._replicas[self.replica_of(gsid)]
        if r.dead:
            return
        self._call(r, ("close", lsid))
        r.sessions -= 1

    def set_params(self, model_params, version: int | None = None,
                   origin: str = "swap", reason: str | None = None,
                   mark_good: bool = True) -> int:
        """Fleet-wide swap: the state dict goes to every live replica as
        host numpy, and each applies it between calls
        (`SessionStore.set_params`). Returns the applied version
        (identical across the fleet: the explicit `version`, or each
        store's increment from a common history)."""
        host_params = _host_params(model_params)
        applied = None
        for r in self._alive():
            try:
                out = self._call(r, (
                    "set_params", host_params, version, origin,
                    reason, mark_good,
                ))
            except ReplicaDied:
                continue
            applied = out["version"]
        if applied is None:
            raise RuntimeError("set_params: no live replicas")
        prev_version = self.params_version
        self.params_version = applied
        self.stats["serve_param_swaps"] += 1
        self.stats["serve_param_version"] = applied
        if self.metrics is not None:
            self.metrics.counter("serve_param_swaps")
            self.metrics.gauge("serve_param_version", applied)
        if self.runlog is not None:
            self.runlog.params_swap(
                applied, prev_version=prev_version,
                action=origin, reason=reason,
            )
        return applied

    def rollback_params(self, reason: str | None = None) -> int:
        applied = None
        for r in self._alive():
            try:
                out = self._call(r, ("rollback", reason))
            except ReplicaDied:
                continue
            applied = out["version"]
        if applied is None:
            raise RuntimeError("rollback_params: no live replicas")
        self.params_version = applied
        self.stats["serve_param_rollbacks"] += 1
        self.stats["serve_param_version"] = applied
        return applied

    def poison(self, gsid: int) -> None:
        """Test hook: trip the health sentinel on one session (see
        `_poison_session`)."""
        lsid = self._sid_map[gsid]
        self._call(self._replicas[self.replica_of(gsid)],
                   ("poison", lsid))

    def registry(self):
        """The fleet's merged `MetricsRegistry`: every live replica's
        registry folded together, plus the router's own."""
        from ..obs.metrics import MetricsRegistry

        agg = MetricsRegistry()
        for r in self._alive():
            try:
                reg, _stats = self._call(r, ("metrics",))
            except (ReplicaDied, RuntimeError):
                continue
            agg.merge(reg)
        if self.metrics is not None:
            agg.merge(self.metrics)
        return agg

    def fleet_stats(self) -> dict[str, int]:
        """Store stats summed across live replicas, with the router's own
        counters riding along."""
        agg: dict[str, int] = dict(self.stats)
        for r in self._alive():
            try:
                _reg, stats = self._call(r, ("metrics",))
            except (ReplicaDied, RuntimeError):
                continue
            for k, v in stats.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
        return agg

    def replica_samples(self) -> list[dict[str, Any]]:
        """Per-replica scrape: ONE `metrics` round trip per live replica
        returning its own registry and store stats, unmerged (the fleet
        collector's and the labeled `/metrics`' input). Dead replicas
        are reported (alive False), not dropped."""
        out: list[dict[str, Any]] = []
        for r in self._replicas:
            sample: dict[str, Any] = {
                "replica": str(r.idx),
                "alive": not r.dead and r.proc.is_alive(),
                "sessions": r.sessions,
                "registry": None,
                "stats": None,
            }
            if sample["alive"]:
                try:
                    reg, stats = self._call(r, ("metrics",))
                    sample["registry"] = reg
                    sample["stats"] = stats
                except (ReplicaDied, RuntimeError):
                    sample["alive"] = False
            out.append(sample)
        return out

    def kernel_counts(self) -> list[dict[str, int] | None]:
        """Each replica's own kernel counts (launches and plain-version
        calls of every kernel wrapper, `kernels.kernel_counts`); None for
        a dead replica."""
        out: list[dict[str, int] | None] = []
        for r in self._replicas:
            counts = None
            if not r.dead:
                try:
                    counts = self._call(r, ("kernels",))
                except (ReplicaDied, RuntimeError):
                    counts = None
            out.append(counts)
        return out

    # -- the fleet trajectory feed -----------------------------------------

    def ring_pump(self, force: bool = False) -> int:
        """Fetch every live replica's parked ring chunks in ONE
        `ring_chunks` round trip each and feed the fleet-level
        `collector`, remapping each chunk's whole `sid` array (and every
        close event) from the replica's local ids to the global space
        (`gsid = lsid * n + idx`). `force` makes each replica drain its
        device rings first (teardown, end of a window). Returns the
        number of records ingested; a no-op without a collector."""
        if self.collector is None:
            return 0
        moved = 0
        for r in self._alive():
            try:
                ents = self._call(r, ("ring_chunks", bool(force)))
            except (ReplicaDied, RuntimeError):
                continue
            for ent in ents:
                if ent[0] == "chunk":
                    chunk = ent[1]
                    lsid = np.asarray(chunk.sid)
                    moved += int(lsid.shape[0])
                    self.collector.ingest_chunk(dataclasses.replace(
                        chunk,
                        sid=(lsid * self.n + r.idx).astype(lsid.dtype),
                    ))
                else:  # ("close", lsid, quarantined)
                    self.collector.on_close(
                        int(ent[1]) * self.n + r.idx,
                        quarantined=bool(ent[2]),
                    )
        return moved

    def _maybe_ring_pump(self) -> None:
        """The `poll()`-cadence half: one fleet sweep per
        `RING_PERIOD_S`, so the loop that already drives the pipes ships
        trajectories too."""
        if self.collector is None:
            return
        now = time.monotonic()
        if now >= self._ring_next:
            self._ring_next = now + RING_PERIOD_S
            self.ring_pump()

    # -- batching-front facade ---------------------------------------------

    def submit(self, gsid: int) -> RouterTicket:
        assert_owner(self, "serve-pump", "fleet-collector")
        tk = RouterTicket(gsid)
        if gsid in self._failed:
            tk.error = ReplicaDied(
                f"session {gsid}'s replica died; the session is "
                "failed, not rerouted"
            )
            return tk
        lsid = self._sid_map.get(gsid)
        if lsid is None:
            tk.error = SessionError(f"unknown session {gsid}")
            return tk
        r = self._replicas[self.replica_of(gsid)]
        if r.dead:
            tk.error = ReplicaDied(
                f"session {gsid}'s replica died; the session is "
                "failed, not rerouted"
            )
            return tk
        rid = self._next_rid()
        self._tickets[rid] = (r.idx, tk)
        try:
            self._send(r, ("submit", rid, lsid))
        except ReplicaDied:
            pass  # _mark_dead already errored the ticket
        return tk

    @property
    def pending(self) -> int:
        return len(self._tickets)

    def poll(self) -> bool:
        assert_owner(self, "serve-pump", "fleet-collector")
        moved = self._drain()
        self._maybe_ring_pump()
        return moved

    def flush(self, timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        while self._tickets:
            if not self._drain():
                time.sleep(2e-4)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"flush: {len(self._tickets)} request(s) still "
                    f"unresolved after {timeout_s:g}s"
                )

    # -- lifecycle ---------------------------------------------------------

    def stop(self, timeout_s: float = 30.0) -> None:
        """Drain and reap the fleet. Idempotent; stragglers are
        terminated."""
        if self._stopped:
            return
        self._stopped = True
        if self.collector is not None:
            try:  # a last full sweep: no trajectory stranded in a ring
                self.ring_pump(force=True)
            except RuntimeError:
                pass
        for r in self._replicas:
            if r.dead or not r.proc.is_alive():
                continue
            try:
                self._call(r, ("stop",), timeout_s=timeout_s)
            except (RuntimeError, ReplicaDied):
                pass
        for r in self._replicas:
            if r.proc.is_alive():
                r.proc.join(timeout=timeout_s)
            if r.proc.is_alive():
                r.proc.terminate()
                r.proc.join(timeout=5.0)
            if r.proc.is_alive():
                r.proc.kill()
                r.proc.join(timeout=5.0)
            try:
                r.conn.close()
            except OSError:
                pass

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
