"""Persistent decision-serving sessions and their batching fronts
(counterpart of `sparksched_tpu/serve/session.py`).

A `SessionStore` holds one live simulated cluster (`LoopState`) per
tenant and serves decisions through the two serve programs of
`serve/aot.py`: one session at a time, or up to `max_batch` in one
batched policy evaluation. The programs update the device store IN
PLACE, the counterpart of the JAX package's donated buffer.

Sessions are separate from slots:

- `capacity` is the number of live sessions the store admits;
  `hot_capacity` (default: `capacity`) the number of device slots.
  When `hot_capacity < capacity`, idle sessions are PAGED to host RAM
  and paged back in on their next request. Victims are taken
  quarantined first, then least recently served. The round trip is
  bit-exact on every leaf (`serve/aot.py:ColdSlot`). `hot_set_advice()`
  models bytes(H) = fixed + H x slot bytes against the card's memory.
- session ids are stable public handles; the sid -> slot mapping is
  internal, kept in maintained free lists (`create` is O(1)).
- the device store is split into `groups` equal slot groups with
  static membership (a slot's group is `slot // group_slots`). A batch
  is served by ONE call and lives in ONE group.

Every served decision carries the health sentinel mask; a non-zero
mask QUARANTINES the session: it is never served again (decide/step
raise `SessionQuarantined`) until `close` frees its id. Its slot may be
paged out to make room for hot sessions.

The in-flight window: `dispatch_batch` issues a call and returns an
`InFlightCall`; `harvest` (or `pop_ready` + `finalize_call`) turns the
outputs into `ServeResult`s later, in dispatch (FIFO) order. The
port's serve programs sync with the host inside the drain, so a
dispatch returns once its device work is issued; what is deferred is
the copy of the outputs to the host (pinned buffers and an event,
`serve/aot.py:HostCopy`) and the host work after it. One stream
orders everything: a weight swap (`set_params`, in place) lands after
every call already issued, and each call keeps the `params_version`
live at its dispatch. A session closed and re-created while its call
is in flight keeps its replacement clean: health is applied only when
the per-sid generation `_gen` still matches. The optional `harvester`
thread only waits on events and reads pinned host buffers; it never
touches the store.

Batching fronts, sharing one ticket/trace/metrics contract
(`Ticket`, `_finish_ticket`):

- `ContinuousBatcher` (the default front): no linger timer; the width-K
  slot re-fills from the queue the moment the previous call returns.
  Admission is per-tenant FIFO with round-robin rotation (a queue head
  is admitted within ceil(S/K) pumps of S backlogged tenants), with a
  hot-session preference on a paged store (`pager_aware`, bounded by
  `max_skips`) and eviction of a session that turns unservable. With
  `depth` > 1 it is the pipelined front: the pump dispatches without
  blocking, harvests what finished, and with `prefetch` pages
  predicted-next cold sessions into free slots ahead of their batch.
- `MicroBatcher` (`front: linger`): requests accumulate until
  `max_batch` are pending or the oldest has waited `linger_ms`.

Observability is host-side and off by default: `metrics` (a
`MetricsRegistry`) receives the admission and occupancy view, and
`trace=True` stamps a per-request span walk, emitted as run-log
`trace` records and fed to a `CritPathAnalyzer`.

Trajectory records (the online loop's actor path): a `record=True`
store hands each decision's `StoredObs` record to the host on its
`ServeResult.obs` and, with a `collector` (`online.TrajectoryBuffer`),
feeds every decision to it (`add`) and every close (`on_close`). With
`ring=R > 0` the programs instead append each decided record to a
per-group device `TrajRing`; every `ring_drain` potential appends (and
at a parameter swap, at a harvest with nothing in flight, and at a
close) the host snapshots the ring without a sync (`RingSnapshot`) and
later hands the span `[drained, cursor)` to the collector as one chunk
(`ingest_chunk`), a session's close always after its records. An
overrun is counted in `serve_ring_dropped`. `ServeResult.obs` never
crosses the wire.

`store_from_config` / `front_from_config` build the stack from the
top-level `serve:` YAML block (`config.SERVE_KEYS`). Not ported yet,
and refused loudly: `shard_dp` (a dp mesh) and `donate: false` (the
port always updates in place).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from .. import prng
from ..config import SERVE_KEYS, EnvParams, resolve_device
from ..env import core
from ..env.core import check_knobs
from ..env.flat_loop import (
    init_loop_state,
    leaves,
    rec_leaves,
    rec_map,
    take_slot,
    tree_map,
    write_slot,
)
from ..obs.tracing import RequestTrace, annotate
from ..ownership import assert_owner
from ..trainers.rollout import StoredObs
from ..workload.bank import WorkloadBank
from .aot import (
    SERVE_KNOBS,
    ColdSlot,
    HostCopy,
    RingSnapshot,
    init_ring,
    serve_decide_batch_fn,
    serve_decide_batch_ring_fn,
    serve_decide_fn,
    serve_decide_ring_fn,
)


class SessionError(KeyError):
    """Unknown / closed session id."""


class SessionQuarantined(RuntimeError):
    """The session's health sentinel tripped; it will not be served."""


def _not_ported(knob: str, what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"serve: {knob} ({what}) is not ported to sparksched_tpu_torch "
        f"yet (ROADMAP {item})"
    )


class ServeResult:
    """Host-side view of one served decision (plain Python scalars).
    `params_version` is the store's parameter version at dispatch (the
    staleness stamp the online learner filters on). `obs` (record-on
    stores without a ring, else None) is the decision's `StoredObs`
    record as numpy arrays; it never crosses the wire."""

    __slots__ = (
        "session_id", "stage_idx", "job_idx", "num_exec", "lgprob",
        "decided", "done", "reward", "dt", "wall_time", "health_mask",
        "batched", "params_version", "obs",
    )

    def __init__(self, session_id: int, out: dict[str, np.ndarray], i: int,
                 batched: bool, params_version: int = 0) -> None:
        self.session_id = session_id
        self.stage_idx = int(out["stage_idx"][i])
        self.job_idx = int(out["job_idx"][i])
        self.num_exec = int(out["num_exec"][i])
        self.lgprob = float(out["lgprob"][i])
        self.decided = bool(out["decided"][i])
        self.done = bool(out["done"][i])
        self.reward = float(out["reward"][i])
        self.dt = float(out["dt"][i])
        self.wall_time = float(out["wall_time"][i])
        self.health_mask = int(out["health_mask"][i])
        self.batched = batched
        self.params_version = int(params_version)
        self.obs = _result_obs(out, i)

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__ if k != "obs"}


def _result_obs(out: dict[str, np.ndarray], i: int) -> StoredObs | None:
    """Row i of a record-on call's `obs.<field>` outputs, or None."""
    if "obs.remaining" not in out:
        return None
    return StoredObs(**{f: out[f"obs.{f}"][i]
                        for f in StoredObs.__dataclass_fields__})


class RemoteResult:
    """`ServeResult`'s wire twin: a decision decoded from a
    `ServeResult.to_dict()` payload that crossed a socket, plus the
    wire-only `replica` (-1 in-process) and `spans_ms` (the server's
    span offsets riding the reply). `obs` is always None: records do
    not cross the wire."""

    __slots__ = (
        "session_id", "stage_idx", "job_idx", "num_exec", "lgprob",
        "decided", "done", "reward", "dt", "wall_time", "health_mask",
        "batched", "params_version", "obs", "replica", "spans_ms",
    )

    def __init__(self, d: dict[str, Any]) -> None:
        self.session_id = int(d["session_id"])
        self.stage_idx = int(d.get("stage_idx", -1))
        self.job_idx = int(d.get("job_idx", -1))
        self.num_exec = int(d.get("num_exec", 0))
        self.lgprob = float(d.get("lgprob", 0.0))
        self.decided = bool(d.get("decided", False))
        self.done = bool(d.get("done", False))
        self.reward = float(d.get("reward", 0.0))
        self.dt = float(d.get("dt", 0.0))
        self.wall_time = float(d.get("wall_time", 0.0))
        self.health_mask = int(d.get("health_mask", 0))
        self.batched = bool(d.get("batched", False))
        self.params_version = int(d.get("params_version", 0))
        self.obs = None
        self.replica = int(d.get("replica", -1))
        self.spans_ms = d.get("spans_ms")

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__
                if k not in ("obs", "spans_ms")}


class InFlightCall:
    """One dispatched-but-unharvested serve call. `copy` is its outputs'
    way to the host (`HostCopy`); `host_out` is filled by whoever
    materializes first, the harvester thread or `SessionStore.harvest`.
    `params_version` is the version live at DISPATCH, `gens` the
    sessions' generations then. `tickets` is the batching front's
    attachment point; `results` is set at harvest."""

    __slots__ = (
        "sids", "group", "batched", "copy", "host_out", "bg_failed",
        "bg_claimed", "params_version", "gens", "spans", "tickets",
        "results",
    )

    def __init__(self, sids, group, batched, copy: HostCopy,
                 params_version, gens, spans=None) -> None:
        self.sids = list(sids)
        self.group = int(group)
        self.batched = bool(batched)
        self.copy = copy
        self.host_out: dict[str, np.ndarray] | None = None
        # set by the harvester when ITS materialization raised: the
        # serving thread's harvest retries (and surfaces the error)
        self.bg_failed = False
        # set (under the store's condition) when the harvester starts
        # on this call, so the serving thread waits for that copy
        self.bg_claimed = False
        self.params_version = int(params_version)
        self.gens = list(gens)
        self.spans: dict[str, float] | None = spans
        self.tickets: list[Ticket] | None = None
        self.results: list[ServeResult] | None = None

    def outputs_ready(self) -> bool:
        """Whether the outputs reached the host (no host sync)."""
        return self.host_out is not None or self.copy.ready()


class SessionStore:
    """`capacity` sessions over `hot_capacity` device slots on `device`
    (the card unless the caller asks for the CPU), split into `groups`
    slot groups, served through two programs: one session at a time, or
    up to `max_batch` of one group in one batched policy evaluation.
    Greedy unless `deterministic=False`. Not thread-safe by design: one
    serving thread owns the store; the optional `harvester` thread only
    materializes outputs."""

    def __init__(
        self,
        params: EnvParams,
        bank: WorkloadBank,
        scheduler,
        capacity: int = 64,
        *,
        hot_capacity: int | None = None,
        groups: int = 1,
        harvester: bool = False,
        mesh=None,
        max_batch: int = 8,
        deterministic: bool = True,
        donate: bool = True,
        seed: int = 0,
        knobs: dict[str, Any] | None = None,
        runlog=None,
        tb_writer=None,
        metrics=None,
        trace: bool = False,
        record: bool = False,
        ring: int = 0,
        ring_drain: int | None = None,
        collector=None,
        device: str | torch.device = "cuda",
    ) -> None:
        for knob, on, what, item in (
            ("shard_dp", mesh is not None, "a dp-sharded store", "A12"),
            ("donate: false", not donate, "a copying store", "A10c"),
        ):
            if on:
                raise _not_ported(knob, what, item)
        dev = resolve_device(device)
        hot = int(capacity if hot_capacity is None else hot_capacity)
        if not 1 <= hot <= capacity:
            raise ValueError(
                f"hot_capacity={hot} must be in [1, capacity={capacity}]"
            )
        self.groups = int(groups)
        if self.groups < 1 or hot % self.groups != 0:
            raise ValueError(
                f"groups={groups} must be >= 1 and divide "
                f"hot_capacity={hot} (static group membership: each "
                "group is an equal slot stack)"
            )
        gs = hot // self.groups
        self.group_slots = gs
        if not 1 <= max_batch <= gs:
            raise ValueError(
                f"max_batch={max_batch} must be in [1, "
                f"hot_capacity/groups={gs}] (a batch is ONE call and "
                "lives in ONE slot group)"
            )
        # trajectory recording, its optional collector (`add(result)` /
        # `ingest_chunk(chunk)` / `on_close(sid, quarantined=)`) and the
        # device ring: ring=R > 0 appends records on the device and
        # drains them in batches; ring=0 hands each record to the host
        self.record = bool(record)
        self.collector = collector
        self.ring_size = int(ring)
        if self.ring_size < 0:
            raise ValueError(f"ring={ring} must be >= 0")
        if self.ring_size and not self.record:
            raise ValueError(
                "ring > 0 requires record=True (the ring IS the "
                "record path — a ring without recording would run "
                "dead append machinery)"
            )
        if self.ring_size and self.ring_size < max_batch:
            raise ValueError(
                f"ring={ring} must be >= max_batch={max_batch} (one "
                "call can append up to max_batch records; a smaller "
                "ring would drop records within a single call)"
            )
        self._ring_on = self.record and self.ring_size > 0
        if ring_drain is not None and not self._ring_on:
            raise ValueError(
                "ring_drain requires ring > 0 (there is no ring to "
                "set a drain cadence for)"
            )
        # default cadence: half the ring, clamped so a worst-case burst
        # between snapshots (ring_drain - 1 potential appends plus one
        # full batch) still fits; an explicit tighter cadence may
        # overrun, which is counted (serve_ring_dropped)
        self.ring_drain = (
            max(1, min(self.ring_size // 2,
                       self.ring_size - max_batch + 1))
            if ring_drain is None else int(ring_drain)
        )
        if self._ring_on and not 1 <= self.ring_drain <= self.ring_size:
            raise ValueError(
                f"ring_drain={ring_drain} must be in [1, ring="
                f"{self.ring_size}] (a cadence past the ring depth "
                "guarantees overwritten records)"
            )
        self.knobs = SERVE_KNOBS | (knobs or {})
        check_knobs(self.knobs)
        for name, d in (("bank", bank.device), ("scheduler", scheduler.device)):
            if torch.device(d).type != dev.type:
                raise ValueError(f"{name} lives on {d}, the store on {dev}")
        self.params = params
        self.bank = bank
        self.scheduler = scheduler
        self.device = dev
        self.capacity = int(capacity)
        self.hot_capacity = hot
        self.max_batch = int(max_batch)
        self.deterministic = bool(deterministic)
        self._runlog = runlog
        self._tb = tb_writer
        # public and reassignable: a caller may swap in a fresh registry
        # per measurement window. `trace` stamps each call's phase
        # boundaries into `last_spans`, at the cost of a device sync
        self.metrics = metrics
        self.trace = bool(trace)
        self.last_spans: dict[str, float] | None = None
        self._base_key = prng.PRNGKey(seed, dev)
        # calls served so far: call i runs on fold_in(base key, i). The
        # JAX store's two warm-up calls take keys 1 and 2.
        self._calls = 2
        self.params_version = 0
        self._last_good_params = self._params_copy()
        self._last_good_version = 0

        pol, bpol = scheduler.serve_param_policies(
            deterministic=self.deterministic
        )
        if self._ring_on:
            self._decide1 = serve_decide_ring_fn(params, bank, pol,
                                                 self.knobs)
            self._decidek = serve_decide_batch_ring_fn(
                params, bank, bpol, self.max_batch, self.knobs)
        else:
            self._decide1 = serve_decide_fn(params, bank, pol, self.knobs,
                                            record=self.record)
            self._decidek = serve_decide_batch_fn(
                params, bank, bpol, self.max_batch, self.knobs,
                record=self.record)
        # every slot starts as a copy of one dummy episode; create()
        # overwrites a slot with its own seeded reset
        ls0 = self._reset1(prng.fold_in(self._base_key, 2**19))
        self._stores = [
            tree_map(lambda a: a.expand((gs,) + a.shape[1:]).clone(), ls0)
            for _ in range(self.groups)
        ]
        # one device ring per slot group (ring mode only); per group the
        # potential undrained appends (counted at dispatch: an upper
        # bound, so the cadence can only over-drain) and the records
        # already ingested (the host cursor). Pending snapshots and
        # deferred close events wait in ONE queue in the order they were
        # made: a session's close must reach the collector before the
        # records of a later session reusing its id, whichever group
        # that one lives in (the JAX store keeps one queue per group)
        self._rings = (
            [init_ring(self.ring_size, params, ls0.env)
             for _ in range(self.groups)] if self._ring_on else [])
        self._ring_pot = [0] * self.groups
        self._ring_drained = [0] * self.groups
        self._ring_pending: deque = deque()

        # sids are public handles, slots device positions (GLOBAL ids:
        # group = slot // group_slots, local = slot % group_slots)
        self._live = np.zeros(self.capacity, bool)
        self._quarantined = np.zeros(self.capacity, bool)
        self._slot_of = np.full(self.capacity, -1, np.int32)
        self._sid_of = np.full(self.hot_capacity, -1, np.int32)
        # sid -> static group (kept across page-outs)
        self._group_of = np.full(self.capacity, -1, np.int32)
        # per-sid generation: results of a call dispatched before a
        # close/create pair are not applied to the replacement
        self._gen = np.zeros(self.capacity, np.int64)
        # [cap-1 .. 0] so pop() hands out 0, 1, 2, ... on a fresh store,
        # then LIFO reuse. Slot free lists exist only under paging or
        # grouping: the one-group unpaged store maps sid == slot
        self._free_sids = list(range(self.capacity - 1, -1, -1))
        self._dynamic_slots = (
            self.groups > 1 or self.hot_capacity < self.capacity
        )
        self._free_slots: list[list[int]] = [
            (list(range((g + 1) * gs - 1, g * gs - 1, -1))
             if self._dynamic_slots else [])
            for g in range(self.groups)
        ]
        self._cold: dict[int, ColdSlot] = {}
        # cold sids whose page-out still holds a device copy: drained at
        # harvest, or taken device-side by a page-in that comes first
        self._wb_pending: deque[int] = deque()
        self._last_use = np.zeros(self.hot_capacity, np.int64)
        self._tick = 0
        # the in-flight window (FIFO). `wall_split` accumulates the host
        # loop's time issuing calls vs blocked on their outputs
        self._inflight: deque[InFlightCall] = deque()
        self.wall_split = {"dispatch_s": 0.0, "blocked_host_s": 0.0}
        self.stats = {
            "serve_decisions": 0,
            "serve_batched_decisions": 0,
            "serve_batch_calls": 0,
            "serve_quarantines": 0,
            "serve_sessions_live": 0,
            "serve_sessions_hot": 0,
            "serve_capacity_rejections": 0,
            "serve_page_ins": 0,
            "serve_page_outs": 0,
            "serve_param_swaps": 0,
            "serve_param_rollbacks": 0,
            "serve_param_version": 0,
            "serve_inflight_peak": 0,
            "serve_prefetches": 0,
            # the ring: potential undrained appends, snapshots taken,
            # records ingested, and records lost to an overrun (exact,
            # from the snapshot's cursor)
            "serve_ring_occupancy": 0,
            "serve_ring_drains": 0,
            "serve_ring_records": 0,
            "serve_ring_dropped": 0,
        }

        self._harvest_cv = threading.Condition()
        self._harvester_stop = False
        self._harvester: threading.Thread | None = None
        if harvester:
            self._harvester = threading.Thread(
                target=self._harvester_loop, daemon=True,
                name="serve-harvester",
            )
            self._harvester.start()

    # -- plumbing ----------------------------------------------------------

    @property
    def store(self):
        """The one-group device store (tests and callers poke slot state
        through it). Grouped stores expose `_stores`."""
        if self.groups != 1:
            raise AttributeError("grouped store (groups > 1): use _stores[g]")
        return self._stores[0]

    def _next_call(self) -> int:
        """The next call's count: the call's key is `fold_in(base key,
        count)`, derived inside the program with the keys split from it."""
        self._calls += 1
        return self._calls

    def _reset1(self, key: torch.Tensor):
        return init_loop_state(core.reset(self.params, self.bank, key[None]))

    def _params_copy(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.scheduler.params.items()}

    def _call1(self, group: int, local: int, fstage: int, fnexec: int,
               use_force: bool, sid: int = -1):
        if self._ring_on:
            out = self._decide1(self._stores[group], self._rings[group],
                                local, sid, self.params_version,
                                self._base_key, self._next_call(), fstage,
                                fnexec, use_force)
            self._ring_dispatched(group, 1)
            return out
        return self._decide1(self._stores[group], local, self._base_key,
                             self._next_call(), fstage, fnexec, use_force)

    def _callk(self, group: int, locals_: list[int],
               sids: list[int] | None = None):
        K = self.max_batch
        slots = np.full(K, self.group_slots, np.int64)
        slots[: len(locals_)] = locals_
        if self._ring_on:
            sv = np.full(K, -1, np.int64)
            if sids is not None:
                sv[: len(sids)] = sids
            both = torch.from_numpy(np.concatenate([slots, sv])).to(
                self.device)
            out = self._decidek(self._stores[group], self._rings[group],
                                both[:K], both[K:], self.params_version,
                                self._base_key, self._next_call())
            self._ring_dispatched(group, K if sids is None else len(sids))
            return out
        return self._decidek(self._stores[group],
                             torch.from_numpy(slots).to(self.device),
                             self._base_key, self._next_call())

    # -- the trajectory ring's drain ---------------------------------------

    def _ring_dispatched(self, group: int, n: int) -> None:
        """Count a dispatched call's potential appends and snapshot the
        group's ring once the cadence is reached. An upper bound (lanes
        that do not decide append nothing): the trigger can only
        over-drain, and an overrun is still counted exactly from the
        snapshot's cursor."""
        self._ring_pot[group] += int(n)
        self.stats["serve_ring_occupancy"] = sum(self._ring_pot)
        if self._ring_pot[group] >= self.ring_drain:
            self._ring_snapshot(group)

    def _ring_snapshot(self, group: int) -> None:
        """Start a drain of one group's ring without a host sync
        (`RingSnapshot`); `_drain_ring_writebacks` ingests it once its
        copy has landed."""
        self._ring_pending.append(
            ("snap", group, RingSnapshot(self._rings[group])))
        self._ring_pot[group] = 0
        self.stats["serve_ring_occupancy"] = sum(self._ring_pot)
        self.stats["serve_ring_drains"] += 1
        if self.metrics is not None:
            self.metrics.counter("serve_ring_drains")

    def _ring_emit_close(self, sid: int, quarantined: bool) -> None:
        """One session's close, to the collector: always after every ring
        record of the session was ingested (the pending queue keeps
        chunks and closes in stream order)."""
        if self.collector is not None:
            self.collector.on_close(sid, quarantined=quarantined)

    def _ring_ingest(self, group: int, snap: RingSnapshot) -> None:
        """Consume one landed snapshot: the undrained span is `[drained,
        cursor)` with the cursor read from the SNAPSHOT, an overrun past
        the ring's depth is counted as dropped records (the oldest are
        gone), and the surviving records go to the collector as ONE
        chunk in append order (a `RingRec` of [n] numpy arrays)."""
        end, rec = snap.numpy()
        start = self._ring_drained[group]
        if end <= start:
            return
        dropped = (end - start) - self.ring_size
        if dropped > 0:
            self.stats["serve_ring_dropped"] += dropped
            if self.metrics is not None:
                self.metrics.counter("serve_ring_dropped", dropped)
            start += dropped
        idx = np.arange(start, end) % self.ring_size
        chunk = rec_map(lambda a: a[idx], rec)
        self._ring_drained[group] = end
        self.stats["serve_ring_records"] += end - start
        if self.collector is not None:
            self.collector.ingest_chunk(chunk)

    def _drain_ring_writebacks(self, wait: bool = False) -> None:
        """The pending queue in order: a snapshot whose copy landed (or
        any, with `wait`) is ingested, a deferred close fires once every
        snapshot queued before it was. Without `wait` nothing blocks; a
        snapshot not yet landed holds back what was queued after it
        (the copies run in order on one stream, so a later one is not
        ready before it anyway)."""
        pend = self._ring_pending
        while pend:
            kind, a, b = pend[0]
            if kind == "snap" and not (wait or b.ready()):
                break
            pend.popleft()
            if kind == "close":
                self._ring_emit_close(a, b)
            else:
                self._ring_ingest(a, b)

    def drain_ring(self, wait: bool = True) -> None:
        """Force a drain: snapshot every group with potential undrained
        records, then work the pending queues; with `wait` (teardown,
        end of a window, parity checks) until every record reached the
        collector, without (a parameter swap) only what has landed. A
        no-op on a store without a ring."""
        if not self._ring_on:
            return
        for g in range(self.groups):
            if self._ring_pot[g] > 0:
                self._ring_snapshot(g)
        self._drain_ring_writebacks(wait=wait)

    def _wait_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _served(self, call) -> dict[str, np.ndarray]:
        """Run one serve call SYNCHRONOUSLY and hand back host outputs.
        With `trace` on, also stamp its phase boundaries into
        `last_spans`: `dispatch` (issued), `harvest` (the host starts
        materializing: at once on this path), `device_compute` (the
        card is done), `scatter_back` (the host holds the values)."""
        if not self.trace:
            # stale spans of a traced window must never merge into a
            # later request's trace
            self.last_spans = None
            t0 = time.perf_counter()
            out = call()
            t1 = time.perf_counter()
            host = HostCopy(out).numpy()
            self.wall_split["dispatch_s"] += t1 - t0
            self.wall_split["blocked_host_s"] += time.perf_counter() - t1
            self._drain_writebacks()
            self._drain_ring_writebacks()
            return host
        t_dispatch = time.perf_counter()
        out = call()
        t_harvest = time.perf_counter()
        self._wait_device()
        t_compute = time.perf_counter()
        host = HostCopy(out).numpy()
        t_scatter = time.perf_counter()
        self.wall_split["dispatch_s"] += t_harvest - t_dispatch
        self.wall_split["blocked_host_s"] += t_scatter - t_harvest
        self._drain_writebacks()
        self._drain_ring_writebacks()
        self.last_spans = {
            "dispatch": t_dispatch,
            "harvest": t_harvest,
            "device_compute": t_compute,
            "scatter_back": t_scatter,
        }
        return host

    # -- the hot/cold pager ------------------------------------------------

    def session_group(self, sid: int) -> int:
        """The session's STATIC slot group (0 on a one-group store)."""
        if self.groups == 1:
            return 0
        slot = int(self._slot_of[sid])
        return (slot // self.group_slots if slot >= 0
                else int(self._group_of[sid]))

    def has_free_slot(self, group: int) -> bool:
        """Whether `group` has a slot free without eviction (the prefetch
        gate: a prediction never evicts a resident)."""
        return bool(self._free_slots[group])

    def _page_out(self, slot: int) -> None:
        """Move one resident session's slot toward host RAM without
        waiting for it (`ColdSlot`); the device copy is dropped by
        `_drain_writebacks` at harvest."""
        g, l = divmod(slot, self.group_slots)
        vsid = int(self._sid_of[slot])
        self._cold[vsid] = ColdSlot(self._stores[g], l)
        self._wb_pending.append(vsid)
        self._sid_of[slot] = -1
        self._slot_of[vsid] = -1
        self.stats["serve_page_outs"] += 1
        if self.metrics is not None:
            self.metrics.counter("serve_page_outs")

    def _drain_writebacks(self, wait: bool = False) -> None:
        """Drop the device copies of page-outs whose host copy landed;
        with `wait` every one (waiting for them)."""
        remaining: deque[int] = deque()
        while self._wb_pending:
            sid = self._wb_pending.popleft()
            entry = self._cold.get(sid)
            if entry is None or entry.dev is None:
                continue  # paged back in device-side, or closed
            if wait or entry.ready():
                entry.drain()
            else:
                remaining.append(sid)
        self._wb_pending = remaining

    def _alloc_slot(self, group: int, pinned: set[int]) -> int:
        """A free device slot in `group`, evicting within the group if
        needed: a quarantined resident first, then the least recently
        served; `pinned` sids (the current batch) are never evicted."""
        if not self._dynamic_slots:
            raise AssertionError("unpaged store never allocates slots")
        if self._free_slots[group]:
            return self._free_slots[group].pop()
        gs = self.group_slots
        cands = [
            s for s in range(group * gs, (group + 1) * gs)
            if self._sid_of[s] >= 0 and int(self._sid_of[s]) not in pinned
        ]
        assert cands, (
            "no evictable slot: max_batch <= group_slots makes this "
            "unreachable"
        )
        quar = [s for s in cands if self._quarantined[self._sid_of[s]]]
        victim = min(quar or cands, key=lambda s: int(self._last_use[s]))
        self._page_out(victim)
        return victim

    def _pick_group(self) -> int:
        """A fresh session's static group: the one with the most free
        slots; when every hot set is full, the one with the fewest live
        sessions. Ties go to the lower index."""
        best = max(
            range(self.groups),
            key=lambda g: (len(self._free_slots[g]), -g),
        )
        if self._free_slots[best]:
            return best
        counts = [0] * self.groups
        for sid in range(self.capacity):
            if self._live[sid] and self._group_of[sid] >= 0:
                counts[int(self._group_of[sid])] += 1
        return min(range(self.groups), key=lambda g: (counts[g], g))

    def _page_in(self, sid: int, slot: int) -> None:
        """Write the session's cold copy into `slot`."""
        g, l = divmod(slot, self.group_slots)
        src = self._cold.pop(sid).source(self.device)
        write_slot(self._stores[g], torch.tensor([l], device=self.device),
                   src)
        self._slot_of[sid] = slot
        self._sid_of[slot] = sid
        self.stats["serve_page_ins"] += 1
        if self.metrics is not None:
            self.metrics.counter("serve_page_ins")

    def _hot_count(self) -> None:
        self.stats["serve_sessions_hot"] = int((self._sid_of >= 0).sum())

    def _ensure_hot(self, sids: list[int]) -> list[int]:
        """Device slots (GLOBAL ids) for `sids`, which share one group,
        paging cold sessions in (and idle ones out) as needed; bumps the
        LRU clock of every touched slot."""
        pinned = set(sids)
        slots = []
        for sid in sids:
            slot = int(self._slot_of[sid])
            if slot < 0:
                slot = self._alloc_slot(self.session_group(sid), pinned)
                self._page_in(sid, slot)
            self._tick += 1
            self._last_use[slot] = self._tick
            slots.append(slot)
        self._hot_count()
        return slots

    def prefetch(self, sid: int) -> bool:
        """Page a predicted-next session into a FREE slot of its group
        ahead of its batch; never evicts for a prediction. True when a
        page-in was issued."""
        if not 0 <= sid < self.capacity or not self._live[sid]:
            return False
        if int(self._slot_of[sid]) >= 0:
            return False  # already hot
        group = self.session_group(sid)
        if not self._free_slots[group]:
            return False
        slot = self._free_slots[group].pop()
        self._page_in(sid, slot)
        self._tick += 1
        self._last_use[slot] = self._tick
        self.stats["serve_prefetches"] += 1
        if self.metrics is not None:
            self.metrics.counter("serve_prefetches")
        self._hot_count()
        return True

    def hot_set_advice(
        self,
        candidates: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048),
        budget_bytes: int | None = None,
    ) -> dict[str, Any]:
        """Hot-set capacity model (`obs.memory.hot_set_fit`): how many
        device slots fit the budget, the workload bank as the fixed cost.
        The budget defaults to the card's memory
        (`torch.cuda.mem_get_info`); on the CPU the caller gives it."""
        from ..obs.memory import hot_set_fit

        if budget_bytes is None:
            if self.device.type != "cuda":
                raise ValueError("hot_set_advice on the CPU needs "
                                 "budget_bytes")
            budget_bytes = torch.cuda.mem_get_info(self.device)[1]
        fixed = sum(
            t.numel() * t.element_size()
            for t in vars(self.bank).values() if isinstance(t, torch.Tensor)
        )
        # the per-group rings are device-resident fixed cost too
        fixed += sum(t.numel() * t.element_size() for rg in self._rings
                     for t in [rg.cursor] + rec_leaves(rg.rec))
        return hot_set_fit(
            [a[0] for _, a in leaves(self._stores[0])],
            candidates, budget_bytes=int(budget_bytes), fixed_bytes=fixed,
        )

    @property
    def model_params(self) -> dict[str, torch.Tensor]:
        """The live serving weights (the scheduler's state dict)."""
        return self.scheduler.params

    def is_hot(self, sid: int) -> bool:
        """Whether the session holds a device slot (False = paged out)."""
        return 0 <= sid < self.capacity and int(self._slot_of[sid]) >= 0

    # -- parameters --------------------------------------------------------

    def set_params(self, model_params: dict[str, Any],
                   version: int | None = None, origin: str = "swap",
                   reason: str | None = None, mark_good: bool = True) -> int:
        """Swap the serving weights (a state dict of the scheduler's net)
        in place, between calls. Names, shapes and dtypes must match the
        live ones. A call already dispatched keeps the version live at
        its dispatch; every later decision carries the new one. With
        `mark_good` the outgoing weights become the rollback target."""
        assert_owner(self, "serve-pump")
        cur = self.scheduler.params
        mismatch = None
        if set(model_params) != set(cur):
            mismatch = "parameter names"
        else:
            for k, v in model_params.items():
                v = torch.as_tensor(v)
                if (tuple(v.shape) != tuple(cur[k].shape)
                        or v.dtype != cur[k].dtype):
                    mismatch = (f"{k}: {tuple(v.shape)}/{v.dtype} vs "
                                f"{tuple(cur[k].shape)}/{cur[k].dtype}")
                    break
        if mismatch is not None:
            raise ValueError(
                f"set_params: new parameters do not match the live ones "
                f"({mismatch}); a swap may change values, never shapes"
            )
        prev_version = self.params_version
        if mark_good:
            self._last_good_params = self._params_copy()
            self._last_good_version = prev_version
        self.scheduler.load_params(model_params)
        self.params_version = (
            prev_version + 1 if version is None else int(version)
        )
        self.stats["serve_param_swaps"] += 1
        self._version_changed("serve_param_swaps", prev_version, origin,
                              reason)
        # a swap is a ring-drain boundary: records of the outgoing
        # version reach the learner promptly, without blocking dispatch
        self.drain_ring(wait=False)
        return self.params_version

    def rollback_params(self, reason: str | None = None) -> int:
        """Restore the last-good weights (those live before the latest
        `set_params` with `mark_good`) bit for bit, and their version."""
        assert_owner(self, "serve-pump")
        prev_version = self.params_version
        self.scheduler.load_params(self._last_good_params)
        self.params_version = self._last_good_version
        self.stats["serve_param_rollbacks"] += 1
        self._version_changed("serve_param_rollbacks", prev_version,
                              "rollback", reason)
        self.drain_ring(wait=False)  # a swap boundary (see set_params)
        return self.params_version

    def _version_changed(self, counter: str, prev_version: int,
                         action: str, reason: str | None) -> None:
        self.stats["serve_param_version"] = self.params_version
        if self.metrics is not None:
            self.metrics.counter(counter)
            self.metrics.gauge("serve_param_version", self.params_version)
        if self._runlog is not None:
            self._runlog.params_swap(self.params_version,
                                     prev_version=prev_version,
                                     action=action, reason=reason)

    # -- session lifecycle -------------------------------------------------

    def create(self, seed: int | None = None) -> int:
        """Reset a fresh episode into a free session; returns its id.
        Raises `RuntimeError` when the store is full."""
        assert_owner(self, "serve-pump")
        if not self._free_sids:
            self.stats["serve_capacity_rejections"] += 1
            if self.metrics is not None:
                self.metrics.counter("serve_capacity_rejections")
            raise RuntimeError(
                f"session store full ({self.capacity} sessions live "
                "or quarantined); close sessions first"
            )
        sid = self._free_sids.pop()
        k = (
            prng.fold_in(self._base_key, 2**20 + sid)
            if seed is None else prng.PRNGKey(seed, self.device)
        )
        if not self._dynamic_slots:
            slot = sid
        else:
            group = self._pick_group()
            self._group_of[sid] = group
            slot = self._alloc_slot(group, set())
        g, l = divmod(slot, self.group_slots)
        write_slot(self._stores[g], torch.tensor([l], device=self.device),
                   self._reset1(k))
        self._slot_of[sid] = slot
        self._sid_of[slot] = sid
        self._tick += 1
        self._last_use[slot] = self._tick
        self._live[sid] = True
        self._gen[sid] += 1
        self.stats["serve_sessions_live"] = int(self._live.sum())
        self._hot_count()
        return sid

    def close(self, sid: int) -> None:
        assert_owner(self, "serve-pump")
        self._check_sid(sid, allow_quarantined=True)
        if self.collector is not None:
            # finalize (or drop, when quarantined) the session's open
            # trajectory before the sid is reused
            quar = bool(self._quarantined[sid])
            if self._ring_on:
                # every ring record of the session must reach the
                # collector before its close: snapshot its group now
                # (no sync) and queue the close behind the snapshot
                g = self.session_group(sid)
                if self._ring_pot[g] > 0:
                    self._ring_snapshot(g)
                if self._ring_pending:
                    self._ring_pending.append(("close", sid, quar))
                    self._drain_ring_writebacks()
                else:
                    self._ring_emit_close(sid, quar)
            else:
                self.collector.on_close(sid, quarantined=quar)
        slot = int(self._slot_of[sid])
        if slot >= 0:
            self._sid_of[slot] = -1
            if self._dynamic_slots:
                self._free_slots[slot // self.group_slots].append(slot)
        self._slot_of[sid] = -1
        self._group_of[sid] = -1
        self._cold.pop(sid, None)
        self._live[sid] = False
        self._quarantined[sid] = False
        self._free_sids.append(sid)
        self.stats["serve_sessions_live"] = int(self._live.sum())
        self._hot_count()

    def _check_sid(self, sid: int, allow_quarantined: bool = False) -> None:
        if not 0 <= sid < self.capacity or not self._live[sid]:
            raise SessionError(f"unknown session id {sid}")
        if self._quarantined[sid] and not allow_quarantined:
            raise SessionQuarantined(
                f"session {sid} is quarantined (health sentinel "
                "tripped); close it and create a fresh one"
            )

    def _apply_health(self, sid: int, mask: int) -> None:
        if mask == 0:
            return
        self._quarantined[sid] = True
        self.stats["serve_quarantines"] += 1
        if self.metrics is not None:
            self.metrics.counter("serve_quarantines")
        if self._runlog is not None:
            self._runlog.health(mask, session_id=sid, action="quarantine",
                                origin="serve")

    # -- serving -----------------------------------------------------------

    def _record_result(self, res: ServeResult) -> None:
        """Feed one served decision to the collector (the per-decision
        record path). A quarantining decision reaches it too: the
        collector drops the poisoned episode itself. Ring mode skips
        this: the record reaches the collector through the drain."""
        if self.collector is not None and not self._ring_on:
            self.collector.add(res)

    def _batch_group(self, sids: list[int]) -> int:
        """The ONE slot group a batch lives in; cross-group sid sets
        fail loudly (the group-aware front never forms them)."""
        gset = {self.session_group(s) for s in sids}
        if len(gset) > 1:
            raise ValueError(
                f"batch spans slot groups {sorted(gset)}: a batch is ONE "
                "call and must live in ONE group (the ContinuousBatcher "
                "forms per-group batches)"
            )
        return gset.pop()

    def _one(self, sid: int, stage_idx: int, num_exec: int,
             use_force: bool) -> ServeResult:
        self._check_sid(sid)
        [slot] = self._ensure_hot([sid])
        g, l = divmod(slot, self.group_slots)
        ver = self.params_version  # live at dispatch
        out = self._served(
            lambda: self._call1(g, l, stage_idx, num_exec, use_force, sid))
        res = ServeResult(sid, out, 0, batched=False, params_version=ver)
        self._apply_health(sid, res.health_mask)
        self._record_result(res)
        self.stats["serve_decisions"] += 1
        return res

    def decide(self, sid: int) -> ServeResult:
        """One policy decision on the single-session path."""
        assert_owner(self, "serve-pump")
        return self._one(sid, -1, 0, False)

    def step(self, sid: int, stage_idx: int, num_exec: int) -> ServeResult:
        """Apply a CALLER-chosen action through the same program."""
        assert_owner(self, "serve-pump")
        return self._one(sid, stage_idx, num_exec, True)

    def _batch_results(self, sids, out, ver, gens=None
                       ) -> list[ServeResult]:
        """Host results of one width-K call, health applied per decision
        when the session's generation still matches `gens`."""
        results = []
        for i, sid in enumerate(sids):
            res = ServeResult(sid, out, i, batched=True, params_version=ver)
            if gens is None or (self._live[sid]
                                and self._gen[sid] == gens[i]):
                self._apply_health(sid, res.health_mask)
                self._record_result(res)
            results.append(res)
        self.stats["serve_decisions"] += len(sids)
        self.stats["serve_batched_decisions"] += len(sids)
        self.stats["serve_batch_calls"] += 1
        return results

    def _validate_batch(self, sids: list[int]) -> None:
        if len(sids) > self.max_batch:
            raise ValueError(f"{len(sids)} sessions > max_batch="
                             f"{self.max_batch}")
        for sid in sids:
            self._check_sid(sid)
        if len(set(sids)) != len(sids):
            raise ValueError("duplicate session ids in one batch")

    def decide_batch(self, sids: list[int]) -> list[ServeResult]:
        """Up to `max_batch` sessions of one group in ONE batched policy
        evaluation; a single session takes the single-session path. All
        results of one call share one `params_version`."""
        assert_owner(self, "serve-pump")
        if not sids:
            return []
        self._validate_batch(sids)
        if len(sids) == 1:
            return [self.decide(sids[0])]
        group = self._batch_group(sids)
        locals_ = [s % self.group_slots for s in self._ensure_hot(sids)]
        ver = self.params_version
        out = self._served(lambda: self._callk(group, locals_, sids))
        return self._batch_results(sids, out, ver)

    # -- the pipelined window ----------------------------------------------

    @property
    def inflight(self) -> int:
        """Dispatched-but-unharvested calls."""
        with self._harvest_cv:
            return len(self._inflight)

    def dispatch_batch(self, sids: list[int]) -> InFlightCall:
        """The deferred half of `decide_batch`: validate, page the batch
        hot, issue the call and start its outputs' copy to the host,
        returning an `InFlightCall`. Results are built at `harvest`, in
        dispatch order. The same sequence of dispatch_batch calls gives
        bit-identical decisions to the same sequence of decide_batch
        calls (same keys, same programs); only WHEN the host observes
        them moves."""
        assert_owner(self, "serve-pump")
        if not sids:
            raise ValueError("empty batch")
        self._validate_batch(sids)
        group = self._batch_group(sids)
        batch_slots = self._ensure_hot(sids)
        ver = self.params_version
        t0 = time.perf_counter()
        if len(sids) == 1:
            # decide_batch's lone-request fallback: the same program and
            # key consumption, so sync and pipelined fronts stay equal
            out = self._call1(group, batch_slots[0] % self.group_slots,
                              -1, 0, False, sids[0])
            batched = False
        else:
            out = self._callk(group,
                              [s % self.group_slots for s in batch_slots],
                              sids)
            batched = True
        copy = HostCopy(out)
        t1 = time.perf_counter()
        self.wall_split["dispatch_s"] += t1 - t0
        spans = {"dispatch": t0} if self.trace else None
        call = InFlightCall(sids, group, batched, copy, ver,
                            [int(self._gen[s]) for s in sids], spans=spans)
        with self._harvest_cv:
            self._inflight.append(call)
            depth = len(self._inflight)
            self._harvest_cv.notify()
        self.stats["serve_inflight_peak"] = max(
            self.stats["serve_inflight_peak"], depth)
        if self.metrics is not None:
            self.metrics.gauge("serve_inflight_depth", depth)
        return call

    def _materialize(self, call: InFlightCall) -> dict[str, np.ndarray]:
        """The call's host outputs: the harvester's copy when it got there
        first (waiting for a claimed one), else converted here."""
        if (call.host_out is None and call.bg_claimed
                and not call.bg_failed):
            with self._harvest_cv:
                while call.host_out is None and not call.bg_failed:
                    self._harvest_cv.wait(timeout=0.05)
        if call.host_out is None:
            call.host_out = call.copy.numpy()
        return call.host_out

    def pop_ready(self, wait: bool = True, limit: int | None = None
                  ) -> list[InFlightCall]:
        """The device half of the harvest: pop in-flight calls in FIFO
        order and materialize their outputs (the only blocking step).
        With `wait=False` only calls whose outputs already reached the
        host pop."""
        done: list[InFlightCall] = []
        while limit is None or len(done) < limit:
            with self._harvest_cv:
                if not self._inflight:
                    break
                call = self._inflight[0]
                if not wait and not call.outputs_ready():
                    break
                self._inflight.popleft()
            t0 = time.perf_counter()
            if call.spans is not None:
                call.spans["harvest"] = t0
                self._wait_device()
                call.spans["device_compute"] = time.perf_counter()
            self._materialize(call)
            self.wall_split["blocked_host_s"] += time.perf_counter() - t0
            if call.spans is not None:
                call.spans["scatter_back"] = time.perf_counter()
            if self.metrics is not None:
                with self._harvest_cv:
                    depth = len(self._inflight)
                self.metrics.gauge("serve_inflight_depth", depth)
            done.append(call)
        return done

    def finalize_call(self, call: InFlightCall) -> list[ServeResult]:
        """The host half of the harvest: build the `ServeResult`s and
        apply health, gated on each session's generation. Idempotent."""
        if call.results is not None:
            return call.results
        out = call.host_out
        if call.batched:
            call.results = self._batch_results(
                call.sids, out, call.params_version, gens=call.gens)
        else:
            [sid] = call.sids
            res = ServeResult(sid, out, 0, batched=False,
                              params_version=call.params_version)
            if self._live[sid] and self._gen[sid] == call.gens[0]:
                self._apply_health(sid, res.health_mask)
                self._record_result(res)
            self.stats["serve_decisions"] += 1
            call.results = [res]
        self._drain_writebacks()
        self._drain_ring_writebacks()
        return call.results

    def harvest(self, wait: bool = True, limit: int | None = None
                ) -> list[InFlightCall]:
        """Drain the in-flight window in FIFO order: `pop_ready` then
        `finalize_call` for each (results on `call.results`)."""
        done = self.pop_ready(wait=wait, limit=limit)
        for call in done:
            self.finalize_call(call)
        with self._harvest_cv:
            empty = not self._inflight
        idle = wait and empty
        self._drain_writebacks(wait=idle)
        # a harvest with nothing in flight is a ring-drain boundary: no
        # dispatch to protect, so leftover records go to the collector
        if idle:
            self.drain_ring(wait=True)
        else:
            self._drain_ring_writebacks()
        return done

    def _harvester_loop(self) -> None:
        """Background harvester: materialize the OLDEST unclaimed call's
        outputs so `harvest` finds them host-ready. It waits on events
        and reads pinned host buffers; the deque and the store stay the
        serving thread's."""
        while True:
            with self._harvest_cv:
                while not self._harvester_stop and not any(
                    c.host_out is None and not c.bg_failed
                    for c in self._inflight
                ):
                    self._harvest_cv.wait(timeout=0.05)
                if self._harvester_stop:
                    return
                call = next(
                    (c for c in self._inflight
                     if c.host_out is None and not c.bg_failed), None)
                if call is not None:
                    call.bg_claimed = True
            if call is not None:
                try:
                    call.host_out = call.copy.numpy()
                except Exception:
                    # never kill serving, never busy-spin: the serving
                    # thread's harvest retries and surfaces the error
                    call.bg_failed = True
                with self._harvest_cv:
                    self._harvest_cv.notify_all()

    def stop_harvester(self) -> None:
        """Stop the background harvester thread (idempotent)."""
        if self._harvester is None:
            return
        with self._harvest_cv:
            self._harvester_stop = True
            self._harvest_cv.notify_all()
        self._harvester.join(timeout=2.0)
        self._harvester = None

    # -- observability -----------------------------------------------------

    def log_stats(self, iteration: int,
                  extra: dict[str, Any] | None = None) -> None:
        """The `serve_*` stats as a run-log `scalars` record and, when a
        writer was given, TensorBoard scalars (same keys)."""
        stats = dict(self.stats) | (extra or {})
        if self._runlog is not None:
            self._runlog.scalars(iteration, stats)
        if self._tb is not None:
            for k, v in stats.items():
                self._tb.add_scalar(k, v, iteration)


class Ticket:
    """One pending request. Once resolved either `result` is set, or
    `error` holds the request's own failure (a quarantined or closed
    session fails ITS ticket only). Under an instrumented front `trace`
    carries the request's `RequestTrace`, minted here."""

    __slots__ = ("session_id", "submitted_at", "result", "error", "trace")

    def __init__(self, session_id: int, traced: bool = False) -> None:
        self.session_id = session_id
        self.submitted_at = time.perf_counter()
        self.result: ServeResult | None = None
        self.error: Exception | None = None
        self.trace: RequestTrace | None = None
        if traced:
            self.trace = RequestTrace()
            self.trace.stamp("submit", self.submitted_at)

    @property
    def ready(self) -> bool:
        return self.result is not None or self.error is not None


def _span(traced: bool, name: str):
    """An NVTX range around a front's serve call on traced fronts only
    (untraced fronts stay bare)."""
    return annotate(name) if traced else contextlib.nullcontext()


def _finish_ticket(t: Ticket, store: SessionStore, metrics, runlog,
                   critpath=None) -> None:
    """Resolve one ticket's instrumentation: merge the store's spans,
    stamp `reply`, feed the critical-path analyzer and the per-span
    histograms, emit the run-log `trace` record. Shared by both fronts,
    so their A/B rows count tickets alike."""
    m = metrics
    if m is not None:
        m.counter("serve_requests_total")
        if t.error is not None:
            m.counter("serve_request_errors")
    if t.trace is None:
        return
    spans = store.last_spans
    if t.error is None and spans is not None:
        t.trace.spans.update(spans)
    t.trace.stamp("reply")
    if critpath is not None:
        critpath.add(
            t.trace, tenant=t.session_id,
            error=None if t.error is None else type(t.error).__name__,
        )
    if m is not None:
        s = t.trace.spans
        segs = (
            ("serve_span_queue_ms", "submit", "batch_admit"),
            ("serve_span_device_ms", "dispatch", "device_compute"),
            ("serve_span_inflight_ms", "dispatch", "harvest"),
            ("serve_span_harvest_ms", "harvest", "scatter_back"),
            ("serve_span_scatter_ms", "device_compute", "scatter_back"),
            ("serve_span_total_ms", "submit", "reply"),
        )
        for name, a, b in segs:
            if a in s and b in s:
                m.observe(name, (s[b] - s[a]) * 1e3)
    if runlog is not None:
        runlog.trace(
            t.trace.trace_id, t.trace.offsets_ms(),
            session_id=t.session_id,
            params_version=(None if t.result is None
                            else t.result.params_version),
            error=None if t.error is None else type(t.error).__name__,
        )


class MicroBatcher:
    """Bounded-linger front (`front: linger`). `submit(sid)` enqueues and
    flushes once `max_batch` requests are pending; `poll()` flushes when
    the OLDEST pending request has waited `linger_ms`; `flush()` forces.
    A lone pending request takes the single-session path. `metrics`
    receives queue depth, batch occupancy, linger waits, flush-reason
    counters (`serve_flush_size|linger|forced`) and per-span histograms;
    `trace=True` mints a `RequestTrace` per ticket."""

    front_name = "linger"

    def __init__(self, store: SessionStore, linger_ms: float = 1.0,
                 *, metrics=None, runlog=None, trace: bool = False,
                 critpath=None) -> None:
        self.store = store
        self.linger_s = float(linger_ms) / 1e3
        self.metrics = metrics
        self.runlog = runlog
        self.trace = bool(trace)
        self.critpath = critpath
        self._pending: list[Ticket] = []

    def submit(self, sid: int) -> Ticket:
        assert_owner(self, "serve-pump")
        t = Ticket(sid, traced=self.trace)
        self._pending.append(t)
        if len(self._pending) >= self.store.max_batch:
            self.flush(reason="size")
        return t

    @property
    def pending(self) -> int:
        """Requests queued but not yet flushed."""
        return len(self._pending)

    def poll(self) -> bool:
        """Flush if the linger window expired; True when a flush ran."""
        if not self._pending:
            return False
        waited = time.perf_counter() - self._pending[0].submitted_at
        if waited >= self.linger_s:
            self.flush(reason="linger")
            return True
        return False

    def _finish(self, t: Ticket) -> None:
        _finish_ticket(t, self.store, self.metrics, self.runlog,
                       self.critpath)

    def flush(self, reason: str = "forced") -> None:
        """Serve every pending ticket. Duplicate session ids ride
        SUCCESSIVE batch calls; a request that cannot be served fails
        its OWN ticket and the rest are still served."""
        assert_owner(self, "serve-pump")
        m = self.metrics
        first = True
        while self._pending:
            if m is not None:
                # the reason counts once per flush event; the admission
                # views count per batch call
                if first:
                    m.counter(f"serve_flush_{reason}")
                m.observe("serve_queue_depth", len(self._pending))
            first = False
            batch: list[Ticket] = []
            seen: set[int] = set()
            rest: list[Ticket] = []
            for t in self._pending:
                if (len(batch) < self.store.max_batch
                        and t.session_id not in seen):
                    batch.append(t)
                    seen.add(t.session_id)
                else:
                    rest.append(t)
            self._pending = rest  # each pass consumes >= 1 ticket
            now = time.perf_counter()
            for t in batch:
                if m is not None:
                    m.observe("serve_linger_wait_ms",
                              (now - t.submitted_at) * 1e3)
                if t.trace is not None:
                    t.trace.stamp("batch_admit", now)
            if m is not None:
                m.observe("serve_batch_occupancy", len(batch))
            try:
                with _span(self.trace, "serve/flush"):
                    results = self.store.decide_batch(
                        [t.session_id for t in batch])
            except Exception:
                # a bad session id poisons the whole batch call;
                # re-serve one by one so only the offender fails
                for t in batch:
                    try:
                        t.result = self.store.decide(t.session_id)
                    except Exception as e:
                        t.error = e
                    self._finish(t)
                continue
            for t, r in zip(batch, results):
                t.result = r
                self._finish(t)


class ContinuousBatcher:
    """Iteration-level (continuous) batching front.

    No linger timer: `submit` enqueues (dispatching at once when K
    distinct sessions of one group are ready), and each `poll()` /
    `pump()` serves ONE batch of whatever is queued; partial fills cost
    only their occupants.

    Fairness: one FIFO queue per session with round-robin rotation
    across sessions; with S backlogged sessions and batch width K every
    queue head is admitted within ceil(S/K) pumps. A session that turns
    unservable mid-stream (quarantined by a decision, or closed /
    quarantined at dispatch) has its queued requests EVICTED, each
    failing its own ticket; co-queued sessions are unaffected.

    `pager_aware` (default True) on a paged store: within a 2K
    look-ahead window of the rotation, hot sessions are admitted before
    paged-out ones; a session skipped `max_skips` times is admitted
    unconditionally, so the bound stretches only to ceil(S/K) +
    max_skips. Cold admissions count in `serve_page_churn`.

    Pipelined (`depth` > 1): the pump DISPATCHES the admitted batch
    (`SessionStore.dispatch_batch`), keeps up to `depth - 1` calls on
    the device and resolves tickets at harvest; it never blocks, a full
    window skips the dispatch (the backpressure), and with no full next
    batch queued it harvests the call at once. Admission order, hence
    every call and its key, is the `depth=1` front's, so decisions are
    bit-equal. On a grouped store a batch targets the fullest eligible
    group, the `max_skips` valve retargeting it to a passed-over head's
    group. With `prefetch` on a paged store, predicted-next cold
    sessions are paged into free slots of their group while the batch
    computes.

    Flush reasons: `size` (a full slot dispatched at submit),
    `occupancy` (a pump) and `forced` (drain); waits land in
    `serve_queue_wait_ms`."""

    def __init__(self, store: SessionStore, *, metrics=None,
                 runlog=None, trace: bool = False, critpath=None,
                 pager_aware: bool = True, max_skips: int = 2,
                 depth: int = 1, prefetch: bool = True) -> None:
        self.store = store
        self.metrics = metrics
        self.runlog = runlog
        self.trace = bool(trace)
        self.critpath = critpath
        self.pager_aware = bool(pager_aware)
        self.max_skips = int(max_skips)
        if depth < 1:
            raise ValueError(f"depth={depth} must be >= 1")
        self.depth = int(depth)
        self.prefetch = bool(prefetch)
        self.front_name = "pipelined" if self.depth > 1 else "continuous"
        self._queues: dict[int, deque[Ticket]] = {}
        self._rotation: deque[int] = deque()
        self._skips: dict[int, int] = {}

    def submit(self, sid: int) -> Ticket:
        assert_owner(self, "serve-pump")
        t = Ticket(sid, traced=self.trace)
        q = self._queues.get(sid)
        if q is None:
            q = self._queues[sid] = deque()
        if not q:
            self._rotation.append(sid)
        q.append(t)
        # a full width-K slot never waits; on a grouped store "full" is
        # per group (a batch lives in one group)
        st = self.store
        if st.groups == 1:
            if len(self._rotation) >= st.max_batch:
                self.pump(reason="size")
        elif len(self._rotation) >= st.max_batch and sum(
            1 for s in self._rotation
            if st.session_group(s) == st.session_group(sid)
        ) >= st.max_batch:
            self.pump(reason="size")
        return t

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def poll(self) -> bool:
        """Serve one batch if anything is queued (and, pipelined, harvest
        every finished call); True when one ran."""
        return self.pump(reason="occupancy")

    def flush(self) -> None:
        """Drain the whole queue and the in-flight window: no ticket left
        unresolved. With the window full it waits out the oldest call."""
        while self._rotation:
            if not self.pump(reason="forced") and self.store.inflight:
                self._harvest(wait=True, limit=1)
        self._harvest(wait=True)

    def _finish(self, t: Ticket) -> None:
        _finish_ticket(t, self.store, self.metrics, self.runlog,
                       self.critpath)

    def _resolve(self, calls: list) -> int:
        """Finalize popped calls (dispatch order) and resolve their
        tickets, each call's spans staged into `store.last_spans`."""
        for call in calls:
            results = self.store.finalize_call(call)
            self.store.last_spans = (call.spans if self.store.trace
                                     else None)
            tickets = call.tickets or []
            for t, r in zip(tickets, results):
                t.result = r
                self._finish(t)
            self._evict_unservable(tickets)
        return len(calls)

    def _harvest(self, wait: bool, limit: int | None = None) -> int:
        if self.depth <= 1:
            return 0
        return self._resolve(self.store.pop_ready(wait=wait, limit=limit))

    def _evict_unservable(self, batch: list[Ticket]) -> None:
        """Any batch member whose decision tripped the sentinel, or whose
        dispatch failed with a quarantined or closed session, drags its
        queued followers out: each fails its own ticket now."""
        for t in batch:
            if isinstance(t.error, (SessionQuarantined, SessionError)):
                fail: type[Exception] = type(t.error)
            elif t.result is not None and t.result.health_mask != 0:
                fail = SessionQuarantined
            else:
                continue
            sid = t.session_id
            q = self._queues.pop(sid, None)
            self._skips.pop(sid, None)
            if sid in self._rotation:
                self._rotation.remove(sid)
            while q:
                tk = q.popleft()
                tk.error = fail(
                    f"session {sid} unservable mid-stream "
                    f"({fail.__name__}); queued request evicted"
                )
                self._finish(tk)

    def _admit_sids(self) -> list[int]:
        """Up to `max_batch` sessions off the rotation: plain round-robin,
        except on a paged store with `pager_aware` (starved sessions
        first, then hot, then cold, within a 2K window) and on a grouped
        store (one group per batch: the starved head's, else the fullest
        group, tie to the head's). Passed-over sessions are charged a
        skip and keep their rotation position."""
        K = min(self.store.max_batch, len(self._rotation))
        st = self.store
        grouped = st.groups > 1
        paged = st.hot_capacity < st.capacity
        if not grouped and (
            not self.pager_aware or not paged or len(self._rotation) <= K
        ):
            out = [self._rotation.popleft() for _ in range(K)]
            for s in out:
                # any admission resets the starvation valve
                self._skips.pop(s, None)
            return out
        window = list(self._rotation)[: 2 * st.max_batch]
        forced = [s for s in window
                  if self._skips.get(s, 0) >= self.max_skips]
        if grouped:
            if forced:
                tg = st.session_group(forced[0])
            else:
                counts: dict[int, int] = {}
                for s in window:
                    g = st.session_group(s)
                    counts[g] = counts.get(g, 0) + 1
                head_g = st.session_group(window[0])
                tg = max(counts,
                         key=lambda g: (counts[g], g == head_g, -g))
            eligible = [s for s in window if st.session_group(s) == tg]
            forced = [s for s in forced if s in set(eligible)]
        else:
            eligible = window
        taken = set(forced[:K])
        picked = forced[:K]
        prefer = (True, False) if self.pager_aware and paged else (None,)
        for prefer_hot in prefer:
            for s in eligible:
                if len(picked) >= K:
                    break
                if s in taken or (prefer_hot is not None
                                  and st.is_hot(s) is not prefer_hot):
                    continue
                picked.append(s)
                taken.add(s)
        if self.metrics is not None and paged:
            n_cold = sum(1 for s in picked if not st.is_hot(s))
            if n_cold:
                self.metrics.counter("serve_page_churn", n_cold)
        for s in window:
            if s not in taken:
                self._skips[s] = self._skips.get(s, 0) + 1
        for s in picked:
            self._skips.pop(s, None)
        self._rotation = deque(s for s in self._rotation if s not in taken)
        return picked

    def _prefetch_ahead(self) -> None:
        """Page predicted-next COLD sessions of the 2K rotation window
        into free slots of their groups (never evicting). Pipelined
        fronts on a paged store only."""
        st = self.store
        if not (self.prefetch and self.depth > 1
                and st.hot_capacity < st.capacity):
            return
        for sid in list(self._rotation)[: 2 * st.max_batch]:
            if not st.is_hot(sid):
                st.prefetch(sid)

    def pump(self, reason: str = "occupancy") -> bool:
        """Admit up to `max_batch` queue heads and serve them in ONE call:
        synchronously at `depth=1`, as an in-flight call when pipelined
        (tickets resolve at harvest). True when a batch ran (or,
        pipelined, a finished call was resolved)."""
        assert_owner(self, "serve-pump")
        ripe: list = []
        if self.depth > 1:
            # never block: resolve what finished; a full device window
            # (depth - 1 calls) skips the dispatch
            ripe = self.store.pop_ready(wait=False)
            if self.store.inflight > max(self.depth - 2, 0):
                return self._resolve(ripe) > 0
        if not self._rotation:
            return self._resolve(ripe) > 0
        m = self.metrics
        if m is not None:
            m.counter(f"serve_flush_{reason}")
            m.observe("serve_queue_depth", self.pending)
        batch: list[Ticket] = [
            self._queues[sid].popleft() for sid in self._admit_sids()
        ]
        # backlogged sessions re-join the rotation TAIL in admission order
        for t in batch:
            if self._queues[t.session_id]:
                self._rotation.append(t.session_id)
            else:
                del self._queues[t.session_id]
        now = time.perf_counter()
        for t in batch:
            if m is not None:
                m.observe("serve_queue_wait_ms",
                          (now - t.submitted_at) * 1e3)
            if t.trace is not None:
                t.trace.stamp("batch_admit", now)
        if m is not None:
            m.observe("serve_batch_occupancy", len(batch))
        sids = [t.session_id for t in batch]
        if self.depth > 1:
            try:
                with _span(self.trace, "serve/dispatch"):
                    call = self.store.dispatch_batch(sids)
            except Exception:
                # a bad session id fails at validation, before any
                # dispatch: drain the window first (a session's
                # decisions stay in order), then serve one by one
                self._resolve(ripe)
                self._harvest(wait=True)
                self._one_by_one(batch)
                return True
            call.tickets = batch
            self._prefetch_ahead()
            self._resolve(ripe)
            if len(self._rotation) < self.store.max_batch:
                # no full next batch behind this call: a deferred harvest
                # would only delay its replies
                self._harvest(wait=True)
            return True
        try:
            with _span(self.trace, "serve/flush"):
                results = self.store.decide_batch(sids)
        except Exception:
            self._one_by_one(batch)
            return True
        for t, r in zip(batch, results):
            t.result = r
            self._finish(t)
        self._evict_unservable(batch)
        return True

    def _one_by_one(self, batch: list[Ticket]) -> None:
        """A batch call that raised: re-serve each ticket alone, so only
        the offender fails its own."""
        for t in batch:
            try:
                t.result = self.store.decide(t.session_id)
            except Exception as e:
                t.error = e
            self._finish(t)
        self._evict_unservable(batch)


def _check_keys(cfg: dict[str, Any]) -> None:
    unknown = set(cfg) - set(SERVE_KEYS)
    if unknown:
        raise ValueError(
            f"unknown serve: config key(s) {sorted(unknown)}; known "
            f"keys: {sorted(SERVE_KEYS)}"
        )


def store_from_config(
    cfg: dict[str, Any] | None,
    params: EnvParams,
    bank: WorkloadBank,
    scheduler,
    **overrides: Any,
) -> SessionStore:
    """Build a `SessionStore` from a top-level `serve:` YAML block, on
    the card unless `device="cpu"` is among the overrides. Unknown keys
    fail as in the JAX package; a store knob the port has not ported
    yet (`shard_dp`, `donate: false`) raises `NotImplementedError`.
    `record`, `ring` and `ring_drain` pass through to the store.
    `front`/`linger_ms`/`depth`/... are front knobs
    (`front_from_config`), `host`/`port`/quotas server knobs
    (`serve/server.py:server_from_config`)."""
    cfg = dict(cfg or {})
    _check_keys(cfg)
    if cfg.get("shard_dp"):
        raise _not_ported("shard_dp", "a dp-sharded store", "A12")
    kw: dict[str, Any] = {
        "capacity": int(cfg.get("capacity", 64)),
        "max_batch": int(cfg.get("max_batch", 8)),
        "deterministic": bool(cfg.get("deterministic", True)),
        "donate": bool(cfg.get("donate", True)),
        "seed": int(cfg.get("seed", 0)),
        "trace": bool(cfg.get("trace", False)),
        "record": bool(cfg.get("record", False)),
        "ring": int(cfg.get("ring", 0)),
        "groups": int(cfg.get("groups", 1)),
        "harvester": bool(cfg.get("harvester", False)),
    }
    if cfg.get("ring_drain") is not None:
        kw["ring_drain"] = int(cfg["ring_drain"])
    if cfg.get("hot_capacity") is not None:
        kw["hot_capacity"] = int(cfg["hot_capacity"])
    if cfg.get("metrics", False):
        from ..obs.metrics import MetricsRegistry

        kw["metrics"] = MetricsRegistry()
    kw.update(overrides)
    return SessionStore(params, bank, scheduler, **kw)


def front_from_config(
    cfg: dict[str, Any] | None,
    store: SessionStore,
    **overrides: Any,
) -> "ContinuousBatcher | MicroBatcher":
    """Build the batching front the `serve:` block names: `front:
    continuous` (the default), `front: pipelined` (the continuous
    batcher with a depth-D in-flight window; `depth` defaults to the
    store's group count, at least 2) or `front: linger` (the
    `MicroBatcher`; `linger_ms` applies to it alone). The attribution
    analyzer rides the front when `trace` is on (`attribution`
    defaults to it). Errors are the JAX package's."""
    cfg = dict(cfg or {})
    front = str(cfg.get("front", "continuous"))
    traced = bool(overrides.get("trace", cfg.get("trace", False)))
    attribution = bool(cfg.get("attribution", traced))
    if attribution and not traced:
        raise ValueError(
            "serve: attribution: true requires trace: true (the "
            "analyzer decomposes the per-request span stamps)"
        )
    if attribution and "critpath" not in overrides:
        from ..obs.critpath import CritPathAnalyzer

        overrides["critpath"] = CritPathAnalyzer(
            metrics=overrides.get("metrics", store.metrics),
            runlog=overrides.get("runlog"),
        )
    if front != "pipelined":
        stray = {"depth", "prefetch"} & set(cfg)
        if stray:
            raise ValueError(
                f"serve: {sorted(stray)} only apply to "
                f"front: pipelined (got front: {front})"
            )
    if front in ("continuous", "pipelined"):
        overrides.setdefault("pager_aware",
                             bool(cfg.get("pager_aware", True)))
        if front == "pipelined":
            depth = int(cfg.get("depth", max(2, store.groups)))
            if depth < 2:
                raise ValueError(
                    f"front: pipelined needs depth >= 2, got {depth} "
                    "(depth 1 is the synchronous continuous front — "
                    "name it that)"
                )
            overrides.setdefault("depth", depth)
            overrides.setdefault("prefetch",
                                 bool(cfg.get("prefetch", True)))
        return ContinuousBatcher(store, **overrides)
    if front == "linger":
        return MicroBatcher(store, linger_ms=float(cfg.get("linger_ms", 1.0)),
                            **overrides)
    raise ValueError(
        f"unknown serve front {front!r}; known: continuous, "
        "pipelined, linger"
    )
