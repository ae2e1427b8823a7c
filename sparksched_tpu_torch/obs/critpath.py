"""Per-request critical-path attribution (counterpart of
`sparksched_tpu/obs/critpath.py`; host-only code, copied).

- `decompose(spans)` turns any subset of a request's span stamps
  (`obs/tracing.py` `SPAN_ORDER`) into additive, non-overlapping
  segments that sum to the measured wall latency exactly: each gap
  between adjacent present boundaries belongs to the segment of the
  earlier boundary. Segments: `wire_submit` (client bracket to server
  submit; the whole wall of a request that never reached a server),
  `queue_wait` (submit -> batch_admit), `batch_form` (batch_admit ->
  dispatch), `dispatch` (dispatch -> harvest: the issue plus the
  in-flight residency of the pipelined front), `device_compute`
  (harvest -> device_compute: the host's wait for the card),
  `harvest` (device_compute -> scatter_back -> reply: materialization
  and ticket resolution) and `wire_reply` (network and serialization,
  both directions).
- `SegmentProfile` keeps the joint (wall bucket x segment) sums next
  to a wall-latency `StreamingHistogram`, so the segment mix of the
  requests NEAR a quantile can be read.
- `CritPathAnalyzer` is fed one trace per finished request by the
  fronts (`serve/session.py _finish_ticket`): global, per-tenant and
  per-replica profiles, per-segment `serve_seg_<name>_ms` histograms in
  the shared `MetricsRegistry`, and the slowest-N traces of each window
  as `tail_exemplar` run-log records. It is single-owner state driven
  by the serve pump; the wire client uses the pure `decompose`.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Any, Callable

from .metrics import StreamingHistogram
from .tracing import SPAN_ORDER
from ..ownership import assert_owner

# attribution segments, in boundary order (the runlog / scoreboard /
# bench row vocabulary)
SEGMENTS = (
    "wire_submit", "queue_wait", "batch_form", "dispatch",
    "device_compute", "harvest", "wire_reply",
)

# the gap starting at span boundary <key> belongs to segment <value>;
# `scatter_back -> reply` merges into `harvest` (both are host
# materialization/resolution — splitting them adds a segment no
# operator decision distinguishes)
_SEG_OF_GAP = {
    "wire_submit": "wire_submit",
    "submit": "queue_wait",
    "batch_admit": "batch_form",
    "dispatch": "dispatch",
    "harvest": "device_compute",
    "device_compute": "harvest",
    "scatter_back": "harvest",
    "reply": "wire_reply",
}

# metric-registry histogram name per segment (what the fleet
# collector windows per replica)
SEG_HIST = {s: f"serve_seg_{s}_ms" for s in SEGMENTS}

_SPAN_RANK = {name: i for i, name in enumerate(SPAN_ORDER)}


def decompose(spans: dict[str, float], *,
              scale_ms: float = 1e3) -> dict[str, Any]:
    """Decompose one request's span stamps into additive segments.

    `spans` maps span name -> stamp, in ANY consistent unit: raw
    perf_counter seconds (`scale_ms=1e3`, the Ticket/WireTicket
    shape) or ms offsets (`scale_ms=1.0`, the runlog `trace` record /
    `RequestTrace.offsets_ms` shape). Unknown span names are ignored;
    the decomposition works on any subset of `SPAN_ORDER` with >= 2
    present boundaries (a single-boundary trace has zero wall and an
    empty decomposition).

    Returns `{"wall_ms", "segments": {segment: ms}, "first", "last"}`
    and GUARANTEES sum(segments.values()) == wall_ms to float
    round-off (test-pinned) — the invariant is checked here, so a
    trace whose stamps violate it (impossible by telescoping) raises
    rather than shipping books that don't balance.
    """
    present = sorted(
        (n for n in spans if n in _SPAN_RANK),
        key=_SPAN_RANK.__getitem__,
    )
    segments: dict[str, float] = {}
    if len(present) < 2:
        return {"wall_ms": 0.0, "segments": segments,
                "first": present[0] if present else None,
                "last": present[0] if present else None}
    wall = (spans[present[-1]] - spans[present[0]]) * scale_ms
    for a, b in itertools.pairwise(present):
        gap = (spans[b] - spans[a]) * scale_ms
        seg = _SEG_OF_GAP[a]
        segments[seg] = segments.get(seg, 0.0) + gap
    total = sum(segments.values())
    if abs(total - wall) > 1e-6 + 1e-9 * abs(wall):
        raise ValueError(
            f"segment decomposition does not sum to wall latency: "
            f"{total!r} != {wall!r} over spans {sorted(spans)}"
        )
    return {"wall_ms": wall, "segments": segments,
            "first": present[0], "last": present[-1]}


class SegmentProfile:
    """Joint (wall-latency bucket x segment) accounting: a wall
    `StreamingHistogram` plus, per wall bucket, the request count and
    per-segment ms sums of the requests that landed there. O(buckets)
    like the histogram itself; `attribution_at(q)` reads the segment
    mix of the requests NEAR quantile q."""

    __slots__ = ("wall", "_cells")

    def __init__(self) -> None:
        self.wall = StreamingHistogram()
        # bucket index -> [count, {segment: ms sum}]
        self._cells: dict[int, list] = {}

    def add(self, wall_ms: float, segments: dict[str, float]) -> None:
        idx = self.wall._index(max(0.0, float(wall_ms)))
        self.wall.add(wall_ms)
        cell = self._cells.get(idx)
        if cell is None:
            cell = self._cells[idx] = [0, {}]
        cell[0] += 1
        sums = cell[1]
        for seg, ms in segments.items():
            sums[seg] = sums.get(seg, 0.0) + ms

    def attribution_at(self, q: float,
                       min_requests: int = 8) -> dict[str, Any] | None:
        """Segment mix of the requests near quantile `q`: starting
        from the wall bucket holding the q-quantile, grow the bucket
        window symmetrically until it covers >= `min_requests`
        requests (or 5% of the population, whichever is larger, capped
        by the population). Returns `{"wall_ms", "n", "share", and
        "mean_ms" per segment}`, or None on an empty profile."""
        if self.wall.count == 0:
            return None
        target = self.wall.quantile(q)
        center = self.wall._index(target)
        want = min(self.wall.count,
                   max(int(min_requests), self.wall.count // 20))
        n = 0
        sums: dict[str, float] = {}
        lo = hi = center
        span_max = len(self.wall.counts)
        for radius in range(span_max + 1):
            for idx in ({center} if radius == 0
                        else {center - radius, center + radius}):
                cell = self._cells.get(idx)
                if cell is None:
                    continue
                n += cell[0]
                for seg, ms in cell[1].items():
                    sums[seg] = sums.get(seg, 0.0) + ms
                lo, hi = min(lo, idx), max(hi, idx)
            if n >= want:
                break
        total = sum(sums.values())
        return {
            "q": q,
            "wall_ms": round(target, 4),
            "n": n,
            "share": {
                seg: round(ms / total, 4) if total > 0 else 0.0
                for seg, ms in sorted(sums.items())
            },
            "mean_ms": {
                seg: round(ms / n, 4) if n else 0.0
                for seg, ms in sorted(sums.items())
            },
        }

    def dominant_segment(self, q: float = 0.99) -> str | None:
        att = self.attribution_at(q)
        if att is None or not att["share"]:
            return None
        return max(att["share"].items(), key=lambda kv: kv[1])[0]

    def summary(self) -> dict[str, Any]:
        out: dict[str, Any] = {"n": self.wall.count}
        for q, label in ((0.5, "at_p50"), (0.99, "at_p99")):
            att = self.attribution_at(q)
            if att is not None:
                out[label] = att
        dom = self.dominant_segment()
        if dom is not None:
            out["dominant_tail_segment"] = dom
        return out


class _Exemplar:
    """Heap entry: min-heap on wall so the reservoir keeps the
    slowest-N; `seq` breaks ties deterministically."""

    __slots__ = ("wall_ms", "seq", "record")

    def __init__(self, wall_ms: float, seq: int,
                 record: dict[str, Any]) -> None:
        self.wall_ms = wall_ms
        self.seq = seq
        self.record = record

    def __lt__(self, other: "_Exemplar") -> bool:
        return (self.wall_ms, self.seq) < (other.wall_ms, other.seq)


class CritPathAnalyzer:
    """The serving-side attribution instrument (module docstring).

    `add(trace, ...)` per finished request; `snapshot()` for the
    attribution block a scrape/bench row stamps; `flush_window()`
    emits the window's slowest-N traces as `tail_exemplar` runlog
    records (called from `add` when `window_s` elapses, and by the
    fleet collector's scrape so exemplars ship even on an idle
    tail)."""

    def __init__(self, *, metrics=None, runlog=None, top_n: int = 8,
                 window_s: float = 60.0, max_keys: int = 32,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.metrics = metrics
        self.runlog = runlog
        self.top_n = max(1, int(top_n))
        self.window_s = float(window_s)
        self.max_keys = max(1, int(max_keys))
        self._clock = clock
        self.profile = SegmentProfile()
        self.by_tenant: dict[str, SegmentProfile] = {}
        self.by_replica: dict[str, SegmentProfile] = {}
        self._exemplars: list[_Exemplar] = []
        self._seq = 0
        self._window_start = self._clock()
        self.stats = {
            "critpath_requests": 0,
            "critpath_errors": 0,
            "critpath_exemplar_windows": 0,
            "critpath_exemplars": 0,
        }

    # -- feed ----------------------------------------------------------

    def add(self, trace, *, tenant=None, replica=None,
            error: str | None = None) -> dict[str, Any]:
        """Ingest one finished request's `RequestTrace` (raw
        perf_counter stamps). Returns the decomposition (the caller
        may stamp it on a reply or a bench row)."""
        assert_owner(self, "serve-pump")
        return self.observe(
            trace.spans, trace_id=trace.trace_id, scale_ms=1e3,
            tenant=tenant, replica=replica, error=error,
        )

    def observe(self, spans: dict[str, float], *,
                trace_id: str | None = None, scale_ms: float = 1e3,
                tenant=None, replica=None,
                error: str | None = None) -> dict[str, Any]:
        """`add` for span dicts that aren't `RequestTrace`s (ms-offset
        records replayed from a runlog: pass `scale_ms=1.0`)."""
        dec = decompose(spans, scale_ms=scale_ms)
        wall, segments = dec["wall_ms"], dec["segments"]
        self.stats["critpath_requests"] += 1
        if error is not None:
            self.stats["critpath_errors"] += 1
        self.profile.add(wall, segments)
        if tenant is not None:
            self._keyed(self.by_tenant, str(tenant)).add(
                wall, segments)
        if replica is not None:
            self._keyed(self.by_replica, str(replica)).add(
                wall, segments)
        if self.metrics is not None:
            for seg, ms in segments.items():
                self.metrics.observe(SEG_HIST[seg], ms)
        self._seq += 1
        ex = _Exemplar(wall, self._seq, {
            "trace_id": trace_id,
            "wall_ms": round(wall, 4),
            "segments": {k: round(v, 4) for k, v in segments.items()},
            "tenant": None if tenant is None else str(tenant),
            "replica": None if replica is None else str(replica),
            "error": error,
        })
        if len(self._exemplars) < self.top_n:
            heapq.heappush(self._exemplars, ex)
        elif self._exemplars[0] < ex:
            heapq.heapreplace(self._exemplars, ex)
        self.maybe_flush_window()
        return dec

    def _keyed(self, table: dict[str, SegmentProfile],
               key: str) -> SegmentProfile:
        prof = table.get(key)
        if prof is None:
            if len(table) >= self.max_keys:
                # bounded cardinality: the long tail of keys shares
                # one overflow profile instead of growing the table
                key = "~other"
                prof = table.get(key)
                if prof is not None:
                    return prof
            prof = table[key] = SegmentProfile()
        return prof

    # -- exemplars -----------------------------------------------------

    def maybe_flush_window(self, now: float | None = None
                           ) -> list[dict[str, Any]]:
        """`flush_window` iff `window_s` has elapsed — the cadence
        guard shared by `observe` and the fleet collector's scrape
        (which flushes an IDLE tail: no new requests, the reservoir
        still ships)."""
        t = self._clock() if now is None else float(now)
        if t - self._window_start < self.window_s:
            return []
        return self.flush_window(now=t)

    def flush_window(self, now: float | None = None
                     ) -> list[dict[str, Any]]:
        """Emit the current window's slowest-N traces as
        `tail_exemplar` runlog records (slowest first) and reset the
        reservoir. No-op (empty list) on an empty window."""
        t = self._clock() if now is None else float(now)
        window_s = t - self._window_start
        self._window_start = t
        if not self._exemplars:
            return []
        out = [e.record for e in
               sorted(self._exemplars, reverse=True)]
        self._exemplars = []
        self.stats["critpath_exemplar_windows"] += 1
        self.stats["critpath_exemplars"] += len(out)
        if self.runlog is not None:
            for rank, rec in enumerate(out):
                self.runlog.tail_exemplar(
                    rank=rank, window_s=round(window_s, 3), **rec)
        return out

    # -- read ----------------------------------------------------------

    def dominant_tail_segment(self) -> str | None:
        return self.profile.dominant_segment()

    def snapshot(self) -> dict[str, Any]:
        """The attribution block: global p50/p99 segment mixes plus
        each tenant's and replica's dominant tail segment (full
        per-key profiles stay internal — the block must stay small
        enough to stamp on every bench row / fleet scrape)."""
        block = self.profile.summary()
        block["stats"] = dict(self.stats)
        for label, table in (("tenants", self.by_tenant),
                             ("replicas", self.by_replica)):
            if table:
                block[label] = {
                    key: {
                        "n": prof.wall.count,
                        "p99_wall_ms": round(
                            prof.wall.quantile(0.99), 4),
                        "dominant_tail_segment":
                            prof.dominant_segment(),
                    }
                    for key, prof in sorted(table.items())
                }
        return block
