"""Structured JSONL run log (counterpart of `sparksched_tpu/obs/runlog.py`,
same schema).

One file per run, one JSON object per line, each with `ev` (the record
kind) and `t` (unix seconds). The kinds the trainer writes:

- `run_start` / `run_end`: run metadata; `run_end` carries the final
  `iteration` (or a `teardown` reason when the process is ending);
- `span`: a timed host-side phase (`name`, `secs`), e.g. `iter N
  collect` and `iter N update`;
- `scalars`: the per-iteration training stats (`iteration` plus the
  stats, top-level);
- `telemetry`: an engine-telemetry summary (`obs.telemetry.summarize`,
  under `summary`);
- `memory`: a device-memory sample (`bytes_in_use`, `peak_bytes_in_use`
  from `torch.cuda.memory_stats`; none is written on the CPU);
- `health`: a tripped health sentinel (`mask`, decoded `bits`,
  `iteration`, `attempt`, `action`);
- `recovery`: a rollback-and-retry, a gave-up marker, or a checkpoint
  fallback past a torn generation;
- `resume`: a train state resumed (`path`, `iteration`).

The serving stack writes `trace` (one request's span walk), `params_swap`
(a serving-weights swap or rollback), `metrics` (a `MetricsRegistry`
snapshot) and `tail_exemplar` (a slow request's critical path).

Every record is flushed when written. Open run logs are closed with a
`run_end` carrying a `teardown` reason from an `atexit` hook and, when
the process has no SIGTERM handler of its own, from a chained one.
`max_bytes` caps the active file: a write past it renames the file to
`<path>.<n>` and reopens `<path>` with a `rotate` record.

The JAX package's JIT-compile listener (`install_jit_hooks`) has no
counterpart: the port runs eagerly and compiles nothing.
"""

from __future__ import annotations

import atexit
import glob
import json
import os
import os.path as osp
import signal
import sys
import threading
import time
import weakref
from typing import Any


def emit(msg: str) -> None:
    """A console progress line (stdout, flushed)."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


_CREATE_COUNTER = 0


def _json_safe(v: Any) -> Any:
    """numpy / torch scalars -> Python numbers; anything else that JSON
    cannot hold -> str."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if hasattr(v, "item"):
        try:
            return _json_safe(v.item())
        except Exception:
            pass
    return str(v)


class RunLog:
    """Append-only JSONL writer (thread-safe)."""

    def __init__(self, path: str, max_bytes: int | None = None) -> None:
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes else None
        self._lock = threading.Lock()
        self._fp = open(path, "a")
        self._closed = False
        # number rotations past any suffixes already on disk, so an
        # earlier run's segments are never overwritten
        self._rotations = 0
        if self.max_bytes:
            for p in glob.glob(glob.escape(path) + ".*"):
                tail = p[len(path) + 1:]
                if tail.isdigit():
                    self._rotations = max(self._rotations, int(tail))
        _OPEN_RUNLOGS.add(self)
        _install_teardown_hooks()

    @classmethod
    def create(cls, artifacts_dir: str,
               max_bytes: int | None = None) -> "RunLog":
        """Open `artifacts_dir/runlog/run-<time>-<pid>-<n>.jsonl`: the
        name holds a per-process counter, so two runs never share a
        file."""
        global _CREATE_COUNTER
        _CREATE_COUNTER += 1
        name = f"run-{int(time.time())}-{os.getpid()}-{_CREATE_COUNTER}"
        return cls(osp.join(artifacts_dir, "runlog", f"{name}.jsonl"),
                   max_bytes=max_bytes)

    # -- record writers ----------------------------------------------------

    def write(self, ev: str, **fields: Any) -> None:
        if self._closed:
            return
        rec = {"ev": ev, "t": round(time.time(), 3)}
        rec.update({k: _json_safe(v) for k, v in fields.items()})
        line = json.dumps(rec)
        with self._lock:
            if self._closed:
                return
            self._fp.write(line + "\n")
            self._fp.flush()
            # run_end stays the active file's last record
            if (self.max_bytes and ev != "run_end"
                    and self._fp.tell() >= self.max_bytes):
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Rename the full active file to `<path>.<n>` and reopen `<path>`
        with a `rotate` record (the caller holds the lock). A failed
        rename keeps appending to the active file."""
        try:
            self._fp.close()
            self._rotations += 1
            os.replace(self.path, f"{self.path}.{self._rotations}")
            self._fp = open(self.path, "a")
            cont = {"ev": "rotate", "t": round(time.time(), 3),
                    "segment": self._rotations,
                    "prev": f"{self.path}.{self._rotations}"}
            self._fp.write(json.dumps(cont) + "\n")
            self._fp.flush()
        except OSError:
            self._fp = open(self.path, "a")

    def span_event(self, name: str, secs: float, **fields: Any) -> None:
        """A span measured by the caller."""
        self.write("span", name=name, secs=round(float(secs), 4), **fields)

    def scalars(self, iteration: int, stats: dict[str, Any]) -> None:
        self.write("scalars", iteration=int(iteration), **stats)

    def telemetry(self, summary: dict[str, Any],
                  iteration: int | None = None, **fields: Any) -> None:
        if iteration is not None:
            fields["iteration"] = int(iteration)
        self.write("telemetry", summary=summary, **fields)

    def health(self, mask: int, iteration: int | None = None,
               **fields: Any) -> None:
        """A tripped health sentinel: the bitmask and its bit names."""
        from ..env.health import describe_mask

        if iteration is not None:
            fields["iteration"] = int(iteration)
        self.write("health", mask=int(mask), bits=describe_mask(mask),
                   **fields)

    def memory(self, stats: dict[str, Any],
               iteration: int | None = None) -> None:
        """A device-memory sample, its keys top-level."""
        fields = {} if iteration is None else {"iteration": int(iteration)}
        self.write("memory", **(dict(stats) | fields))

    def trace(self, trace_id: str, spans_ms: dict[str, float],
              **fields: Any) -> None:
        """One served request's span walk: `spans_ms` maps phase name to
        its offset in ms from submit; `total_ms` is the `reply` offset."""
        total = spans_ms.get("reply")
        self.write(
            "trace", trace_id=trace_id,
            spans={k: round(float(v), 4) for k, v in spans_ms.items()},
            total_ms=None if total is None else round(float(total), 4),
            **fields,
        )

    def params_swap(self, version: int, prev_version: int,
                    action: str = "swap", reason: str | None = None,
                    **fields: Any) -> None:
        """A serving-weights swap (`action` "swap") or a revert to the
        last-good version ("rollback")."""
        if reason is not None:
            fields["reason"] = reason
        self.write("params_swap", version=int(version),
                   prev_version=int(prev_version), action=action, **fields)

    def metrics(self, snapshot: dict[str, Any],
                iteration: int | None = None, **fields: Any) -> None:
        """A `MetricsRegistry.snapshot()`, nested under `snapshot`."""
        if iteration is not None:
            fields["iteration"] = int(iteration)
        self.write("metrics", snapshot=snapshot, **fields)

    def tail_exemplar(self, trace_id: str | None, wall_ms: float,
                      segments: dict[str, float], **fields: Any) -> None:
        """One of an attribution window's slowest requests, its
        critical-path segments summing to `wall_ms`."""
        self.write(
            "tail_exemplar", trace_id=trace_id,
            wall_ms=round(float(wall_ms), 4),
            segments={k: round(float(v), 4) for k, v in segments.items()},
            **fields,
        )

    def fleet(self, **status: Any) -> None:
        """One fleet-collector scoreboard snapshot: the per-replica rows
        and the fleet's aggregate window, as
        `obs.fleet.FleetCollector.scrape` computed them."""
        self.write("fleet", **status)

    def alert(self, slo: str, **fields: Any) -> None:
        """An SLO burn-rate alert: the spec that breached (`slo`), both
        windows' burn rates, the rule's windows and factor, and the
        `action` taken (`none` or `rollback`). Written by
        `obs.slo.SLOMonitor` when it fires."""
        self.write("alert", slo=slo, **fields)

    def hostprof(self, **tables: Any) -> None:
        """One role-attributed host profile (`obs.hostprof.HostProfiler`
        tables), written once at the profiler's `stop()`."""
        self.write("hostprof", **tables)

    def close(self, **fields: Any) -> None:
        if self._closed:
            return
        self.write("run_end", **fields)
        with self._lock:
            self._closed = True
            self._fp.close()
        _OPEN_RUNLOGS.discard(self)

    def _teardown(self, reason: str) -> None:
        """Close from a signal handler: never blocks on the writer lock
        (the signal may have landed inside a write); when the lock is
        taken the file is left as the per-write flushes left it."""
        if self._closed or not self._lock.acquire(blocking=False):
            return
        try:
            if self._closed:
                return
            try:
                rec = {"ev": "run_end", "t": round(time.time(), 3),
                       "teardown": reason}
                self._fp.write(json.dumps(rec) + "\n")
                self._fp.flush()
            finally:
                self._closed = True
                self._fp.close()
        finally:
            self._lock.release()
        _OPEN_RUNLOGS.discard(self)

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()


# ---------------------------------------------------------------------------
# teardown: stamp `run_end` on the exits a process can still observe
# (interpreter shutdown; SIGTERM when the process has no handler of its
# own, re-raised afterwards so the exit status is unchanged)
# ---------------------------------------------------------------------------

_OPEN_RUNLOGS: "weakref.WeakSet[RunLog]" = weakref.WeakSet()
_ATEXIT_INSTALLED = False
_SIGTERM_INSTALLED = False


def _close_open_runlogs(reason: str, from_signal: bool = False) -> None:
    for rl in list(_OPEN_RUNLOGS):
        try:
            if from_signal:
                rl._teardown(reason)
            else:
                rl.close(teardown=reason)
        except Exception:
            pass  # teardown must never mask the original exit


def _install_teardown_hooks() -> None:
    global _ATEXIT_INSTALLED, _SIGTERM_INSTALLED
    if not _ATEXIT_INSTALLED:
        _ATEXIT_INSTALLED = True
        atexit.register(_close_open_runlogs, "atexit")
    if _SIGTERM_INSTALLED:
        return
    if threading.current_thread() is not threading.main_thread():
        return  # signal.signal is main-thread-only
    try:
        prev = signal.getsignal(signal.SIGTERM)
    except (ValueError, OSError):
        return
    if prev is not signal.SIG_DFL:
        _SIGTERM_INSTALLED = True  # the application owns SIGTERM
        return

    def _on_sigterm(signum, frame):
        signal.signal(signum, signal.SIG_DFL)
        _close_open_runlogs("sigterm", from_signal=True)
        os.kill(os.getpid(), signum)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
        _SIGTERM_INSTALLED = True
    except (ValueError, OSError):
        pass
