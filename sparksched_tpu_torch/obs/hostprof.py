"""A role-attributed sampling profiler of the serving and online host
threads (counterpart of `sparksched_tpu/obs/hostprof.py`; host-only
code, copied).

`obs/critpath.py` says WHICH segment of the request path owns the tail;
this module says WHERE IN THE CODE the host side spends its time. It is
a wall-clock sampler over `sys._current_frames()` that keys every
sample to the thread-role model of `ownership.py` (`ROLE_NAMES`: pump,
HTTP handler, harvester, client worker, learner, collector): the spawn
sites name their threads after their role, so a sample's role is a
prefix match on its thread's name, and threads that come and go between
samples are still attributed.

Per role it keeps SELF-time counts keyed by the innermost frame's
`basename:function`: what the pump thread is executing when it is on
the CPU or blocked (a pump that samples in `synchronize` waits for the
card; one that samples in the engine's Python is host-bound).

Zero cost when off: a profiler never `start()`ed installs nothing (no
thread, no signal handler, no tracing hook). At the default 67 Hz a
sample is one dict walk over ~10 threads.

The sampler thread is itself a role (`host-profiler`): the sample
tables are written only by its loop; `tables()` is read after `stop()`
joins it, or from the main thread for a live peek.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any

from ..ownership import ROLE_NAMES, assert_owner

# role vocabulary of the sample tables: the ownership roles, plus
# buckets for the main thread, router replica pumps, and anything
# unrecognized (interpreter internals, user threads)
PROFILE_ROLES = ("main",) + ROLE_NAMES + ("serve-replica", "other")

_PREFIX_ROLES = tuple(r for r in PROFILE_ROLES
                      if r not in ("main", "other"))


def role_of_thread_name(name: str) -> str:
    """Map a thread name to its profile role (prefix match, same rule
    as ownership._role_of_thread, plus main/other buckets)."""
    if name == "MainThread":
        return "main"
    for r in _PREFIX_ROLES:
        if name == r or name.startswith(r + "-"):
            return r
    return "other"


class HostProfiler:
    """Sampling profiler producing per-role self-time tables.

    `start()` spawns the sampler thread; `stop()` joins it and (when
    a runlog is attached) emits one `hostprof` record carrying the
    tables. `tables()` renders per-role sample counts, wall-share,
    estimated self-ms, and the top-N innermost sites.
    """

    def __init__(self, *, hz: float = 67.0, runlog=None,
                 top_n: int = 6) -> None:
        # 67 Hz, not 100: a divisor-of-nothing rate so sampling does
        # not phase-lock with ms-granular timers (lingers, pollers)
        self.period_s = 1.0 / max(1e-3, float(hz))
        self.runlog = runlog
        self.top_n = max(1, int(top_n))
        # role -> {"basename:func": samples}; sampler-thread-owned
        self._counts: dict[str, dict[str, int]] = {}
        self._samples = 0
        self._elapsed_s = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started_at: float | None = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "HostProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._started_at = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, name="host-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self, emit: bool = True) -> dict[str, Any]:
        """Stop sampling, join the sampler, emit the `hostprof`
        runlog record (unless `emit=False`), return the tables.
        Idempotent; a never-started profiler returns empty tables."""
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
            self._thread = None
            if self._started_at is not None:
                self._elapsed_s += time.perf_counter() - self._started_at
                self._started_at = None
        tables = self.tables()
        if emit and self.runlog is not None and self._samples:
            self.runlog.hostprof(**tables)
        return tables

    @property
    def running(self) -> bool:
        return self._thread is not None

    # -- sampling ------------------------------------------------------

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.period_s):
            self._sample(me)

    def _sample(self, own_ident: int) -> None:
        assert_owner(self, "host-profiler")
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == own_ident:
                continue
            role = role_of_thread_name(names.get(ident, "?"))
            code = frame.f_code
            site = (f"{code.co_filename.rsplit('/', 1)[-1]}"
                    f":{code.co_name}")
            table = self._counts.get(role)
            if table is None:
                table = self._counts[role] = {}
            table[site] = table.get(site, 0) + 1
        self._samples += 1

    # -- read ----------------------------------------------------------

    def tables(self) -> dict[str, Any]:
        """Per-role self-time tables. `share` is the role's fraction
        of all thread-samples; `self_ms` estimates wall self-time as
        role_samples * sampling period (per THREAD-sample, so a role
        with two live threads can exceed the elapsed wall)."""
        elapsed = self._elapsed_s
        if self._started_at is not None:
            elapsed += time.perf_counter() - self._started_at
        total = sum(sum(t.values()) for t in self._counts.values())
        roles: dict[str, Any] = {}
        for role in sorted(self._counts,
                           key=lambda r: -sum(self._counts[r].values())):
            table = self._counts[role]
            n = sum(table.values())
            top = sorted(table.items(), key=lambda kv: (-kv[1], kv[0]))
            roles[role] = {
                "samples": n,
                "share": round(n / total, 4) if total else 0.0,
                "self_ms": round(n * self.period_s * 1e3, 3),
                "top": [
                    {"site": site, "samples": c,
                     "share": round(c / n, 4)}
                    for site, c in top[:self.top_n]
                ],
            }
        return {
            "samples": self._samples,
            "hz": round(1.0 / self.period_s, 2),
            "elapsed_s": round(elapsed, 3),
            "roles": roles,
        }
