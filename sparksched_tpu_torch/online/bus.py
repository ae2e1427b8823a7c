"""The swap side of the online loop: staged, probationary publication of
learned weights into live serving (counterpart of
`sparksched_tpu/online/bus.py`).

The learner PUBLISHES versions; the serving thread PUMPS the bus between
serve calls, the only place a swap may land: the store swaps its weights
in place (`SessionStore.set_params`), so the copy must interleave with
the calls on the serving thread, never race them. A version published
from the learner's CUDA stream comes with an event recorded after its
update; the pump makes the serving stream wait on that event before the
copy, so no served batch reads half-written weights, and marks the
published tensors as used on the serving stream before it lets them go.

Quarantine-style rollback: every applied swap opens a PROBATION window
of `probation_decisions` served decisions. If the quarantine rate over
the window (health-sentinel trips / decisions) exceeds
`max_quarantine_rate`, the bus reverts the store to the last PROVEN
version (`SessionStore.rollback_params`). A version that survives its
window is marked proven and becomes the next rollback target. Publish
is latest-wins: if the learner outpaces serving, intermediate versions
are skipped (counted), never queued.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from ..obs.runlog import emit
from ..ownership import assert_owner


class ParamBus:
    def __init__(
        self,
        store,
        *,
        probation_decisions: int = 32,
        max_quarantine_rate: float = 0.5,
        runlog=None,
        metrics=None,
        on_event=None,
    ) -> None:
        self.store = store
        self.probation_decisions = int(probation_decisions)
        self.max_quarantine_rate = float(max_quarantine_rate)
        self.runlog = runlog
        self.metrics = metrics
        # observer of the pump's events (swap / rollback / proven dicts,
        # called on the serving thread): `obs.slo.OnlineLoopProbe.
        # on_bus_event` hangs its swap-to-first-decision clock here
        self.on_event = on_event
        self._lock = threading.Lock()
        self._pending: tuple[Any, int, Any] | None = None
        # version 0 (the store's construction weights) is proven by
        # definition: it is what the service launched with
        self._proven = True
        self._probation: dict[str, int] | None = None
        self.stats = {
            "bus_published": 0,
            "bus_applied": 0,
            "bus_skipped": 0,
            "bus_rollbacks": 0,
            "bus_proven": 0,
        }

    def _count(self, key: str, n: int = 1) -> None:
        # bumped from both sides of the bus (publish on the learner
        # thread, pump on the serving thread): never call while holding
        # the lock (it is not reentrant)
        with self._lock:
            self.stats[key] += n
        if self.metrics is not None:
            self.metrics.counter(key, n)

    # -- learner side ---------------------------------------------------

    def publish(self, params: dict[str, torch.Tensor], version: int,
                ready: torch.cuda.Event | None = None) -> None:
        """Stage a version (a state dict the bus may keep: the publisher
        must not write it again) for the next pump. `ready`, on the
        card, is an event recorded after the tensors were written. Latest
        wins: an unpumped older publish is dropped and counted."""
        assert_owner(self, "online-learner")
        with self._lock:
            skipped = self._pending is not None
            self._pending = (params, int(version), ready)
        if skipped:
            self._count("bus_skipped")
        self._count("bus_published")

    # -- serving side ---------------------------------------------------

    def pump(self) -> dict[str, Any] | None:
        """Called from the serving thread between serve calls: close out
        a finished probation window (rollback or prove), then apply any
        pending publish. Returns an event dict when something happened
        (swap / rollback / proven), else None."""
        assert_owner(self, "serve-pump")
        event = self._pump()
        if event is not None and self.on_event is not None:
            self.on_event(event)
        return event

    def _pump(self) -> dict[str, Any] | None:
        event = self._check_probation()
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return event
        params, version, ready = pending
        if ready is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(ready)
            for t in params.values():
                # the copy below runs on the serving stream: the
                # allocator must not hand these blocks to the learner's
                # stream before it has
                t.record_stream(stream)
        applied = self.store.set_params(
            params, version=version, origin="swap",
            reason="learner publish",
            # only a PROVEN outgoing version may become the rollback
            # target; re-publishing over an on-probation version keeps
            # the older proven one as the fallback
            mark_good=self._proven,
        )
        self._proven = False
        st = self.store.stats
        self._probation = {
            "version": applied,
            "dec0": st["serve_decisions"],
            "q0": st["serve_quarantines"],
        }
        self._count("bus_applied")
        return {"event": "swap", "version": applied}

    def _check_probation(self) -> dict[str, Any] | None:
        p = self._probation
        if p is None:
            return None
        st = self.store.stats
        decided = st["serve_decisions"] - p["dec0"]
        if decided < self.probation_decisions:
            return None
        quar = st["serve_quarantines"] - p["q0"]
        rate = quar / max(decided, 1)
        self._probation = None
        if rate > self.max_quarantine_rate:
            reverted = self.store.rollback_params(
                reason=(
                    f"post-swap quarantine rate {rate:.3f} > "
                    f"{self.max_quarantine_rate:g} over {decided} "
                    "decisions"
                )
            )
            self._proven = True  # back on a proven version
            self._count("bus_rollbacks")
            emit(
                f"[online] params v{p['version']} rolled back to "
                f"v{reverted} (quarantine rate {rate:.3f} over "
                f"{decided} decisions)"
            )
            return {
                "event": "rollback", "from_version": p["version"],
                "to_version": reverted, "quarantine_rate": rate,
            }
        self._proven = True
        self._count("bus_proven")
        if self.runlog is not None:
            self.runlog.write(
                "params_swap", version=p["version"],
                prev_version=p["version"], action="proven",
                decisions=decided, quarantine_rate=round(rate, 4),
            )
        return {
            "event": "proven", "version": p["version"],
            "quarantine_rate": rate,
        }
