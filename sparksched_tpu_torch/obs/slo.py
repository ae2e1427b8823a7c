"""Declarative SLOs under multi-window burn-rate alerting, and the
online loop's depth probe (counterpart of `sparksched_tpu/obs/slo.py`;
host-only code, copied).

An SLO is a budgeted objective over a window: burn = (bad fraction in
the window) / budget, and a rule fires only when BOTH a long window and
a short companion window burn above a factor (the long window proves the
budget is going, the short one that it still is). `DEFAULT_WINDOWS` is
the two-rule ladder: fast burn 60 s / 15 s at 2x, slow burn 300 s /
60 s at 1x. Four kinds, each measured from the fleet collector's
per-scrape window (`obs/fleet.py`):

- `latency`  fraction of requests over `bound` ms against `budget`
  (default 0.01, a p99 objective), from the windowed histogram;
- `ratio`    bad/total events against `budget` == bound (the
  quarantine rate);
- `floor`    a scalar that must stay >= bound (goodput); one binary
  event per scrape, `budget` 0.5, idle scrapes carry no signal;
- `ceiling`  a scalar that must stay <= bound (params staleness).

Alerts are `alert` run-log records. A spec named in `rollback_on` also
drives a `rollback_params` facade (a `SessionStore`, a `Router`, a
`ParamBus`'s store). A per-spec cooldown keeps a sustained breach from
firing every scrape.

`OnlineLoopProbe` sits in the store's collector seat (`add` /
`on_close`), forwards everything to the inner collector (a
`TrajectoryBuffer`) and keeps the loop's health: a per-decision
staleness histogram, swap-to-first-decision latency (wire
`bus.on_event = probe.on_bus_event`) and rewards per params version.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .metrics import StreamingHistogram

# (long_s, short_s, factor): fire when burn(long) >= factor AND
# burn(short) >= factor. Fast-burn page + slow-burn ticket ladder.
DEFAULT_WINDOWS: tuple[tuple[float, float, float], ...] = (
    (60.0, 15.0, 2.0),
    (300.0, 60.0, 1.0),
)

_KINDS = ("latency", "ratio", "floor", "ceiling")

# the declarative config surface: `serve: {slo: {...}}` / `obs:` keys
SLO_CONFIG_KEYS = frozenset({
    "p99_ms", "p99_budget", "goodput_floor_rps", "quarantine_rate_max",
    "max_staleness", "windows", "rollback_on", "cooldown_s",
    "min_events",
})


class SLOSpec:
    """One budgeted objective. `measure(window)` extracts this spec's
    (bad, total) event increment from a collector scrape window."""

    __slots__ = ("name", "kind", "bound", "budget")

    def __init__(self, name: str, kind: str, bound: float,
                 budget: float | None = None) -> None:
        if kind not in _KINDS:
            raise ValueError(f"slo kind {kind!r} not in {_KINDS}")
        self.name = name
        self.kind = kind
        self.bound = float(bound)
        if budget is None:
            budget = (0.01 if kind == "latency"
                      else self.bound if kind == "ratio" else 0.5)
        if not 0 < budget <= 1:
            raise ValueError(
                f"slo {name}: budget must be in (0, 1], got {budget}")
        self.budget = float(budget)

    def measure(self, window: dict[str, Any]) -> tuple[float, float]:
        """(bad, total) events this window contributes. (0, 0) means
        no signal (idle window) — it dilutes nothing."""
        if self.kind == "latency":
            h: StreamingHistogram | None = window.get("latency_hist")
            if h is None or h.count == 0:
                return 0.0, 0.0
            return float(h.count_above(self.bound)), float(h.count)
        if self.kind == "ratio":
            total = float(window.get("decisions", 0))
            if total <= 0:
                return 0.0, 0.0
            return float(window.get("quarantines", 0)), total
        if self.kind == "floor":
            if float(window.get("decisions", 0)) <= 0:
                return 0.0, 0.0
            v = float(window.get("goodput_rps", 0.0))
            return (1.0 if v < self.bound else 0.0), 1.0
        # ceiling
        v = window.get("params_lag_max")
        if v is None:
            return 0.0, 0.0
        return (1.0 if float(v) > self.bound else 0.0), 1.0

    def describe(self) -> dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "bound": self.bound, "budget": self.budget}


class SLOMonitor:
    """Burn-rate evaluation over the specs' event series. The fleet
    collector calls `ingest(window, now)` once per scrape; alerts come
    back (and land in the runlog / the rollback facade) from the same
    call — one thread, no locks, the serving-side discipline."""

    def __init__(
        self,
        specs: list[SLOSpec],
        *,
        windows: tuple[tuple[float, float, float], ...] = DEFAULT_WINDOWS,
        runlog=None,
        rollback=None,
        rollback_on: tuple[str, ...] = (),
        cooldown_s: float = 30.0,
        min_events: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not specs:
            raise ValueError("SLOMonitor needs at least one SLOSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo spec names: {names}")
        unknown = set(rollback_on) - set(names)
        if unknown:
            raise ValueError(
                f"rollback_on names unknown specs {sorted(unknown)}; "
                f"specs: {sorted(names)}")
        self.specs = list(specs)
        self.windows = tuple(
            (float(l), float(s), float(f)) for l, s, f in windows
        )
        if not all(l >= s > 0 for l, s, _ in self.windows):
            raise ValueError(
                f"burn windows need long >= short > 0: {self.windows}")
        self.runlog = runlog
        self.rollback = rollback
        self.rollback_on = tuple(rollback_on)
        self.cooldown_s = float(cooldown_s)
        self.min_events = int(min_events)
        self._clock = clock
        self._horizon = max(l for l, _, _ in self.windows)
        # per-spec series of (t, bad, total) increments
        self._series: dict[str, list[tuple[float, float, float]]] = {
            s.name: [] for s in self.specs
        }
        self._last_alert: dict[str, float] = {}
        # the latest scrape window's attribution block, stamped on every
        # alert fired from that window: a `rollback_on:` decision names
        # the segment that owned the tail it fired on
        self._last_attribution: dict[str, Any] | None = None
        self.stats = {"slo_windows": 0, "slo_alerts": 0,
                      "slo_rollbacks": 0}
        self.alerts: list[dict[str, Any]] = []

    # -- ingest --------------------------------------------------------

    def ingest(self, window: dict[str, Any],
               now: float | None = None) -> list[dict[str, Any]]:
        """Record one collector scrape window and evaluate every
        burn-rate rule. Returns the alerts fired (possibly empty)."""
        t = self._clock() if now is None else float(now)
        self.stats["slo_windows"] += 1
        self._last_attribution = window.get("attribution")
        for spec in self.specs:
            bad, total = spec.measure(window)
            series = self._series[spec.name]
            series.append((t, float(bad), float(total)))
            # prune beyond the longest window (keep one extra point so
            # a window never goes empty between scrapes)
            cutoff = t - self._horizon * 1.5
            while len(series) > 2 and series[0][0] < cutoff:
                series.pop(0)
        return self.evaluate(t)

    def _burn(self, name: str, now: float, win_s: float,
              budget: float) -> tuple[float, float]:
        """(burn rate, total events) over [now - win_s, now]."""
        bad = total = 0.0
        for t, b, n in reversed(self._series[name]):
            if t < now - win_s:
                break
            bad += b
            total += n
        if total <= 0:
            return 0.0, 0.0
        return (bad / total) / budget, total

    def evaluate(self, now: float) -> list[dict[str, Any]]:
        fired: list[dict[str, Any]] = []
        for spec in self.specs:
            last = self._last_alert.get(spec.name)
            if last is not None and now - last < self.cooldown_s:
                continue
            for long_s, short_s, factor in self.windows:
                burn_l, n_l = self._burn(spec.name, now, long_s,
                                         spec.budget)
                if n_l < self.min_events or burn_l < factor:
                    continue
                burn_s, n_s = self._burn(spec.name, now, short_s,
                                         spec.budget)
                if n_s <= 0 or burn_s < factor:
                    continue
                fired.append(self._fire(
                    spec, now, long_s, short_s, factor,
                    burn_l, burn_s, n_l,
                ))
                break  # one alert per spec per evaluation
        return fired

    def _fire(self, spec: SLOSpec, now: float, long_s: float,
              short_s: float, factor: float, burn_l: float,
              burn_s: float, events: float) -> dict[str, Any]:
        self._last_alert[spec.name] = now
        self.stats["slo_alerts"] += 1
        action = "none"
        rolled_to = None
        if spec.name in self.rollback_on and self.rollback is not None:
            rolled_to = self.rollback.rollback_params(
                reason=(
                    f"slo {spec.name} burn {burn_l:.2f}x/"
                    f"{burn_s:.2f}x over {long_s:g}s/{short_s:g}s "
                    f"windows (factor {factor:g})"
                )
            )
            action = "rollback"
            self.stats["slo_rollbacks"] += 1
        alert = {
            "slo": spec.name, **spec.describe(),
            "burn_long": round(burn_l, 4),
            "burn_short": round(burn_s, 4),
            "window_long_s": long_s, "window_short_s": short_s,
            "factor": factor, "events": events,
            "action": action,
        }
        if rolled_to is not None:
            alert["rolled_back_to_version"] = rolled_to
        if self._last_attribution:
            # "p99 breached" -> "and queue_wait owns it"
            alert["attribution"] = self._last_attribution
            alert["dominant_tail_segment"] = (
                self._last_attribution.get("dominant_tail_segment"))
        self.alerts.append(alert)
        if self.runlog is not None:
            self.runlog.alert(**alert)
        return alert


def slo_from_config(cfg: dict[str, Any] | None, **kw) -> SLOMonitor | None:
    """Build an SLOMonitor from the declarative `slo:` block of the
    `serve:`/`obs:` config. Unknown keys fail loudly (the config
    contract — a typoed `quarantine_rate_mx` must not silently
    disarm the alert). Returns None for an empty/absent block."""
    if not cfg:
        return None
    unknown = set(cfg) - SLO_CONFIG_KEYS
    if unknown:
        raise ValueError(
            f"unknown slo: config key(s) {sorted(unknown)}; known "
            f"keys: {sorted(SLO_CONFIG_KEYS)}")
    specs: list[SLOSpec] = []
    if cfg.get("p99_ms") is not None:
        specs.append(SLOSpec("p99_ms", "latency", cfg["p99_ms"],
                             budget=cfg.get("p99_budget")))
    if cfg.get("goodput_floor_rps") is not None:
        specs.append(SLOSpec("goodput_rps", "floor",
                             cfg["goodput_floor_rps"]))
    if cfg.get("quarantine_rate_max") is not None:
        specs.append(SLOSpec("quarantine_rate", "ratio",
                             cfg["quarantine_rate_max"]))
    if cfg.get("max_staleness") is not None:
        specs.append(SLOSpec("params_staleness", "ceiling",
                             cfg["max_staleness"]))
    if not specs:
        return None
    if cfg.get("windows") is not None:
        kw.setdefault("windows", tuple(
            tuple(w) for w in cfg["windows"]))
    if cfg.get("rollback_on") is not None:
        kw.setdefault("rollback_on", tuple(cfg["rollback_on"]))
    if cfg.get("cooldown_s") is not None:
        kw.setdefault("cooldown_s", float(cfg["cooldown_s"]))
    if cfg.get("min_events") is not None:
        kw.setdefault("min_events", int(cfg["min_events"]))
    return SLOMonitor(specs, **kw)


class OnlineLoopProbe:
    """The online-loop depth instrument, seated as the store's
    collector (`SessionStore.collector` protocol: `add(res)` +
    `on_close(sid, quarantined=)`) and forwarding to the real
    collector (a `TrajectoryBuffer`) untouched — observation, not
    interposition.

    Measures, host-side, O(1) per decision:
    - `staleness`: per-decision param lag (store's live version minus
      the version the decision was computed under);
    - `swap_latency_s`: ParamBus swap -> first decision served under
      the new version (wire `bus.on_event = probe.on_bus_event`);
    - `reward_by_version`: running reward sum/count per params
      version — the learner's per-version reward scalars.
    """

    def __init__(self, store=None, inner=None, *, metrics=None,
                 runlog=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.store = store
        self.inner = inner
        self.metrics = metrics
        self.runlog = runlog
        self._clock = clock
        self.staleness = StreamingHistogram(lo=0.5, hi=2 ** 20,
                                            growth=2.0)
        self.swap_latency_s = StreamingHistogram()
        self.reward_by_version: dict[int, list[float]] = {}
        self._pending_swap: tuple[int, float] | None = None
        self._max_version = 0
        self.stats = {
            "probe_decisions": 0, "probe_swaps": 0,
            "probe_first_decisions": 0, "probe_rollbacks": 0,
        }

    # -- collector protocol -------------------------------------------

    def add(self, res) -> None:
        self.stats["probe_decisions"] += 1
        ver = int(getattr(res, "params_version", 0) or 0)
        if self.store is not None:
            cur = int(self.store.stats.get("serve_param_version", ver))
        else:
            cur = max(self._max_version, ver)
        self._max_version = max(self._max_version, cur, ver)
        lag = max(0, cur - ver)
        self.staleness.add(float(lag))
        if self.metrics is not None:
            self.metrics.observe("online_staleness_lag", float(lag))
        reward = getattr(res, "reward", None)
        if reward is not None:
            slot = self.reward_by_version.setdefault(ver, [0.0, 0.0])
            slot[0] += float(reward)
            slot[1] += 1.0
        pend = self._pending_swap
        if pend is not None and ver >= pend[0]:
            dt = self._clock() - pend[1]
            self._pending_swap = None
            self.swap_latency_s.add(dt)
            self.stats["probe_first_decisions"] += 1
            if self.metrics is not None:
                self.metrics.observe("online_swap_to_first_decision_s",
                                     dt)
        if self.inner is not None:
            self.inner.add(res)

    def on_close(self, sid: int, quarantined: bool = False) -> None:
        if self.inner is not None:
            self.inner.on_close(sid, quarantined=quarantined)

    # -- ParamBus hook -------------------------------------------------

    def on_bus_event(self, event: dict[str, Any]) -> None:
        kind = event.get("event")
        if kind == "swap":
            self.note_swap(int(event["version"]))
        elif kind == "rollback":
            self._pending_swap = None
            self.stats["probe_rollbacks"] += 1

    def note_swap(self, version: int) -> None:
        self._pending_swap = (int(version), self._clock())
        self.stats["probe_swaps"] += 1

    # -- read ----------------------------------------------------------

    def summary(self) -> dict[str, Any]:
        rewards = {
            str(v): {"mean": s / n if n else 0.0, "count": int(n)}
            for v, (s, n) in sorted(self.reward_by_version.items())
        }
        return {
            **self.stats,
            "staleness": self.staleness.summary(),
            "swap_to_first_decision": self.swap_latency_s.summary("_s"),
            "reward_by_version": rewards,
        }
