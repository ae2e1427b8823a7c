"""Engine telemetry counters (counterpart of
`sparksched_tpu/obs/telemetry.py`).

The JAX package threads a pytree of i32 scalars per lane through its
engines. The port keeps the same counters as one `[B, F]` int32 tensor
(`Telemetry.t`, a column per field of `FIELDS`, in the JAX pytree's
order) and advances it with one fused update per call site (`add`: the
site's deltas stacked, masked once, added into their columns), so that
counting costs a few launches per site instead of one per counter.
Every engine function takes `telemetry=None`; without it nothing is
counted and nothing runs.

Counter semantics are the JAX package's: `decide_steps` /
`fulfill_steps` / `event_steps` count live micro-steps by entry mode,
`loop_iters` the events consumed per lane (pops plus bulk passes; the
`core.step` event-loop iterations there), `ev_*` single pops by kind,
`bulk_relaunch_events` / `bulk_ready_events` the events the bulk
passes consumed, `bulk_fulfill_hits` the candidates `_bulk_fulfill`
consumed, `commit_rounds` the finished commitment rounds,
`bulk_passes` the steps whose bulk pass consumed an event,
`drain_iters` the iterations of `drain_to_decision` (of the event loop
in `core.step`), and `health_mask` the OR of the health sentinels' bits
(set with `orr`, not added).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

FIELDS = (
    "decide_steps", "fulfill_steps", "event_steps", "loop_iters",
    "ev_job_arrival", "ev_task_finished", "ev_exec_ready",
    "bulk_relaunch_events", "bulk_ready_events", "bulk_fulfill_hits",
    "commit_rounds", "bulk_passes", "drain_iters", "health_mask",
)
_COL = {name: i for i, name in enumerate(FIELDS)}
_i32 = torch.int32


class Telemetry:
    """Per-lane counters: `t` is i32[B, len(FIELDS)]; each field reads as
    an attribute (`tm.decide_steps` is the column, i32[B])."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor) -> None:
        self.t = t

    def __getattr__(self, name: str) -> torch.Tensor:
        if name in _COL:
            return self.t[:, _COL[name]]
        raise AttributeError(name)

    def numpy(self) -> np.ndarray:
        return self.t.cpu().numpy()


def telemetry_zeros(lanes: int, device="cpu") -> Telemetry:
    """Zeroed counters for `lanes` lanes."""
    return Telemetry(torch.zeros((lanes, len(FIELDS)), dtype=_i32,
                                 device=device))


_COLS_CACHE: dict = {}


def _cols(names: tuple[str, ...], device) -> torch.Tensor:
    key = (names, str(device))
    cols = _COLS_CACHE.get(key)
    if cols is None:
        cols = torch.tensor([_COL[n] for n in names], dtype=torch.long,
                            device=device)
        _COLS_CACHE[key] = cols
    return cols


def add(tm: Telemetry | None, mask: torch.Tensor | None = None,
        **deltas: torch.Tensor) -> Telemetry | None:
    """The counters plus `deltas` (each [B], bool or int; bools count 1),
    zeroed on the lanes outside `mask` when given: one stack, one mask
    and one `index_add` whatever the number of fields. Passes None
    through."""
    if tm is None:
        return None
    names = tuple(deltas)
    d = torch.stack(list(deltas.values()), 1)
    if mask is not None:
        d = d * mask[:, None]
    if d.dtype != _i32:
        d = d.to(_i32)
    return Telemetry(tm.t.index_add(1, _cols(names, tm.t.device), d))


def orr(tm: Telemetry | None, **masks: torch.Tensor) -> Telemetry | None:
    """Bitwise-OR accumulation into the mask-valued fields
    (`health_mask`); passes None through."""
    if tm is None:
        return None
    t = tm.t.clone()
    for k, v in masks.items():
        t[:, _COL[k]] |= v.to(_i32)
    return Telemetry(t)


def _as_array(tm) -> np.ndarray:
    if isinstance(tm, Telemetry):
        return tm.numpy()
    if isinstance(tm, torch.Tensor):
        return tm.cpu().numpy()
    return np.asarray(tm)


def subtract(tm, prev) -> np.ndarray:
    """Counter delta since the snapshot `prev` (a `Telemetry` or its
    numpy array), as a numpy [B, F] array."""
    return _as_array(tm) - _as_array(prev)


def summarize(tm, prev=None) -> dict[str, Any]:
    """Host-side summary of the counters (a `Telemetry` or its numpy
    array), optionally windowed to the counts since `prev`: the JAX
    package's `summarize`, with the same keys and values — totals pooled
    over lanes, the micro-step composition, events by kind (single pops
    plus bulk), events and micro-steps per decision, the per-phase
    iteration split, the drain's and the event loop's max/mean over
    lanes (the straggler ratios) and the pooled health mask."""
    a = _as_array(tm) if prev is None else subtract(tm, prev)
    col = {name: a[:, i] for name, i in _COL.items()}

    def tot(name: str) -> int:
        return int(np.sum(col[name]))

    decide = tot("decide_steps")
    fulfill = tot("fulfill_steps")
    event = tot("event_steps")
    micro = decide + fulfill + event
    li = col["loop_iters"].ravel().astype(np.float64)
    lanes = int(li.size)
    mean_li = float(li.mean()) if lanes else 0.0
    straggler = float(li.max() / mean_li) if mean_li > 0 else 1.0
    events_by_kind = {
        "job_arrival": tot("ev_job_arrival"),
        "task_finished": tot("ev_task_finished")
        + tot("bulk_relaunch_events"),
        "executor_ready": tot("ev_exec_ready") + tot("bulk_ready_events"),
    }
    events_total = sum(events_by_kind.values())

    def frac(n: int) -> float:
        return round(n / micro, 4) if micro else 0.0

    def per_dec(n: int) -> float:
        return round(n / decide, 3) if decide else 0.0

    di = col["drain_iters"].ravel().astype(np.float64)
    mean_di = float(di.mean()) if lanes else 0.0
    drain_straggler = float(di.max() / mean_di) if mean_di > 0 else 1.0
    hm = col["health_mask"].ravel()
    health_mask = int(np.bitwise_or.reduce(hm)) if hm.size else 0
    from ..env.health import describe_mask

    return {
        "lanes": lanes,
        "decisions": decide,
        "commit_rounds": tot("commit_rounds"),
        "micro_steps": micro,
        "composition": {
            "decide": frac(decide),
            "fulfill": frac(fulfill),
            "event": frac(event),
        },
        "events_by_kind": events_by_kind,
        "events_total": events_total,
        "events_per_decision": per_dec(events_total),
        "micro_per_decision": per_dec(micro),
        "bulk": {
            "relaunch_events": tot("bulk_relaunch_events"),
            "ready_events": tot("bulk_ready_events"),
            "fulfill_hits": tot("bulk_fulfill_hits"),
        },
        "fulfillments": fulfill + tot("bulk_fulfill_hits"),
        "phase_iters": {
            "decide": decide,
            "fulfill": fulfill,
            "event": event,
            "bulk": tot("bulk_passes"),
        },
        "drain_iters_mean": round(mean_di, 2),
        "drain_iters_max": int(di.max()) if lanes else 0,
        "drain_straggler_ratio": round(drain_straggler, 3),
        "health_mask": health_mask,
        "health_bits": describe_mask(health_mask),
        "unhealthy_lanes": int((hm != 0).sum()) if hm.size else 0,
        "loop_iters_mean": round(mean_li, 2),
        "loop_iters_max": int(li.max()) if lanes else 0,
        "straggler_ratio": round(straggler, 3),
    }
