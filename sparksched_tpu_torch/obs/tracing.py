"""Named trace ranges and per-request span traces (counterpart of
`sparksched_tpu/obs/tracing.py`).

`annotate(name)` opens an NVTX range (`torch.cuda.nvtx`) when a CUDA
card is present, so a profile of the serving front carries the phase
labels (`serve/flush`, `serve/dispatch`), and, while a torch.profiler
capture runs (a `trainers.profiler.Profiler` trace among them), a
`torch.profiler.record_function` range beside it, so the trace holds
the labels (`decima/gnn`, `train/ppo_update`,
`train/vpg_update`); without a card and outside a capture
it does nothing. The JAX package's version also names the traced HLO
(`jax.named_scope`); the eager port traces nothing.

`RequestTrace` is the serving path's span walk, copied: a trace id
minted at request creation and one perf_counter stamp per phase as the
request moves submit -> batch_admit -> dispatch -> harvest ->
device_compute -> scatter_back -> reply. `harvest` is the instant the
host starts materializing the call's outputs: right after dispatch on
the synchronous front, one in-flight residency later on the pipelined
front. The network client brackets the walk with `wire_submit` and
`wire_reply`; only offsets cross the wire, never one clock across two
processes.
"""

from __future__ import annotations

import itertools
import os
import time

import torch


class annotate:
    """Context manager: `with annotate("serve/flush"): ...`"""

    def __init__(self, name: str) -> None:
        self.name = name
        self._pushed = False
        self._range = None

    def __enter__(self) -> "annotate":
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._pushed = True
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        rng, self._range = self._range, None
        try:
            if rng is not None:
                rng.__exit__(exc_type, exc_val, exc_tb)
        finally:
            if self._pushed:
                self._pushed = False
                torch.cuda.nvtx.range_pop()
        return False


SPAN_ORDER = (
    "wire_submit", "submit", "batch_admit", "dispatch", "harvest",
    "device_compute", "scatter_back", "reply", "wire_reply",
)

_TRACE_SEQ = itertools.count()


class RequestTrace:
    """One request's spans: `stamp(name)` records a perf_counter time;
    `offsets_ms()` converts to ms offsets from submit (the run-log
    `trace` record payload). Trace ids are process-unique and ordered
    (`t<pid>-<seq>`), deterministic given submission order."""

    __slots__ = ("trace_id", "spans")

    def __init__(self, trace_id: str | None = None) -> None:
        self.trace_id = (
            trace_id
            if trace_id is not None
            else f"t{os.getpid():x}-{next(_TRACE_SEQ):08d}"
        )
        self.spans: dict[str, float] = {}

    def stamp(self, name: str, t: float | None = None) -> None:
        self.spans[name] = time.perf_counter() if t is None else t

    def offsets_ms(self) -> dict[str, float]:
        base = self.spans.get("submit")
        if base is None:
            # a wire-side trace that never reached a server (429 /
            # transport error) still has its client bracket
            base = self.spans.get("wire_submit")
        if base is None:
            return {}
        return {
            name: (self.spans[name] - base) * 1e3
            for name in SPAN_ORDER
            if name in self.spans
        }
