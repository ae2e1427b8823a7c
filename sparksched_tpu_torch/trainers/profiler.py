"""Profiling utilities (counterpart of `sparksched_tpu/trainers/profiler.py`).

`Profiler` times a block and, given a trace directory, captures a
`torch.profiler` trace of it: CPU activity, and CUDA activity when the
device is the card. The block runs inside a `record_function` range named
by the label, and `obs.tracing.annotate` opens its ranges while a capture
runs, so the trace holds the trainer's phase labels
(`iter N collect`, `decima/gnn`, `train/ppo_update`, ...) beside the
kernels, and an untraced block does the same work as before. The trace is
exported as a Chrome/Perfetto JSON file, `<trace_dir>/<label>.json`
(spaces as underscores).
"""

from __future__ import annotations

import os
import time

import torch

from ..obs.runlog import emit


class Profiler:
    """Context manager timing a block (and optionally tracing it).

    >>> with Profiler() as p:
    ...     rollout = collect(...)
    >>> p.elapsed  # seconds

    `sink(label, elapsed)` receives the span always; `quiet` only
    silences the console echo. With `trace_dir` the capture is stopped
    in a `finally`: a raise inside the block (or in the report) leaves no
    profiler running. After a traced block, `trace_path`, `trace_bytes`
    and `export_seconds` describe the exported file."""

    def __init__(self, trace_dir: str | None = None, label: str = "block",
                 quiet: bool = False, sink=None,
                 device: str | torch.device | None = None) -> None:
        self.trace_dir = trace_dir
        self.label = label
        self.quiet = quiet
        self.sink = sink
        self.device = torch.device(device) if device is not None else None
        self.elapsed = 0.0
        self.trace_path: str | None = None
        self.trace_bytes = 0
        self.export_seconds = 0.0
        self._prof = None
        self._range = None

    def __enter__(self) -> "Profiler":
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            cuda = (self.device.type == "cuda" if self.device is not None
                    else torch.cuda.is_available())
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            self._prof = prof
            try:
                self._range = torch.profiler.record_function(self.label)
                self._range.__enter__()
            except BaseException:
                self._stop()
                raise
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        try:
            self.elapsed = time.perf_counter() - self._t0
            if self.sink is not None:
                self.sink(self.label, self.elapsed)
            if not self.quiet:
                emit(f"[profiler] {self.label}: {self.elapsed:.3f}s")
        finally:
            prof = self._stop()
            if prof is not None and exc_type is None:
                self._export(prof)

    def _stop(self):
        """End the capture (its label's range first); returns the stopped
        profiler, or None when there was no capture."""
        prof, rng = self._prof, self._range
        self._prof = self._range = None
        if prof is None:
            return None
        try:
            if rng is not None:
                rng.__exit__(None, None, None)
        finally:
            prof.stop()
        return prof

    def _export(self, prof) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            self.label.replace(" ", "_") + ".json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        self.export_seconds = time.perf_counter() - t0
        self.trace_path = path
        self.trace_bytes = os.path.getsize(path)
