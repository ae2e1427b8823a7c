"""Observability of the port (counterpart of `sparksched_tpu/obs/`): the
JSONL run log and the engine telemetry counters."""

from .runlog import RunLog, emit  # noqa: F401
from .telemetry import (  # noqa: F401
    FIELDS,
    Telemetry,
    add,
    orr,
    subtract,
    summarize,
    telemetry_zeros,
)
