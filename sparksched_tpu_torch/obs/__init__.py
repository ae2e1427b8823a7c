"""Observability of the port (counterpart of `sparksched_tpu/obs/`): the
JSONL run log, the engine telemetry counters, the serving metrics, and
the fleet plane: the per-replica scrape collector and its scoreboard
(`FleetCollector`, `labeled_prometheus`, the `/fleet` endpoint and
`python -m sparksched_tpu_torch.obs.fleet`), declarative SLOs under
burn-rate alerting (`SLOMonitor`, `OnlineLoopProbe`) and the
role-attributed host profiler (`HostProfiler`)."""

from .metrics import (  # noqa: F401
    MetricsRegistry,
    StreamingHistogram,
    hist_summary,
    percentile_block,
)
from .runlog import RunLog, emit  # noqa: F401
from .slo import (  # noqa: F401
    OnlineLoopProbe,
    SLOMonitor,
    SLOSpec,
    slo_from_config,
)
from .telemetry import (  # noqa: F401
    FIELDS,
    Telemetry,
    add,
    orr,
    subtract,
    summarize,
    telemetry_zeros,
)

# PEP 562 lazy imports for the submodules that double as CLIs
# (`python -m sparksched_tpu_torch.obs.fleet`) or that only the serving
# path needs: an eager import would put the module in sys.modules before
# runpy re-imports it (a RuntimeWarning).
_LAZY = {
    "FleetCollector": ("fleet", "FleetCollector"),
    "labeled_prometheus": ("fleet", "labeled_prometheus"),
    "render_status": ("fleet", "render_status"),
    "CritPathAnalyzer": ("critpath", "CritPathAnalyzer"),
    "SegmentProfile": ("critpath", "SegmentProfile"),
    "decompose": ("critpath", "decompose"),
    "HostProfiler": ("hostprof", "HostProfiler"),
    "role_of_thread_name": ("hostprof", "role_of_thread_name"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(f".{mod_name}", __name__), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
