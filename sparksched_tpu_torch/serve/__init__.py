"""Decision serving of the port (counterpart of `sparksched_tpu/serve/`):
the serve programs (`serve/aot.py`), the session store and its batching
fronts (`serve/session.py`), open-loop load generation
(`serve/loadgen.py`), and, loaded lazily so the in-process path never
imports them, the HTTP front (`serve/server.py`) and the replica router
(`serve/router.py`)."""

from .aot import (  # noqa: F401
    SERVE_KNOBS,
    ServeOut,
    serve_decide_batch_fn,
    serve_decide_fn,
)
from .loadgen import generate_arrivals, run_open_loop
from .session import (
    ContinuousBatcher,
    InFlightCall,
    MicroBatcher,
    RemoteResult,
    ServeResult,
    SessionError,
    SessionQuarantined,
    SessionStore,
    Ticket,
    front_from_config,
    store_from_config,
)

__all__ = [
    "ServeOut",
    "serve_decide_batch_fn",
    "serve_decide_fn",
    "generate_arrivals",
    "run_open_loop",
    "ContinuousBatcher",
    "InFlightCall",
    "MicroBatcher",
    "RemoteResult",
    "ServeResult",
    "SessionError",
    "SessionQuarantined",
    "SessionStore",
    "Ticket",
    "front_from_config",
    "store_from_config",
    "ServeServer",
    "ServeClient",
    "server_from_config",
    "Router",
    "ReplicaSpec",
    "ReplicaDied",
]

_NET_EXPORTS = {
    "ServeServer": "server",
    "ServeClient": "server",
    "server_from_config": "server",
    "Router": "router",
    "ReplicaSpec": "router",
    "ReplicaDied": "router",
}


def __getattr__(name: str):
    mod = _NET_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
