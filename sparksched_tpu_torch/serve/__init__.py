"""Decision serving of the port."""

from .aot import SERVE_KNOBS, ServeOut, serve_decide_batch_fn, serve_decide_fn  # noqa: F401
from .session import (  # noqa: F401
    ServeResult,
    SessionError,
    SessionQuarantined,
    SessionStore,
)
