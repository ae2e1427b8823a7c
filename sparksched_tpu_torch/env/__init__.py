"""The simulator of the port (sequential engine)."""

from .core import reset  # noqa: F401
from .observe import Observation, observe  # noqa: F401
from .state import EnvState  # noqa: F401
