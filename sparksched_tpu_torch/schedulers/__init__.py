"""Schedulers of the port."""

from .base import Scheduler, TrainableScheduler  # noqa: F401
from .decima import DecimaScheduler, params_from_flax  # noqa: F401
