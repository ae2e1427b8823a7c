"""Schedulers of the port (counterpart of `sparksched_tpu/schedulers/`):
the interfaces, a string-keyed factory, the two heuristics and Decima."""

from .base import Scheduler, TrainableScheduler  # noqa: F401
from .decima import (  # noqa: F401
    DecimaScheduler,
    load_state_dict_file,
    params_from_flax,
)
from .heuristics import (  # noqa: F401
    RandomScheduler,
    RoundRobinScheduler,
    find_stage_per_job,
    random_policy,
    round_robin_policy,
)

_REGISTRY = {
    "RoundRobinScheduler": RoundRobinScheduler,
    "RandomScheduler": RandomScheduler,
    "DecimaScheduler": DecimaScheduler,
}


def make_scheduler(agent_cfg: dict) -> Scheduler:
    """String-keyed factory: `agent_cfg["agent_cls"]` names the class,
    the other keys are its arguments."""
    cls_name = agent_cfg["agent_cls"]
    if cls_name not in _REGISTRY:
        raise ValueError(f"'{cls_name}' is not a valid scheduler.")
    kwargs = {k: v for k, v in agent_cfg.items() if k != "agent_cls"}
    return _REGISTRY[cls_name](**kwargs)
