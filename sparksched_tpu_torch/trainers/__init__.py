"""RL training layer of the port (counterpart of
`sparksched_tpu/trainers/`): single-eval rollout collection, returns,
critic-free baselines, PPO and VPG, and the profiler."""

from .baselines import group_baselines  # noqa: F401
from .ppo import PPO  # noqa: F401
from .profiler import Profiler  # noqa: F401
from .returns import (  # noqa: F401
    AvgNumJobsBuffer,
    differential_returns,
    discounted_returns,
    step_dts,
)
from .rollout import (  # noqa: F401
    Rollout,
    StoredObs,
    collect_flat_sync_batch,
    store_obs,
    stored_to_observation,
)
from .trainer import (  # noqa: F401
    TrainState,
    Trainer,
    make_optimizer,
    make_trainer,
)
from .vpg import VPG  # noqa: F401
