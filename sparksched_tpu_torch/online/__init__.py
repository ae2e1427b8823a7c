"""The online learning loop (counterpart of `sparksched_tpu/online/`):
serve -> learn -> serve over the port's stacks.

- ACTORS are the serving sessions: a record-on `SessionStore`
  (`serve: {record: true}`, with or without the device ring `ring: R`)
  hands each served decision's (obs, action, log-prob, reward, dt)
  record, in the training collector's `StoredObs` schema and stamped
  with the parameter version live at dispatch, to the bounded
  `TrajectoryBuffer` (per-session episode assembly, FIFO eviction,
  counted drops);
- the LEARNER (`OnlineLearner`) drains completed trajectories into
  fixed-shape padded rollouts and runs the trainer's `PPO._update`
  with the health gates on (a rejected update restores the learner's
  weights and Adam state), with a hard params-version staleness bound
  as the off-policy guard;
- the SWAP side (`ParamBus`) applies accepted versions to the live
  store between serve calls (`SessionStore.set_params`, in place),
  under a probation window that rolls back a version whose quarantine
  rate spikes.

`online_from_config` builds the three from the top-level `online:`
block (`config.ONLINE_KEYS`) over a record-on store.
"""

from __future__ import annotations

from typing import Any

from ..config import ONLINE_KEYS
from .bus import ParamBus
from .learner import OnlineLearner, make_learner_trainer
from .trajectory import Trajectory, TrajectoryBuffer

__all__ = [
    "ParamBus",
    "OnlineLearner",
    "make_learner_trainer",
    "Trajectory",
    "TrajectoryBuffer",
    "online_from_config",
]


def online_from_config(
    cfg: dict[str, Any] | None,
    store,
    agent_cfg: dict[str, Any],
    *,
    runlog=None,
    metrics=None,
) -> tuple[TrajectoryBuffer, OnlineLearner, ParamBus] | None:
    """Build (buffer, learner, bus) from an `online:` block and wire the
    buffer to `store` as its collector. The store must be record-on.
    Returns None when the block says `enabled: false` (nothing is wired:
    the store serves as without the block). Unknown keys fail loudly.
    `agent_cfg` must describe the architecture the store's scheduler
    runs: the learner starts from the store's live weights, on the
    store's device, and publishes back into them."""
    cfg = dict(cfg or {})
    unknown = set(cfg) - set(ONLINE_KEYS)
    if unknown:
        raise ValueError(
            f"unknown online: config key(s) {sorted(unknown)}; known "
            f"keys: {sorted(ONLINE_KEYS)}"
        )
    if not cfg.get("enabled", True):
        return None
    if not getattr(store, "record", False):
        raise ValueError(
            "online_from_config needs a record-on store "
            "(serve: {record: true} / SessionStore(record=True)) — "
            "a record-off store serves no trajectory records to "
            "learn from"
        )
    max_steps = int(cfg.get("max_steps", 32))
    batch = int(cfg.get("batch_trajectories", 4))
    buffer = TrajectoryBuffer(
        capacity=int(cfg.get("max_trajectories", 64)),
        max_steps=max_steps,
        min_decisions=int(cfg.get("min_decisions", 2)),
        metrics=metrics,
    )
    store.collector = buffer
    bus = ParamBus(
        store,
        probation_decisions=int(cfg.get("probation_decisions", 32)),
        max_quarantine_rate=float(cfg.get("max_quarantine_rate", 0.5)),
        runlog=runlog,
        metrics=metrics,
    )
    trainer = make_learner_trainer(
        agent_cfg, store.params, batch, max_steps,
        learner_cfg=dict(cfg.get("learner") or {}),
        seed=int(cfg.get("seed", 0)),
        device=store.device,
    )
    learner = OnlineLearner(
        trainer, buffer, bus,
        max_param_lag=int(cfg.get("max_param_lag", 4)),
        swap_every=int(cfg.get("swap_every", 1)),
        init_params=store.model_params,
        version0=store.params_version,
        runlog=runlog,
        metrics=metrics,
    )
    return buffer, learner, bus
