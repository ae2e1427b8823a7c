"""Scheduler interfaces (counterpart of `sparksched_tpu/schedulers/base.py`).

- `schedule(obs) -> (action, info)`: host-side, one decision at a time.
- `policy(...) -> (stage_idx, num_exec, info)`: tensors over a batch of
  padded `Observation`s (leading lane axis). `stage_idx` is a flat padded
  node index (job * max_stages + stage, or -1 for "no selection"). The
  heuristics take `(rng, obs)` with one key per lane, as the JAX
  package's policies do (`run_flat`'s `policy_fn`); Decima's
  `policy(rng, obs)` takes one key for the batch (None when greedy).
"""

from __future__ import annotations

import abc
from typing import Any


class Scheduler(abc.ABC):
    """Interface for all schedulers."""

    name: str

    @abc.abstractmethod
    def schedule(self, obs: Any) -> tuple[dict[str, Any], dict[str, Any]]:
        """One decision from a single-lane Observation."""

    @abc.abstractmethod
    def policy(self, *args: Any):
        """Decisions for a batch of observations."""


class TrainableScheduler(Scheduler):
    """Interface for trainable schedulers: the parameters live in an
    `nn.Module` (`params` is its state dict)."""

    params: Any
