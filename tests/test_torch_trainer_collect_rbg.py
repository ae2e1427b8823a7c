"""The port trainer's asynchronous single-eval collection under
`fast_prng: True` (every key an rbg key: the setting the flagship
config trains with once `rollout_duration` is set) against the JAX
trainer's.

(`tests/_trainer_collect.py`: `mini_train_cfg`, 5 executors, 6 job
slots, 2 sequence groups x 2 lanes, Decima, health and so telemetry on;
T = 24, event burst 2, mean time limit 3e5 so that asynchronous lanes
restart inside each iteration; `rollout_duration` 2e6.) Two iterations
of `Trainer._collect` against `_collect_jit` of the JAX trainer from
the same weights and iteration keys, an asynchronous second iteration
from the carry the first returned on each side: every rollout leaf, the
counters, the health mask and the carry (LoopState or EnvState, and the
reset ordinals). This holds the trainer's own wiring against the JAX
dispatch: the lanes' reset keys from the iteration, the first
mid-collection reset at the iteration's ordinal + 1, the sequence bases
`fold_in(master, g)`, the lane salts `1000 + r`, the per-lane policy
keys `fold_in(fold_in(rng, b), 7)`, the single-eval key `fold_in(rng,
7)`, and the knob dicts.
"""

from __future__ import annotations

import pytest

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from ._trainer_collect import (
    DURATION,
    assert_collections_match,
    trainer_collections,
)

SETTINGS = [
    ("flat", True, DURATION, "rbg"),
]


@pytest.mark.parametrize("engine,single,duration,impl", SETTINGS)
def test_trainer_collect_matches_jax(engine, single, duration, impl,
                                     tmp_path):
    got = trainer_collections(engine, single, duration, impl,
                              str(tmp_path))
    assert_collections_match(engine, duration, got)
