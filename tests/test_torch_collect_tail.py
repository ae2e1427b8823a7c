"""The port's collector where every lane's episode ends before T: at T =
128 (job_bucket 3) the loop leaves after the last lane's final row, and
the `Rollout` — every leaf, the final state included — and the health
mask still equal the JAX collector's, which scans all 128 rows
(`test_torch_rollout.py` has the cases and tolerances)."""

from __future__ import annotations

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_rollout import (
    test_collect_flat_sync_batch_matches_jax as _check_collection,
)


def test_collect_leaves_early_with_the_same_rollout():
    _check_collection(3, 128)
