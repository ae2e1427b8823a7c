"""Synthetic TPC-H-like workload generator (a copy of the JAX package's
pure-numpy `workload/synthetic.py`).

The reference auto-downloads empirical TPC-H traces (tpch.py:109-115); this
environment has no network egress, so we generate a statistically similar
bank deterministically: 22 "queries" x 7 input sizes, layered DAGs of 2..20
stages, skewed task counts, lognormal task durations with wave structure
(fresh > first > rest, reflecting JVM warmup in the real traces) and a mild
slowdown at higher executor-count levels (stragglers/contention).

`make_templates` is pure in its seed; the same bank is reproduced across
processes and hosts. If real traces exist at `data/tpch`, prefer
`bank.load_tpch_templates`.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .bank import EXEC_LEVEL_VALUES, NUM_QUERIES, QUERY_SIZES

# work multiplier per query size (durations scale with input size)
SIZE_SCALE = {"2g": 1.0, "5g": 1.6, "10g": 2.4, "20g": 3.6, "50g": 6.0,
              "80g": 8.0, "100g": 9.5}


def _query_structure(q: int, rng: np.random.Generator):
    """DAG structure is a function of the query number only (like TPC-H,
    where query plans are fixed and sizes scale the data)."""
    num_stages = int(rng.integers(2, 21))
    num_layers = int(rng.integers(2, max(3, min(6, num_stages)) + 1))
    layer_of = np.sort(rng.integers(0, num_layers, size=num_stages))
    layer_of[0] = 0
    adj = np.zeros((num_stages, num_stages), dtype=bool)
    for c in range(num_stages):
        earlier = np.flatnonzero(layer_of[:c] < layer_of[c])
        if earlier.size == 0:
            continue
        # every non-root stage depends on 1-3 earlier-layer stages
        k = int(rng.integers(1, min(3, earlier.size) + 1))
        parents = rng.choice(earlier, size=k, replace=False)
        adj[parents, c] = True
    # skewed task counts: many small stages, a few wide ones
    num_tasks = np.maximum(
        1, np.round(rng.lognormal(mean=2.2, sigma=1.1, size=num_stages))
    ).astype(np.int64)
    num_tasks = np.minimum(num_tasks, 200)
    base_dur = rng.lognormal(mean=9.2, sigma=0.8, size=num_stages)  # ~10s
    return num_stages, adj, num_tasks, base_dur


def make_templates(seed: int = 2024, bucket_size: int = 16,
                   num_samples_per_bucket: int | None = None
                   ) -> list[dict[str, Any]]:
    num_samples = num_samples_per_bucket or bucket_size
    templates = []
    for q in range(1, NUM_QUERIES + 1):
        struct_rng = np.random.default_rng([seed, q])
        num_stages, adj, num_tasks, base_dur = _query_structure(q, struct_rng)
        for si, size in enumerate(QUERY_SIZES):
            # NOT hash(size): Python string hashing is salted per process
            # (PYTHONHASHSEED), which silently made every process build a
            # different bank — the index is the deterministic key
            rng = np.random.default_rng([seed, q, si])
            scale = SIZE_SCALE[size]
            durations = {}
            for s in range(num_stages):
                stage = {"fresh_durations": {}, "first_wave": {},
                         "rest_wave": {}}
                base = base_dur[s] * scale
                for lv in EXEC_LEVEL_VALUES:
                    # more executors -> mild per-task slowdown
                    lv_factor = 1.0 + 0.08 * np.log2(lv / EXEC_LEVEL_VALUES[0])
                    rest_mean = base * lv_factor
                    stage["rest_wave"][lv] = _ln_samples(
                        rng, rest_mean, 0.25, num_samples)
                    stage["first_wave"][lv] = _ln_samples(
                        rng, rest_mean * 1.5, 0.3, num_samples)
                    stage["fresh_durations"][lv] = _ln_samples(
                        rng, rest_mean * 2.0 + 1000.0, 0.3, num_samples)
                durations[s] = stage
            templates.append(
                {"adj": adj, "num_tasks": num_tasks, "durations": durations,
                 "query_num": q, "query_size": size}
            )
    return templates


def _ln_samples(rng: np.random.Generator, mean: float, sigma: float,
                n: int) -> list[float]:
    mu = np.log(mean) - sigma**2 / 2
    return [float(x) for x in rng.lognormal(mu, sigma, size=n)]
