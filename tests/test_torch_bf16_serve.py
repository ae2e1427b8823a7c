"""Serving under `compute_dtype: bfloat16`: the port's `SessionStore` over a
bf16 `DecimaScheduler` against the JAX package's store over its bf16
scheduler, from the same carried weights (x0.3), seeds and operations:
every served decision's integers equal and its floats within rtol 1e-5
(the bf16 scores are bit-equal on these inputs, `test_torch_bf16.py`; the
log-probs are float32 sums over them), the log-prob float32. Sizes: the
serving tests' (5 executors, 6 job slots, embed 8, job_bucket 4)."""

from __future__ import annotations

import jax
import numpy as np

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.serve import SessionStore as JaxStore
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax
from sparksched_tpu_torch.serve import SessionStore
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import SERVE_AGENT, assert_same_result
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_bf16_store_matches_jax_store():
    kw = dict(SERVE_AGENT, num_executors=5, compute_dtype="bfloat16")
    jp = JaxParams(num_executors=5, max_jobs=6, max_stages=20, max_levels=20,
                   mean_time_limit=None)
    jb = jax_bank(jp.num_executors, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    js = JaxDecima(**kw)
    js.params = jax.tree_util.tree_map(lambda a: a * 0.3, js.params)
    ts = DecimaScheduler(**kw, device="cpu")
    ts.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=jp.max_stages,
                   max_levels=jp.max_levels)
    tb = make_workload_bank(5, tp.max_stages, device="cpu")
    jstore = JaxStore(jp, jb, js, capacity=4, max_batch=4, seed=0)
    tstore = SessionStore(tp, tb, ts, capacity=4, max_batch=4, seed=0,
                          device="cpu")
    sids = []
    for s in (11, 12, 13, None):
        sid = jstore.create(seed=s)
        assert tstore.create(seed=s) == sid
        sids.append(sid)
    decided = 0
    for _ in range(6):
        for a, b in zip(jstore.decide_batch(sids), tstore.decide_batch(sids)):
            assert_same_result(a, b)
            assert isinstance(b.lgprob, float)
            decided += int(b.decided)
    for sid in sids:
        assert_same_result(jstore.decide(sid), tstore.decide(sid))
    assert decided > 10
