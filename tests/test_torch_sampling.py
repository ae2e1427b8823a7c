"""Stochastic Decima sampling and `evaluate_actions` against the JAX
package, on the progressed observations of `test_torch_decima.py`, with
the carried weights scaled by 0.3: Gumbel-max sampling on the JAX key
layout gives the JAX actions with log-probs within rtol 1e-5 (compacted
and full width), and `evaluate_actions` the JAX log-probs and
normalised entropies within rtol 1e-5."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.schedulers.decima import DecimaAction as JaxAction
from sparksched_tpu_torch.schedulers.decima import DecimaAction

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_decima import _pair, obs_pair  # noqa: F401


def _k(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("job_bucket", [0, 4])
def test_stochastic_actions_match_jax(obs_pair, job_bucket):
    """`batch_policy(rng, obs)` splits one key per lane and each lane's
    key into the stage and the exec key, as the JAX package does."""
    to, jo = obs_pair
    js, ts = _pair(scale=0.3, job_bucket=job_bucket)
    seen = set()
    for seed in range(6):
        jk = jax.random.PRNGKey(seed)
        ja = js.batch_policy(jk, jo)
        ta = ts.batch_policy(_k(jk), to)
        for a, b in zip(ja[:2], ta[:2]):
            assert np.array_equal(np.asarray(a), b.numpy())
        for key in ("job_idx", "num_exec_k"):
            assert np.array_equal(np.asarray(ja[2][key]), ta[2][key].numpy())
        np.testing.assert_allclose(ta[2]["lgprob"].numpy(),
                                   np.asarray(ja[2]["lgprob"]), rtol=1e-5,
                                   atol=1e-6)
        seen.update(ta[0].tolist())
    greedy = set(ts.batch_policy(None, to, deterministic=True)[0].tolist())
    assert seen - greedy  # the draws are not the greedy choice


def test_evaluate_actions_match_jax(obs_pair):
    to, jo = obs_pair
    js, ts = _pair(scale=0.3)
    jf, tf = jax.vmap(js.features)(jo), ts.features(to)
    ja = js.batch_policy(jax.random.PRNGKey(9), jo)
    acts = JaxAction(stage_idx=ja[0], job_idx=ja[2]["job_idx"],
                     num_exec=ja[2]["num_exec_k"])
    acts = acts.replace(stage_idx=acts.stage_idx.at[0].set(-1))  # no stage
    jl, je = js.evaluate_actions(js.params, jf, acts)
    tl, te = ts.evaluate_actions(tf, DecimaAction(
        _k(acts.stage_idx).int(), _k(acts.job_idx).int(),
        _k(acts.num_exec).int()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)
    assert tl[0] == 0 and te[0] == 0 and bool((te[1:] > 0).all())
