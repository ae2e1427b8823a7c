"""The port trainer with `fast_prng: True` against the JAX trainer with
`fast_prng: True`: both build every key of the run as an rbg key
(`mini_train_cfg`, weights x0.3); after each of two iterations the
parameters agree as `test_torch_trainer.py` holds them (rtol 1e-4 /
atol 1e-6, the policy heads to Adam's step bound), the decisions are
equal and the port's iteration key is the JAX rbg key.

`fast_prng` in the JAX trainer flips jax's process-wide default impl;
this module restores the impl it found, even on a failure, so that later
files on the same worker run under their default.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import assert_update_close, mini_train_cfg
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def restore_default_impl():
    saved = jax.config.jax_default_prng_impl
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", saved)


def _k(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_trainer_matches_jax_trainer_under_fast_prng(tmp_path):
    cfg = mini_train_cfg(fast_prng=True)
    jt = jax_make_trainer(cfg)
    assert jax.config.jax_default_prng_impl == "rbg"
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    carried = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.scheduler.params))
    jst = jt.init_state()
    jax_iters = []
    for i in range(2):  # Trainer.train's loop, health clean
        st = jst.replace(rng=jax.random.fold_in(jax.random.PRNGKey(42), i))
        ro, _, tm = jt._collect_jit(st.params, st.iteration, st.rng, None)
        st, stats = jt._update_jit(st, ro)
        assert int(np.bitwise_or.reduce(np.asarray(tm.health_mask))) == 0
        jst = st.replace(iteration=st.iteration + 1)
        jax_iters.append((jst.params, np.asarray(ro.valid).sum(-1)))

    cfg["trainer"]["artifacts_dir"] = str(tmp_path)
    tt = make_trainer(cfg, device="cpu")
    assert tt.prng_impl == "rbg"
    tt.scheduler.load_params(carried)
    p0 = {k: torch.as_tensor(v) for k, v in carried.items()}
    port_iters = []
    final = tt.train(callback=lambda i, state, stats: port_iters.append(
        ({k: v.detach().clone() for k, v in state.params.items()}, stats)))
    assert final.rng.shape == (4,)
    assert torch.equal(final.rng, _k(jax.random.fold_in(
        jax.random.PRNGKey(42), 1)))
    steps = 0
    for (jp, jvalid), (tp, stats) in zip(jax_iters, port_iters):
        assert stats["health_mask"] == 0
        assert stats["decisions"] == jvalid.sum()
        steps += int(stats["minibatches_applied"])
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
        assert_update_close(want, tp, p0, steps,
                            cfg["trainer"]["opt_kwargs"]["lr"], linear=False)
