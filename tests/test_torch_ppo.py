"""The port's PPO update against the JAX package's, on a rollout the JAX
package collected.

- One `PPO._update` from the same carried weights, optimizer state, key
  and rollout: the stats (policy loss, entropy, approx KL) within rtol
  1e-4 / atol 1e-6, and the updated parameters two ways
  (`assert_update_close`). At the flagship's Adam every parameter within
  rtol 1e-4 / atol 1e-6 but the two policy heads, held to Adam's step
  bound: Adam divides each gradient by its running RMS, so where a
  gradient sits near rounding level its step follows float32 noise (the
  heads' output biases have an exact gradient of 0; their hidden units
  sum terms that nearly cancel over nodes and executor rows), in any
  two float32 implementations, the JAX update's jit and eager runs
  among them. At Adam eps 1e-2
  and lr 3e-2, where a step is linear in the gradient, every parameter's
  change within rtol 1e-4 / atol 1e-7 per applied step (6e-7 here): the
  strict check of the loss,
  the minibatches and the optimizer.
- With `target_kl` tiny both updates stop at the same minibatch (the
  same parameters afterwards, and the port applied fewer minibatches
  than the epochs hold).
- The skip gate against its spec (its JAX test fails in the reference,
  ROADMAP queue C): a NaN reward skips every minibatch and leaves the
  parameters and Adam's state as they were; a clean rollout moves them.

Sizes: `mini_train_cfg` (5 executors, 6 job slots, 4 lanes, T = 48, 2
epochs x 3 minibatches), weights x0.3."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.trainers import make_optimizer as jax_make_optimizer
from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.env.health import (
    H_NONFINITE_GRAD,
    H_NONFINITE_LOSS,
)
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import (
    LINEAR_ADAM,
    assert_update_close,
    mini_train_cfg,
    port_rollout_from_jax,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_side():
    """A JAX trainer with its weights x0.3, and a rollout it collected."""
    jt = jax_make_trainer(mini_train_cfg())
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    st = jt.init_state()
    rng = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    ro, _, _ = jt._collect_jit(st.params, st.iteration, rng, None)
    return jt, st.replace(rng=rng), ro


def _port(**trainer):
    jt, jst, jro = _jax_side()
    tt = make_trainer(mini_train_cfg(**trainer), device="cpu")
    tt.scheduler.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.scheduler.params)))
    st = tt.init_state()
    st.rng = torch.from_numpy(np.asarray(jst.rng).astype(np.int64))
    return tt, st, port_rollout_from_jax(jro)


@pytest.mark.parametrize("target_kl,linear", [(0.01, False), (1e-6, False),
                                              (0.01, True)])
def test_update_matches_jax(target_kl, linear):
    jt, jst, jro = _jax_side()
    assert int(np.asarray(jro.valid).sum()) > 50
    over = {"target_kl": target_kl}
    if linear:
        over["opt_kwargs"] = LINEAR_ADAM
        jt.tx = jax_make_optimizer(mini_train_cfg(**over)["trainer"])
        jst = jst.replace(opt_state=jt.tx.init(jst.params))
    jt.target_kl = target_kl
    jst2, jstats = jax.jit(jt._update)(jst, jro)
    tt, tst, tro = _port(**over)
    p0 = {k: v.detach().clone() for k, v in tst.params.items()}
    tst2, tstats = tt._update(tst, tro)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jst2.params))
    lr = (LINEAR_ADAM if linear else {"lr": 3e-4})["lr"]
    assert_update_close(want, tst2.params, p0,
                        int(tstats["minibatches_applied"]), lr, linear)
    for k in ("policy_loss", "entropy", "approx_kl_div"):
        np.testing.assert_allclose(tstats[k], float(jstats[k]), err_msg=k,
                                   **TOL)
    assert int(jstats["health_mask"]) == tstats["health_mask"] == 0
    moved = max(float((tst2.params[k].detach() - p0[k]).abs().max())
                for k in p0)
    assert moved > 1e-5
    if target_kl == 1e-6:  # stopped early, at the same minibatch as JAX
        assert tstats["kl_stopped"] == 1.0
        assert 0 < tstats["minibatches_applied"] < 6
    else:
        assert tstats["minibatches_applied"] == 6


def test_skip_gate_spec():
    """A NaN reward: every minibatch skipped, params and Adam untouched,
    the loss and gradient bits raised. A clean rollout moves them."""
    tt, st, ro = _port()
    p0 = {k: v.detach().clone() for k, v in st.params.items()}
    ro.reward = ro.reward.clone()
    ro.reward[1, 3] = float("nan")
    st, stats = tt._update(st, ro)
    assert stats["minibatches_applied"] == 0
    assert stats["health_mask"] & H_NONFINITE_LOSS
    assert stats["health_mask"] & H_NONFINITE_GRAD
    for k, v in st.params.items():
        assert torch.equal(v, p0[k]), k
    assert st.opt_state.count == 0 and not st.opt_state.opt.state
    ro.reward[1, 3] = 0.0
    st.rng = prng.PRNGKey(5)
    st, stats = tt._update(st, ro)
    assert stats["health_mask"] == 0 and stats["minibatches_applied"] > 0
    assert st.opt_state.count == stats["minibatches_applied"]
    assert any(not torch.equal(v, p0[k]) for k, v in st.params.items())


def test_health_bits_after_kl_stop_match_jax():
    """With `target_kl` tiny the update stops at an early minibatch; a
    NaN old log-prob in a later minibatch of the first epoch applies
    nothing but still raises the loss and gradient bits in the JAX
    scan's health mask, and so in the port's."""
    jt, jst, jro = _jax_side()
    jt.target_kl = 1e-6
    tt, tst, tro = _port(target_kl=1e-6)
    _, clean = tt._update(tst, tro)
    stop = int(clean["minibatches_applied"])  # the minibatch that stopped
    assert clean["kl_stopped"] == 1.0 and stop + 1 < tt.num_batches
    B, T = tro.reward.shape
    mb_idx, _ = tt.minibatch_indices(tst.rng, B, T)
    ts = [int(t) for t in mb_idx[stop + 1, 0] if t < T and tro.valid[0, t]]
    assert ts
    lg = np.asarray(jro.lgprob).copy()
    lg[0, ts[0]] = np.nan
    jro = jro.replace(lgprob=jax.numpy.asarray(lg))
    _, jstats = jax.jit(jt._update)(jst, jro)
    tt, tst, tro = _port(target_kl=1e-6)
    tro.lgprob = tro.lgprob.clone()
    tro.lgprob[0, ts[0]] = float("nan")
    _, stats = tt._update(tst, tro)
    assert stats["minibatches_applied"] == stop
    assert stats["health_mask"] & H_NONFINITE_LOSS
    assert stats["health_mask"] == int(jstats["health_mask"])
