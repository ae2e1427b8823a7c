"""The port's VPG update against the JAX package's, on a rollout the JAX
package collected.

- One `VPG._update` from the same carried weights, optimizer state and
  rollout, with `beta_discount` (discounted returns), with the
  differential returns (`reward_buff_cap`) and under an entropy anneal
  at iteration 2 of 4: the stats (policy loss, entropy) within rtol 1e-4
  / atol 1e-6, and every parameter's change at Adam eps 1e-2 / lr 3e-2
  (a step linear in the gradient) within rtol 1e-4 / atol 1e-7 of the
  JAX update's, but the heads' output biases, whose exact gradient is 0
  (both updates step them along float32 noise), within 1e-4 of their
  head's largest change (`assert_linear_update_close`). The JAX update differentiates
  every [B, T] row; the port only the rows with weight > 0, so this also
  holds that dropping the others leaves the gradient as it was.
- The gradient accumulated over chunks of 7 observations equals the one
  of a single chunk (every parameter's change within 1e-7 + 1e-5 of it).
- `make_trainer` with `trainer_cls: VPG` trains an iteration.

Sizes: `mini_train_cfg` (5 executors, 6 job slots, 4 lanes, T = 48),
weights x0.3."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import VPG, make_trainer, vpg

from ._torch_parity import (
    LINEAR_ADAM,
    assert_linear_update_close,
    mini_train_cfg,
    port_rollout_from_jax,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-6)
CASES = {
    "discounted": {},
    "differential": {"reward_buff_cap": 200},
    "entropy_anneal": {"entropy_anneal": {"final": 0.004, "iterations": 4}},
}


def vpg_cfg(case: str = "discounted", **trainer) -> dict:
    cfg = mini_train_cfg(trainer_cls="VPG", opt_kwargs=LINEAR_ADAM,
                         **CASES[case], **trainer)
    if "reward_buff_cap" in cfg["trainer"]:
        del cfg["trainer"]["beta_discount"]
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_rollout():
    """The JAX VPG trainer's weights x0.3, and a rollout it collected."""
    jt = jax_make_trainer(vpg_cfg())
    params = jax.tree_util.tree_map(lambda a: a * 0.3, jt.scheduler.params)
    jt.scheduler.params = params
    st = jt.init_state()
    rng = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    ro, _, _ = jt._collect_jit(st.params, st.iteration, rng, None)
    return params, ro


def _sides(case: str, iteration: int = 0):
    params, jro = _jax_rollout()
    jt = jax_make_trainer(vpg_cfg(case))
    jt.scheduler.params = params
    jst = jt.init_state().replace(iteration=iteration)
    tt = make_trainer(vpg_cfg(case), device="cpu")
    assert isinstance(tt, VPG)
    tt.scheduler.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tst = tt.init_state()
    tst.iteration = iteration
    return jt, jst, jro, tt, tst, port_rollout_from_jax(jro)


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(case):
    it = 2 if case == "entropy_anneal" else 0
    jt, jst, jro, tt, tst, tro = _sides(case, it)
    assert int(np.asarray(jro.valid).sum()) > 50
    if case == "entropy_anneal":
        assert tt._entropy_coeff_at(tt.entropy_coeff, it) < tt.entropy_coeff
    jst2, jstats = jax.jit(jt._update)(jst, jro)
    p0 = {k: v.detach().clone() for k, v in tst.params.items()}
    tst2, tstats = tt._update(tst, tro)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jst2.params))
    assert_linear_update_close(want, tst2.params, p0)
    for k in ("policy_loss", "entropy"):
        np.testing.assert_allclose(tstats[k], float(jstats[k]), err_msg=k,
                                   **TOL)
    if case == "differential":
        np.testing.assert_allclose(tstats["avg_num_jobs_est"],
                                   float(jstats["avg_num_jobs_est"]), **TOL)
        assert np.array_equal(tst2.buf.ptr.numpy(),
                              np.asarray(jst2.buf.ptr))
    assert tstats["update_chunks"] == 1.0
    assert tst2.opt_state.count == 1


def test_chunked_gradient_equals_one_chunk(monkeypatch):
    changes = []
    for chunk in (7, 10_000):
        *_, tt, tst, tro = _sides("discounted")
        monkeypatch.setattr(vpg, "UPDATE_CHUNK", chunk)
        p0 = {k: v.detach().clone() for k, v in tst.params.items()}
        tst, stats = tt._update(tst, tro)
        n = int((tro.valid & (tro.stage_idx >= 0)).sum())
        assert stats["update_chunks"] == -(-n // chunk)
        changes.append({k: v.detach() - p0[k] for k, v in tst.params.items()})
    for k, a in changes[0].items():
        b = changes[1][k]
        assert float((a - b).abs().max()) <= 1e-7 + 1e-5 * float(
            b.abs().max()), k


def test_make_trainer_trains_vpg(tmp_path):
    cfg = vpg_cfg(num_iterations=1, artifacts_dir=str(tmp_path))
    tt = make_trainer(cfg, device="cpu")
    p0 = {k: v.detach().clone() for k, v in
          tt.scheduler.net.named_parameters()}
    tt.train()
    log = tt.stats_log[-1]
    assert np.isfinite(log["policy_loss"]) and np.isfinite(log["entropy"])
    assert log["health_mask"] == 0.0 and log["decisions"] > 0
    assert any(not torch.equal(v, p0[k]) for k, v in
               tt.scheduler.net.named_parameters())
