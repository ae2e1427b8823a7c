"""The port's returns, baselines, average-jobs window and `grad_health`
against the JAX package's: `step_dts`, `discounted_returns` and
`differential_returns` on padded rollouts (invalid steps r = 0, dt = 0),
`group_baselines` with lanes that end at different steps, and
`AvgNumJobsBuffer` through extends that drop dt <= 0 and invalid steps,
wrap the ring and overflow it, all within rtol 1e-5; the `grad_health`
bits equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.env.health import grad_health as jax_grad_health
from sparksched_tpu.trainers import baselines as jbl
from sparksched_tpu.trainers import returns as jret
from sparksched_tpu_torch.env.health import grad_health
from sparksched_tpu_torch.trainers import baselines as tbl
from sparksched_tpu_torch.trainers import returns as tret

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

G, R, T = 2, 3, 40
TOL = dict(rtol=1e-5, atol=1e-6)


def _rollout(seed: int):
    """[G*R, T] rewards, wall times [.., T+1] and valid masks: each lane a
    valid prefix of its own length, times increasing on it (ties too),
    padding with r = 0 and the final time repeated (dt = 0)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(T // 3, T + 1, G * R)
    lens[0] = T
    valid = np.arange(T)[None] < lens[:, None]
    steps = rng.exponential(1e4, (G * R, T)).astype(np.float32)
    steps[rng.random((G * R, T)) < 0.1] = 0.0
    t = np.concatenate([np.zeros((G * R, 1), np.float32),
                        np.cumsum(steps, 1, dtype=np.float32)], 1)
    for i, n in enumerate(lens):
        t[i, n + 1:] = t[i, n]
    r = np.where(valid, -rng.exponential(3e4, (G * R, T)), 0.0).astype(
        np.float32)
    return r, t.astype(np.float32), valid


@pytest.mark.parametrize("seed", [0, 1])
def test_returns_match_jax(seed):
    r, t, valid = _rollout(seed)
    jd = np.asarray(jret.step_dts(jnp.asarray(t)))
    td = tret.step_dts(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(
        tret.discounted_returns(torch.from_numpy(r), torch.from_numpy(td),
                                5e-3).numpy(),
        np.asarray(jret.discounted_returns(jnp.asarray(r), jnp.asarray(jd),
                                           5e-3)), **TOL)
    avg = np.float32(3.7)
    np.testing.assert_allclose(
        tret.differential_returns(torch.from_numpy(r), torch.from_numpy(td),
                                  torch.tensor(avg)).numpy(),
        np.asarray(jret.differential_returns(jnp.asarray(r), jnp.asarray(jd),
                                             jnp.asarray(avg))), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_group_baselines_match_jax(seed):
    r, t, valid = _rollout(seed)
    ret = np.asarray(jret.discounted_returns(
        jnp.asarray(r), jret.step_dts(jnp.asarray(t)), 5e-3))
    obs_t = t[:, :T].reshape(G, R, T)
    want = np.asarray(jbl.group_baselines(
        jnp.asarray(obs_t), jnp.asarray(ret.reshape(G, R, T)),
        jnp.asarray(valid.reshape(G, R, T))))
    got = tbl.group_baselines(
        torch.from_numpy(obs_t), torch.from_numpy(ret.reshape(G, R, T)),
        torch.from_numpy(valid.reshape(G, R, T))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_avg_num_jobs_buffer_matches_jax():
    cap = 50
    jb, tb = jret.AvgNumJobsBuffer.create(cap), tret.AvgNumJobsBuffer.create(
        cap)
    for seed in range(4):  # 3 partial fills (with a wrap), then overflow
        r, t, valid = _rollout(seed)
        n = (seed + 1) * 7 if seed < 3 else T
        r, t, valid = r[:, :n], t[:, :n + 1], valid[:, :n]
        d = np.diff(t, axis=1)
        jb = jb.extend(jnp.asarray(d), jnp.asarray(r), jnp.asarray(valid))
        tb = tb.extend(torch.from_numpy(d), torch.from_numpy(r),
                       torch.from_numpy(valid))
        np.testing.assert_array_equal(tb.dt.numpy(), np.asarray(jb.dt))
        np.testing.assert_array_equal(tb.r.numpy(), np.asarray(jb.r))
        assert int(tb.ptr) == int(jb.ptr)
        np.testing.assert_allclose(float(tb.avg_num_jobs()),
                                   float(jb.avg_num_jobs()), rtol=1e-5)


@pytest.mark.parametrize("loss,grad_bad,param_bad", [
    (1.0, None, None), (float("nan"), None, None), (float("inf"), "nan",
                                                    None),
    (2.0, "inf", "nan"), (0.5, None, "inf"),
])
def test_grad_health_bits_match_jax(loss, grad_bad, param_bad):
    def tree(bad):
        a = np.ones((3, 4), np.float32)
        if bad:
            a[1, 2] = float(bad)
        return {"w": a, "b": np.zeros(4, np.float32),
                "n": np.arange(3, dtype=np.int32)}
    g, p = tree(grad_bad), tree(param_bad)
    want = int(jax_grad_health(
        loss=jnp.float32(loss),
        grads={k: jnp.asarray(v) for k, v in g.items()},
        params={k: jnp.asarray(v) for k, v in p.items()}))
    got = int(grad_health(
        loss=torch.tensor(loss),
        grads=[torch.from_numpy(v) for v in g.values()],
        params={k: torch.from_numpy(v) for k, v in p.items()}))
    assert got == want
    assert int(grad_health()) == int(jax_grad_health()) == 0
