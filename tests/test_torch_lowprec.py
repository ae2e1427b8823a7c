"""The port's low-precision layouts against the JAX package's.

- `quantize_bank` at `int16`, `int8` and `bf16`: the narrow duration
  table and the per-template `dur_scale` bit-equal to the JAX package's;
  `make_workload_bank(bank_dtype=)` gives the same bank.
- `sample_task_duration` on each narrow bank, 4,096 draws from one set of
  numpy inputs: within 1 ulp of the JAX package's (the int banks'
  `expm1` is XLA's on one side and torch's on the other, which may part
  in the last ulp; the bf16 bank's cast is exact, so equal there).
- A sync single-eval collection with `obs_dtype: bfloat16` on an `int16`
  bank (4 lanes, T = 48, stochastic Decima sampling, health on) against
  the JAX collector from the same keys and carried weights: the bf16
  `StoredObs.duration` buffer bit-equal, every other leaf as
  `test_torch_rollout.py` holds it (floats within rtol 1e-6, log-probs
  within rtol 1e-5), the rewards there with XLA's `expm1` handed to the
  port, and on the lanes whose wall times are bit-equal with torch's.
  (`compute_dtype: bfloat16` is `test_torch_bf16.py`'s.)

Sizes: 5 executors, 6 job slots on the synthetic bank, weights x0.3."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.env import core as jcore
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.trainers import rollout as jro
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu.workload import quantize_bank as jax_quantize
from sparksched_tpu.workload.sampling import (
    sample_task_duration as jax_sample,
)
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.trainers import rollout as tro
from sparksched_tpu_torch.workload import (
    bank_dtype_label,
    make_workload_bank,
    quantize_bank,
)
from sparksched_tpu_torch.workload.sampling import sample_task_duration

from ._torch_parity import (
    decima_pair,
    jax_leaves,
    mismatched_leaves,
    port_rollout_leaves,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

N, J, LANES = 5, 6, 4


@functools.lru_cache(maxsize=None)
def _banks():
    jb = jax_bank(N, 20)
    tb = make_workload_bank(N, 20, device="cpu")
    return jb, tb


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy array (bf16 as its 16-bit words)."""
    a = np.asarray(a)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def _port_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", ["int16", "int8", "bf16"])
def test_quantize_bank_matches_jax(dtype):
    jb, tb = _banks()
    jq, tq = jax_quantize(jb, dtype), quantize_bank(tb, dtype)
    assert bank_dtype_label(tq) == dtype
    assert np.array_equal(_bits(jq.dur), _port_np(tq.dur))
    if dtype == "bf16":
        assert jq.dur_scale is None and tq.dur_scale is None
    else:
        assert str(np.asarray(jq.dur).dtype) == dtype
        assert np.array_equal(np.asarray(jq.dur_scale),
                              tq.dur_scale.numpy())
    via = make_workload_bank(N, 20, bank_dtype=dtype, device="cpu")
    assert torch.equal(via.dur, tq.dur)


@pytest.mark.parametrize("dtype", ["int16", "int8", "bf16"])
def test_sampled_durations_match_jax(dtype):
    jb, tb = _banks()
    jq, tq = jax_quantize(jb, dtype), quantize_bank(tb, dtype)
    jp = JaxParams(num_executors=N, max_jobs=J, max_stages=jb.max_stages)
    tp = EnvParams(num_executors=N, max_jobs=J, max_stages=tb.max_stages)
    rs = np.random.default_rng(5)
    n = 4096
    tpl = rs.integers(0, tb.num_templates, n).astype(np.int32)
    ns = tb.num_stages.numpy()[tpl]
    stage = (rs.random(n) * ns).astype(np.int32)
    num_local = rs.integers(1, N + 1, n).astype(np.int32)
    valid = rs.random(n) < 0.5
    same = rs.random(n) < 0.5
    u2 = rs.random((n, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda u, t, s, nl, v, ss: jax_sample(jp, jq, u, t, s, nl, v, ss)
    )(jnp.asarray(u2), jnp.asarray(tpl), jnp.asarray(stage),
      jnp.asarray(num_local), jnp.asarray(valid), jnp.asarray(same)))
    got = sample_task_duration(
        tp, tq, torch.from_numpy(u2), torch.from_numpy(tpl),
        torch.from_numpy(stage), torch.from_numpy(num_local),
        torch.from_numpy(valid), torch.from_numpy(same)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= (0 if dtype == "bf16" else 1), int(ulps.max())
    # the narrow table is not the f32 one: the draws moved
    full = sample_task_duration(
        tp, tb, torch.from_numpy(u2), torch.from_numpy(tpl),
        torch.from_numpy(stage), torch.from_numpy(num_local),
        torch.from_numpy(valid), torch.from_numpy(same)).numpy()
    assert not np.array_equal(full, got)


def _reset_keys(seed: int):
    master = jax.random.PRNGKey(seed)
    seq = [jax.random.fold_in(jax.random.fold_in(master, g), 0)
           for g in (0, 0, 1, 1)]
    lane = [jax.random.fold_in(s, 1000 + r)
            for s, r in zip(seq, (0, 1, 0, 1))]
    js, jl = jnp.stack(seq), jnp.stack(lane)

    def port(k):
        return torch.from_numpy(np.asarray(k).astype(np.int64))
    return (js, jl), (port(js), port(jl))


@functools.lru_cache(maxsize=None)
def _jax_collected(bank_dtype: str):
    jb, _ = _banks()
    jb = jax_quantize(jb, bank_dtype)
    jp = JaxParams(num_executors=N, max_jobs=J, mean_time_limit=2e7,
                   max_stages=jb.max_stages, max_levels=jb.max_stages,
                   obs_dtype="bf16")
    jsch, _ = decima_pair(N, job_bucket=3)
    (js, jl), _ = _reset_keys(7)
    jstates = jax.vmap(lambda s, l: jcore.reset_pair(jp, jb, s, l))(js, jl)
    jout, jtm = jro.collect_flat_sync_batch(
        jp, jb, lambda k, o: jsch.batch_policy(k, o, jsch.params),
        jax.random.PRNGKey(21), T_COLLECT, jstates,
        telemetry_zeros_like((LANES,)), health=True)
    return jout, np.asarray(jtm.health_mask)


def _port_collected(bank_dtype: str):
    _, tb = _banks()
    tb = quantize_bank(tb, bank_dtype)
    tp = EnvParams(num_executors=N, max_jobs=J, mean_time_limit=2e7,
                   max_stages=tb.max_stages, max_levels=tb.max_stages,
                   obs_dtype="bf16")
    assert tp.obs_dtype == "bfloat16"
    _, tsch = decima_pair(N, job_bucket=3)
    _, (ts_, tl) = _reset_keys(7)
    key = torch.from_numpy(np.asarray(jax.random.PRNGKey(21)).astype(
        np.int64))
    return tro.collect_flat_sync_batch(
        tp, tb, lambda k, o: tsch.batch_policy(k, o), key, T_COLLECT,
        core.reset_pair(tp, tb, ts_, tl), health=True)


def _xla_expm1(x: torch.Tensor) -> torch.Tensor:
    """float32 expm1 as XLA computes it (through jax on the CPU)."""
    return torch.from_numpy(np.array(jnp.expm1(x.numpy())))


T_COLLECT = 48


@pytest.mark.parametrize("bank_dtype,expm1", [
    ("int16", "xla"), ("int16", "torch")])
def test_bf16_obs_collection_matches_jax(bank_dtype, expm1, monkeypatch):
    """`obs_dtype: bfloat16` on a narrow bank: the bf16 duration buffer
    bit-equal, actions, masks and states as `test_torch_rollout.py` holds
    them. The int16 bank's codes go through `expm1`, where torch and XLA
    part in the last ulp for some codes (`test_sampled_durations_match_
    jax`): with XLA's `expm1` handed to the port ("xla") the rewards hold
    at `test_torch_rollout.py`'s rtol 1e-6; with torch's own, the
    wall times still hold there, while a reward, a difference of wall
    times, carries their last-ulp difference (ROADMAP queue C), so there
    the rewards are held only where the wall times agree bit for bit."""
    if expm1 == "xla":
        monkeypatch.setattr(torch, "expm1", _xla_expm1)
    jout, jhm = _jax_collected(bank_dtype)
    tout, thm = _port_collected(bank_dtype)
    assert tout.obs.duration.dtype == torch.bfloat16
    assert str(np.asarray(jout.obs.duration).dtype) == "bfloat16"
    assert np.array_equal(_bits(jout.obs.duration),
                          _port_np(tout.obs.duration))
    assert float(tout.obs.duration.float().abs().max()) > 0
    pl = port_rollout_leaves(dataclasses.replace(
        tout, obs=dataclasses.replace(tout.obs,
                                      duration=tout.obs.duration.float())))
    jl = jax_leaves(jout)
    names = [n for n, _ in pl]
    lg, rw = names.index("lgprob"), names.index("reward")
    np.testing.assert_allclose(pl[lg][1], jl[lg], rtol=1e-5, atol=1e-6)
    skip = {lg, names.index("obs.duration")}
    if expm1 == "torch" and bank_dtype == "int16":
        skip.add(rw)
        wt = names.index("wall_times")
        same = np.all(pl[wt][1] == jl[wt], axis=1)  # lanes bit-equal
        assert same.any()
        np.testing.assert_allclose(pl[rw][1][same], jl[rw][same],
                                   rtol=1e-6)
    rest = [i for i in range(len(pl)) if i not in skip]
    bad = mismatched_leaves([jl[i] for i in rest], [pl[i] for i in rest],
                            rtol=1e-6)
    assert not bad, bad
    assert np.array_equal(jhm, thm.numpy())
    assert not thm.any() and tout.valid.sum() > LANES * 10
