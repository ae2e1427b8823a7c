"""The port's workload bank and samplers against the JAX package at 10
executors: the packed bank must be equal leaf by leaf; job sequences and
task durations from the same keys / uniforms agree (arrival times within
rtol 1e-6: they are an exponential — last-ulp log1p differences — summed
by a cumsum that XLA may associate differently; everything else equal)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu.workload.sampling import (
    sample_job_sequence as jax_seq,
    sample_task_duration as jax_dur,
)
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.workload import make_workload_bank
from sparksched_tpu_torch.workload.sampling import (
    sample_job_sequence,
    sample_task_duration,
)

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

N = 10


@pytest.fixture(scope="module")
def banks():
    return jax_bank(N), make_workload_bank(N, device="cpu")


def test_pack_bank_equal_leaf_by_leaf(banks):
    jb, tb = banks
    for f in dataclasses.fields(tb):
        if getattr(tb, f.name) is None:  # dur_scale of an f32 bank
            assert getattr(jb, f.name) is None, f.name
            continue
        a = np.asarray(getattr(jb, f.name))
        b = getattr(tb, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name
    assert jb.dur_scale is None and tb.dur_scale is None


@pytest.mark.parametrize("limit", [None, 2e6])
def test_sample_job_sequence(banks, limit):
    jb, tb = banks
    jp = JaxParams(num_executors=N, max_jobs=40)
    tp = EnvParams(num_executors=N, max_jobs=40)
    seeds = [0, 3, 11, 99]
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    tl = np.float32(np.inf if limit is None else limit)
    ja = jax.vmap(lambda k: jax_seq(jp, jb, k, tl))(jkeys)
    ta = sample_job_sequence(
        tp, tb, torch.stack([prng.PRNGKey(s) for s in seeds]),
        torch.full((len(seeds),), float(tl)),
    )
    arr_j, arr_t = np.asarray(ja[0]), ta[0].numpy()
    assert np.array_equal(np.isinf(arr_j), np.isinf(arr_t))
    fin = np.isfinite(arr_j)
    np.testing.assert_allclose(arr_t[fin], arr_j[fin], rtol=1e-6, atol=0)
    for a, b in zip(ja[1:], ta[1:]):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_sample_task_duration(banks):
    jb, tb = banks
    jp = JaxParams(num_executors=N)
    tp = EnvParams(num_executors=N)
    rng = np.random.default_rng(0)
    b = 256
    tpl = rng.integers(0, tb.num_templates, b).astype(np.int32)
    stage = (rng.integers(0, 20, b) % np.maximum(
        np.asarray(jb.num_stages)[tpl], 1)).astype(np.int32)
    num_local = rng.integers(0, N + 1, b).astype(np.int32)
    valid = rng.random(b) < 0.5
    same = rng.random(b) < 0.5
    u2 = rng.random((b, 2)).astype(np.float32)
    ja = jax.vmap(lambda u, t, s, n, v, m: jax_dur(jp, jb, u, t, s, n, v, m))(
        u2, tpl, stage, num_local, valid, same
    )
    ta = sample_task_duration(
        tp, tb, torch.from_numpy(u2), torch.from_numpy(tpl),
        torch.from_numpy(stage), torch.from_numpy(num_local),
        torch.from_numpy(valid), torch.from_numpy(same),
    )
    assert np.array_equal(np.asarray(ja), ta.numpy())
