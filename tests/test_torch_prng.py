"""The port's PRNG (`sparksched_tpu_torch/prng.py`) against jax.random's
default threefry2x32 with partitionable bits: keys, bits, uniforms and
integers must be equal; exponentials agree within rtol 1e-6 (XLA's and
torch's float32 log1p may differ in the last ulp)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sparksched_tpu_torch import prng

SEEDS = [0, 1, 42, 2**20 + 3, 123456789]


def _k(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_tree_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert torch.equal(_k(jk), tk)
    for depth in range(3):
        jk2 = jax.random.fold_in(jk, 2**20 + depth)
        tk2 = prng.fold_in(tk, 2**20 + depth)
        assert torch.equal(_k(jk2), tk2)
        jks, tks = jax.random.split(jk2, 5), prng.split(tk2, 5)
        assert torch.equal(_k(jks), tks)
        jk, tk = jks[depth], tks[depth]
    # batched keys: split/fold_in under vmap equal the port's batch form
    jb = jax.random.split(jk, 4)
    tb = prng.split(tk, 4)
    assert torch.equal(_k(jax.vmap(jax.random.split)(jb)), prng.split(tb))
    assert torch.equal(
        _k(jax.vmap(lambda k: jax.random.fold_in(k, 1))(jb)),
        prng.fold_in(tb, 1),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (2,), (3, 7), (200,)])
def test_bits_uniform_randint_exponential(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert torch.equal(torch.from_numpy(bits), prng.random_bits(tk, shape))
    u = np.asarray(jax.random.uniform(jk, shape))
    assert np.array_equal(u, prng.uniform(tk, shape).numpy())
    for hi in (1, 5, 154, 1000):
        r = np.asarray(jax.random.randint(jk, shape, 0, hi))
        assert np.array_equal(r, prng.randint(tk, shape, 0, hi).numpy())
    e = np.asarray(jax.random.exponential(jk, shape))
    np.testing.assert_allclose(prng.exponential(tk, shape).numpy(), e,
                               rtol=1e-6, atol=0)


def test_batched_uniform_matches_vmap():
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(keys))
    assert np.array_equal(u, prng.uniform(_k(keys), (2,)).numpy())
