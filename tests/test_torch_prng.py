"""The port's PRNG (`sparksched_tpu_torch/prng.py`) against jax.random's
default threefry2x32 with partitionable bits: keys, bits, uniforms,
integers, weighted choices, permutations (1 and 2 sort rounds, batched
keys as the PPO minibatches draw them) and categorical draws must be
equal; exponentials and Gumbel noise agree within rtol 1e-6 (XLA's and
torch's float32 log1p and log may differ in the last ulp; the
uniforms under them are equal)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu_torch import prng

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

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


def test_uniform_at_the_bulk_table_shape():
    """The fused bulk pass draws one (steps, executors, 2) table per key:
    its bits follow the flattened counter, as `jax.random.uniform`'s."""
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (8, 50, 2)))(keys))
    assert np.array_equal(u, prng.uniform(_k(keys), (8, 50, 2)).numpy())


@pytest.mark.parametrize("n", [1, 6, 16, 17, 50, 200])
def test_choice_with_p_matches_jax(n):
    """`jax.random.choice(key, n, p=p)` for the random policy's weights
    (uniform over a random subset, zeros elsewhere) and for arbitrary
    ones; the cumulative weights follow XLA's summation order, so the
    draws are equal even where a draw lands on a boundary."""
    rng = np.random.default_rng(n)
    keys = jax.random.split(jax.random.PRNGKey(n), 64)
    has = rng.random((64, n)) < 0.5
    has[0] = False  # no weight at all: index 0, as jax
    uni = (np.where(has, 1.0, 0.0)
           / np.maximum(1, has.sum(1, keepdims=True))).astype(np.float32)
    arb = rng.random((64, n)).astype(np.float32)
    for p in (uni, arb):
        j = np.asarray(jax.vmap(lambda k, w: jax.random.choice(k, n, p=w))(
            keys, jnp.asarray(p)))
        t = prng.choice(_k(keys), n, torch.from_numpy(p))
        assert t.dtype == torch.int32
        assert np.array_equal(j, t.numpy())
        cum = np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(p)))
        assert np.array_equal(cum, prng._cumsum_f32(torch.from_numpy(p)).numpy())


def test_randint_with_per_key_bounds():
    """A traced upper bound per key (the random policy's executor count)
    draws the bits of `jax.random.randint` with that bound."""
    keys = jax.random.split(jax.random.PRNGKey(9), 12)
    hi = np.array([1, 2, 3, 5, 8, 13, 50, 0, -2, 7, 200, 1000], np.int32)
    j = np.asarray(jax.vmap(lambda k, h: jax.random.randint(
        k, (), 1, h, dtype=jnp.int32))(keys, jnp.asarray(hi)))
    t = prng.randint(_k(keys), (), 1, torch.from_numpy(hi))
    assert np.array_equal(j, t.numpy())


@pytest.mark.parametrize("n", [1, 5, 48, 60, 9600])
def test_permutation_bits_equal(n):
    """ceil(3 ln n / ln(2^32 - 1)) stable-sort rounds: 0 at n = 1, 1 up
    to n = 1,625, 2 at 9,600 (the flagship's rollout_steps)."""
    for seed in SEEDS[:3]:
        jk = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(jax.random.permutation(jk, n)),
                              prng.permutation(prng.PRNGKey(seed), n).numpy())
    # [E, B] keys as the PPO update derives them: split, then fold_in
    ek = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 13), 3)
    jl = jax.vmap(lambda k: jax.vmap(lambda b: jax.random.fold_in(k, b))(
        jnp.arange(4)))(ek)
    want = jax.vmap(jax.vmap(lambda k: jax.random.permutation(k, n)))(jl)
    tl = torch.stack([prng.fold_in(_k(ek), b) for b in range(4)], 1)
    assert torch.equal(_k(jl), tl)
    assert np.array_equal(np.asarray(want), prng.permutation(tl, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_categorical_match_jax(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (37,)))(keys))
    tg = prng.gumbel(_k(keys), (37,)).numpy()
    np.testing.assert_allclose(tg, g, rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(seed).standard_normal((16, 37)).astype(
        np.float32)
    logits[:, ::3] = -1e30  # masked entries, as the Decima heads mask
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = prng.categorical(_k(keys), torch.from_numpy(logits)).numpy()
    assert np.array_equal(got, want)
    assert (got % 3 != 0).all()
