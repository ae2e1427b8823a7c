"""The port's `rbg` stream (`fast_prng: True`) against jax.random's.

- The plain Philox bits (`kernels/rbg.py:rbg_bits_ref`) equal
  `lax.rng_bit_generator` for 20 random keys at 2-D shapes whose counts
  are not multiples of 4, and for keys whose 128-bit counter carries
  across words and wraps.
- `PRNGKey`, `split`, `fold_in`, `random_bits`, `uniform`, `randint`,
  `choice`, `categorical` and `permutation` equal jax.random's under
  `jax_default_prng_impl = "rbg"`, for single keys and for batches of
  keys (jax under `vmap`, whose rng_bit_generator batching rule draws a
  batch as one stream of its first key); `gumbel` and `exponential`
  within `test_torch_prng.py`'s rtol 1e-6 (atol 1e-6 for Gumbel noise
  near 0): XLA's and torch's float32 `log` / `log1p` may part in the last
  ulp (ROADMAP queue C); the uniforms under them are equal.
- (`test_torch_rbg_trainer.py` holds the port trainer under
  `fast_prng: True` against the JAX trainer.)
- A run stopped after its first iteration under rbg and resumed for one
  more equals an uninterrupted 2-iteration run bit for bit (its train
  state's bytes, the 4-word rng included); a train state written under
  threefry2x32 is refused with the JAX package's message, and the
  flagship config builds an rbg trainer.

`fast_prng` in the JAX trainer flips jax's process-wide default impl;
this module sets rbg for its own tests and restores the impl it found,
even on a failure, so that later files on the same worker run under
their default.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.config import load
from sparksched_tpu_torch.kernels.rbg import rbg_bits_ref, rbg_random_bits
from sparksched_tpu_torch.serialization import to_bytes
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import mini_train_cfg
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 42, 2**20 + 3, 123456789]


@pytest.fixture(scope="module", autouse=True)
def rbg_default_impl():
    saved = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", saved)


def _k(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_plain_philox_bits_match_rng_bit_generator():
    rs = np.random.default_rng(3)
    keys = [rs.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
            for _ in range(20)]
    keys += [np.array([1, 2, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32),
             np.array([0xFFFFFFFF] * 4, np.uint32),
             np.array([5, 6, 0xFFFFFFFE, 0], np.uint32)]
    for key in keys:
        shape = (int(rs.integers(1, 9)), int(rs.integers(1, 11)))
        _, want = lax.rng_bit_generator(jnp.asarray(key), shape,
                                        dtype=jnp.uint32)
        got = rbg_bits_ref(_k(key), shape[0] * shape[1]).reshape(shape)
        assert np.array_equal(np.asarray(want).astype(np.int64),
                              got.numpy()), (key, shape)


def test_batch_draws_one_stream_of_the_first_key():
    jb = jax.random.split(jax.random.PRNGKey(9), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5,)))(jb))
    tb = _k(jb)
    got = rbg_random_bits(tb, (5,))
    assert np.array_equal(want.astype(np.int64), got.numpy())
    assert torch.equal(got.reshape(-1), rbg_bits_ref(tb[0], 15))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_tree_split_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, impl="rbg")
    assert tk.shape == (4,) and prng.impl_of(tk) == "rbg"
    assert torch.equal(_k(jk), tk)
    for depth in range(3):
        jk2 = jax.random.fold_in(jk, 2**20 + depth)
        tk2 = prng.fold_in(tk, 2**20 + depth)
        assert torch.equal(_k(jk2), tk2)
        jks, tks = jax.random.split(jk2, 5), prng.split(tk2, 5)
        assert torch.equal(_k(jks), tks)
        jk, tk = jks[depth], tks[depth]
    jb, tb = jax.random.split(jk, 4), prng.split(tk, 4)
    assert torch.equal(_k(jax.vmap(lambda k: jax.random.split(k, 3))(jb)),
                       prng.split(tb, 3))
    assert torch.equal(_k(jax.vmap(lambda k: jax.random.fold_in(k, 1))(jb)),
                       prng.fold_in(tb, 1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (3,), (3, 7), (201,)])
def test_bits_uniform_randint_exponential(seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed, impl="rbg")
    jb, tb = jax.random.split(jk, 3), prng.split(tk, 3)
    draws = [
        (lambda k: jax.random.bits(k, shape),
         lambda k: prng.random_bits(k, shape)),
        (lambda k: jax.random.uniform(k, shape),
         lambda k: prng.uniform(k, shape)),
        (lambda k: jax.random.randint(k, shape, 0, 154),
         lambda k: prng.randint(k, shape, 0, 154)),
    ]
    for jf, tf in draws:
        for j, t in ((jf(jk), tf(tk)), (jax.vmap(jf)(jb), tf(tb))):
            j = np.asarray(j)
            if j.dtype == np.uint32:
                j = j.astype(np.int64)
            assert np.array_equal(j, t.numpy())
    e = np.asarray(jax.vmap(lambda k: jax.random.exponential(k, shape))(jb))
    np.testing.assert_allclose(prng.exponential(tb, shape).numpy(), e,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_choice_categorical_gumbel_permutation(seed):
    rs = np.random.default_rng(seed % 1000)
    jb = jax.random.split(jax.random.PRNGKey(seed), 6)
    tb = _k(jb)
    p = rs.random((6, 9)).astype(np.float32)
    want = np.asarray(jax.vmap(
        lambda k, pp: jax.random.choice(k, 9, p=pp))(jb, jnp.asarray(p)))
    assert np.array_equal(want, prng.choice(tb, 9, torch.from_numpy(p))
                          .numpy())
    logits = rs.normal(size=(6, 11)).astype(np.float32)
    logits[:, 3] = -np.inf  # masked choices as the policy heads mask them
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jb, jnp.asarray(logits)))
    assert np.array_equal(want, prng.categorical(
        tb, torch.from_numpy(logits)).numpy())
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (11,)))(jb))
    np.testing.assert_allclose(prng.gumbel(tb, (11,)).numpy(), g,
                               rtol=1e-6, atol=1e-6)
    for n in (7, 48, 70_000):  # 70,000 takes two sort rounds
        want = np.asarray(jax.vmap(
            lambda k: jax.random.permutation(k, n))(jb[:2]))
        assert np.array_equal(want, prng.permutation(tb[:2], n).numpy())
    # epochs x lanes, as the PPO minibatches draw them
    eb = jnp.stack([jb[:3], jb[3:]])
    want = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.permutation(k, 48)))(eb))
    assert np.array_equal(want, prng.permutation(_k(eb), 48).numpy())


class _Stop(Exception):
    pass


def _small_cfg(art, iterations: int, fast_prng: bool = True) -> dict:
    cfg = mini_train_cfg(num_iterations=iterations, artifacts_dir=str(art),
                         rollout_steps=12, num_sequences=1,
                         fast_prng=fast_prng)
    cfg["health"] = {"enabled": True, "checkpoint_every": 1, "keep": 2}
    return cfg


def test_rbg_resume_is_bit_exact_and_threefry_state_is_refused(tmp_path):
    full_t = make_trainer(_small_cfg(tmp_path / "full", 2), device="cpu")
    full = full_t.train()

    def stop_after_first(i, state, stats):
        if i == 0:
            raise _Stop

    stopped = make_trainer(_small_cfg(tmp_path / "stop", 2), device="cpu")
    with pytest.raises(_Stop):
        stopped.train(callback=stop_after_first)
    ckpt = tmp_path / "stop" / "train_state.msgpack"
    meta = json.loads((tmp_path / "stop" /
                       "train_state.msgpack.meta.json").read_text())
    assert meta["prng_impl"] == "rbg" and meta["iteration"] == 1
    resumer = make_trainer(_small_cfg(tmp_path / "stop", 1), device="cpu")
    resumed = resumer.train(resume_from=str(ckpt))
    assert resumed.iteration == full.iteration == 2
    assert resumed.rng.shape == (4,)
    assert (to_bytes(resumer.train_state_tree(resumed))
            == to_bytes(full_t.train_state_tree(full)))

    # a threefry train state under an rbg run: refused as JAX refuses it
    tf = make_trainer(_small_cfg(tmp_path / "tf", 1, fast_prng=False),
                      device="cpu")
    path = str(tmp_path / "tf_state.msgpack")
    tf.save_train_state(tf.init_state(), path)
    with pytest.raises(ValueError) as port_err:
        resumer.load_train_state(path)
    jt = jax_make_trainer(_small_cfg(tmp_path / "jax", 1))
    with pytest.raises(ValueError) as jax_err:
        jt.load_train_state(path)
    jax_msg = str(jax_err.value).replace(
        " (config.use_fast_prng switches the impl)", "")
    assert str(port_err.value) == jax_msg
    assert "set `fast_prng: False`" in jax_msg
    # a meta-less state with a threefry rng fails the key's shape check
    os.remove(path + ".meta.json")
    with pytest.raises(ValueError, match="uint32\\[4\\].*fast_prng"):
        resumer.load_train_state(path)


def test_flagship_config_trains_under_rbg(tmp_path, capsys):
    cfg = load(os.path.join(REPO, "config", "decima_tpch.yaml"))
    assert cfg["trainer"]["fast_prng"] is True
    cfg["trainer"]["artifacts_dir"] = str(tmp_path)
    t = make_trainer(cfg, device="cpu")
    out = capsys.readouterr().out
    ignored = out.split("ignored:", 1)[1] if "ignored:" in out else ""
    assert "fast_prng" not in ignored
    state = t.init_state()
    assert t.prng_impl == "rbg" and state.rng.shape == (4,)
    seq, lane = t.lane_keys(0)
    assert seq.shape == lane.shape == (t.num_envs, 4)
    t.save_train_state(state, str(tmp_path / "s.msgpack"))
    meta = json.loads((tmp_path / "s.msgpack.meta.json").read_text())
    assert meta["prng_impl"] == "rbg"
