"""The engine's split-then-draw (`prng.split_uniform`, `kernels/rbg.py`)
against jax.random, bit for bit, under both impls.

`split_uniform(keys, shape)` is `keys2 = split(keys); (keys2[:, 0],
uniform(keys2[:, 1], shape))`: each lane's next key, and the uniforms the
JAX engine draws under `vmap` -- under threefry each lane's second key
over its own iota, under rbg ONE Philox stream of the first lane's second
key, lane b taking words [b * n, (b + 1) * n). Held here on CPU keys (the
plain version `split_uniform_ref`) against `jax.vmap(jax.random.split)`
then `jax.vmap(jax.random.uniform)` at the draw shapes of the five engine
sites (`_apply_action` (2,), `_bulk_fulfill` / `_bulk_ready` (n, 2),
`_bulk_relaunch` (max_events * n, 2), `_bulk_events_fused`'s plain
version (length, n, 2)), for lane keys that are non-contiguous views,
one lane, a single key and an empty draw; and the five sites call it. The engine's own parity
tests (`test_torch_bulk.py`, `test_torch_drain.py`, `test_torch_env.py`,
`test_torch_rbg_trainer.py`, ...) hold the rewired sites against the JAX
engine.
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu_torch import prng
from sparksched_tpu_torch.env import core
from sparksched_tpu_torch.kernels.rbg import split_uniform, split_uniform_ref

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

IMPLS = {"threefry2x32": 2, "rbg": 4}
# the five sites' draw shapes at 50 executors (the flagship's), with
# max_events 3 and a fused pass of 8 events
SITE_SHAPES = [(2,), (50, 2), (3 * 50, 2), (8, 50, 2)]
SITES = ("_apply_action", "_bulk_fulfill", "_bulk_relaunch", "_bulk_ready",
         "_bulk_events_fused_ref")


def _lane_keys(impl: str, lanes: int, seed: int):
    """(jax typed keys, the same words as a non-contiguous torch view)."""
    rs = np.random.default_rng(seed)
    w = IMPLS[impl]
    words = rs.integers(0, 2**32, (lanes, w), dtype=np.uint64).astype(
        np.uint32)
    buf = torch.from_numpy(rs.integers(0, 2**32, (lanes, 3, w)).astype(
        np.int64))
    buf[:, 2] = torch.from_numpy(words.astype(np.int64))
    return jax.random.wrap_key_data(jnp.asarray(words), impl=impl), buf[:, 2]


def _jax_split_uniform(jk, shape):
    keys = jax.vmap(jax.random.split)(jk)
    u = jax.vmap(lambda k: jax.random.uniform(k, shape))(keys[:, 1])
    nxt = np.asarray(jax.random.key_data(keys[:, 0])).astype(np.int64)
    return nxt, np.asarray(u)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("shape", SITE_SHAPES)
def test_split_uniform_matches_jax_at_the_engine_sites(impl, shape):
    jk, tk = _lane_keys(impl, 16, len(shape) + IMPLS[impl])
    assert not tk.is_contiguous()
    want_next, want_u = _jax_split_uniform(jk, shape)
    plain0 = split_uniform.plain_calls
    nxt, u = prng.split_uniform(tk, shape)
    assert split_uniform.plain_calls == plain0 + 1
    assert nxt.dtype == torch.int64 and u.dtype == torch.float32
    assert np.array_equal(nxt.numpy(), want_next)
    assert np.array_equal(u.numpy(), want_u)
    ref_next, ref_u = split_uniform_ref(tk, shape)
    assert torch.equal(ref_next, nxt) and torch.equal(ref_u, u)
    # the same as the split and the draw the sites made before
    keys = prng.split(tk)
    assert torch.equal(keys[:, 0], nxt)
    assert torch.equal(prng.uniform(keys[:, 1], shape), u)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_split_uniform_one_lane_one_key_and_empty_draws(impl):
    jk, tk = _lane_keys(impl, 1, 7)
    want_next, want_u = _jax_split_uniform(jk, (5, 2))
    nxt, u = prng.split_uniform(tk, (5, 2))
    assert np.array_equal(nxt.numpy(), want_next)
    assert np.array_equal(u.numpy(), want_u)
    # a single key: jax's split then uniform, no vmap
    keys = jax.random.split(jk[0])
    nxt, u = prng.split_uniform(tk[0], (3,))
    assert nxt.shape == (IMPLS[impl],) and u.shape == (3,)
    assert np.array_equal(nxt.numpy(), np.asarray(
        jax.random.key_data(keys[0])).astype(np.int64))
    assert np.array_equal(u.numpy(), np.asarray(jax.random.uniform(
        keys[1], (3,))))
    # no words drawn: the next keys all the same
    jk, tk = _lane_keys(impl, 4, 8)
    nxt, u = prng.split_uniform(tk, (0, 2))
    assert u.shape == (4, 0, 2)
    assert np.array_equal(nxt.numpy(), _jax_split_uniform(jk, (1,))[0])


def test_split_uniform_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="unsupported device"):
        prng.split_uniform(prng.PRNGKey(1).to("meta")[None], (2,))
    with pytest.raises(ValueError, match="int64"):
        prng.split_uniform(prng.PRNGKey(1).to(torch.int32)[None], (2,))
    with pytest.raises(ValueError, match="int64 keys"):
        prng.split_uniform(torch.zeros(3, 3, dtype=torch.int64), (2,))


def test_the_five_engine_sites_call_split_uniform():
    """The fused pass's site is its plain version: `_bulk_events_fused`
    itself hands the state to the fused kernel's wrapper, which derives
    the uniforms in the kernel (`tests/test_torch_bulk_kernel.py`)."""
    for name in SITES:
        src = inspect.getsource(getattr(core, name))
        assert src.count("prng.split_uniform(state.rng") == 1, name
        assert "prng.split(" not in src and "prng.uniform(" not in src, name
    src = inspect.getsource(core._bulk_events_fused)
    assert "bulk_events_fused(params, bank, state" in src
    assert "prng." not in src
