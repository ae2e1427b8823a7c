"""The port's threefry key chain against jax.random, bit for bit.

- `csrc/prng_core.cuh`, the arithmetic both PRNG kernels run, built with
  g++ into a small shared library through a C shim (the box has no nvcc):
  the threefry2x32 hash against `threefry2x32_p` (counters past 2^32),
  the per-thread body of the hash kernel on the one-hop path
  (`threefry_path_item` over the table (PATH_VAR,): split, fold_in, bits
  and uniforms of a few thousand keys of both impls, key rows read
  through a stride, counter bases across 2^32; deeper paths are
  `test_torch_key_paths.py`'s), its Philox
  block against `lax.rng_bit_generator` (counters that carry and wrap),
  and the per-thread bodies of `split_uniform` under both impls.
- `threefry2x32_ref` and the wrapper's plain version, and `prng.split`,
  `fold_in`, `random_bits` and `uniform` on CPU keys: batched keys,
  non-contiguous views and the `split(key, B)` of one key that the
  collector makes each row; a CPU key runs the plain version (counted),
  any other non-CUDA device raises.
- `kernels/build.py` rebuilds a library when a header it includes
  changes.

Under rbg, jax's functions take typed keys (`wrap_key_data(...,
impl="rbg")`), so this module never flips jax's default impl.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.extend.random import threefry2x32_p

from sparksched_tpu_torch import prng
from sparksched_tpu_torch.kernels import build
from sparksched_tpu_torch.kernels.threefry import (
    threefry2x32,
    threefry2x32_keys_ref,
    threefry2x32_ref,
)

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

U32 = np.uint32
SHIM = r"""
#include "prng_core.cuh"
using namespace prng_core;
extern "C" {
void shim_hash(long long n, const uint32_t* k0, const uint32_t* k1,
               const uint32_t* x0, const uint32_t* x1, uint32_t* o0,
               uint32_t* o1) {
  for (long long i = 0; i < n; ++i)
    threefry2x32(k0[i], k1[i], x0[i], x1[i], o0[i], o1[i]);
}
void shim_threefry(const int64_t* keys, long long key_stride, long long k,
                   int halves, unsigned long long base, long long n, int mode,
                   void* out) {
  const int64_t path[1] = {kPathVar};
  for (long long t = 0; t < k * n * halves; ++t)
    threefry_path_item(keys, key_stride, halves, path, 1, 1, base, n, mode,
                       t, out);
}
void shim_philox(const uint32_t* key, unsigned long long blk0,
                 long long nblk, uint32_t* out) {
  for (long long b = 0; b < nblk; ++b)
    philox_block(key[0], key[1], key[2], key[3], blk0 + b, out + 4 * b);
}
void shim_split_uniform(const int64_t* keys, long long key_stride,
                        long long lanes, int rbg, long long n, int64_t* next,
                        float* u) {
  if (rbg) {
    uint32_t sub[4];
    rbg_sub_key(keys, sub);
    const long long draw = (lanes * n + 3) / 4;
    for (long long t = 0; t < (draw > lanes ? draw : lanes); ++t)
      split_uniform_rbg_item(keys, key_stride, lanes, n, sub, t, next, u);
  } else {
    const long long draw = lanes * n;
    for (long long t = 0; t < (draw > lanes ? draw : lanes); ++t)
      split_uniform_tf_item(keys, key_stride, lanes, n, t, next, u);
  }
}
}
"""
MODE = {"pair": 0, "bits": 1, "uniform": 2}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """`csrc/prng_core.cuh` behind the C shim, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: prng_core.cuh's host build needs it")
    d = tmp_path_factory.mktemp("prng_core")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libprng_core.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-I", build.CSRC, "-o", str(lib),
                    str(d / "shim.cpp")], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    so.shim_hash.argtypes = [ll] + [vp] * 6
    so.shim_threefry.argtypes = [vp, ll, ll, ctypes.c_int,
                                 ctypes.c_ulonglong, ll, ctypes.c_int, vp]
    so.shim_philox.argtypes = [vp, ctypes.c_ulonglong, ll, vp]
    so.shim_split_uniform.argtypes = [vp, ll, ll, ctypes.c_int, ll, vp, vp]
    return so


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _keys(rs, k: int, words: int) -> np.ndarray:
    return rs.integers(0, 2**32, (k, words), dtype=np.uint64).astype(U32)


def _jkeys(keys: np.ndarray):
    """Typed jax keys of the words' impl (2 words threefry, 4 rbg)."""
    impl = "rbg" if keys.shape[-1] == 4 else "threefry2x32"
    return jax.random.wrap_key_data(jnp.asarray(keys), impl=impl)


def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def core_threefry(core, keys: np.ndarray, n: int, base: int, mode: str,
                  row_stride: int = 0) -> np.ndarray:
    """The kernel's items over `keys` [K, W], read from rows of
    `row_stride` int64 words (a strided view: the other words garbage)."""
    k, w = keys.shape
    stride = row_stride or w
    rows = np.full((k, stride), -7, np.int64)
    rows[:, :w] = keys
    out_w = w if mode == "pair" else 1
    out = np.empty((k, n, out_w),
                   np.float32 if mode == "uniform" else np.int64)
    core.shim_threefry(_ptr(rows), stride, k, w // 2, base, n, MODE[mode],
                       _ptr(out))
    return out if mode == "pair" else out[..., 0]


def test_core_hash_matches_threefry2x32_p(core):
    rs = np.random.default_rng(0)
    n = 3000
    k0, k1, x1 = (rs.integers(0, 2**32, n, dtype=np.uint64).astype(U32)
                  for _ in range(3))
    x0 = np.where(np.arange(n) % 3 == 0, 0,
                  rs.integers(0, 2**32, n, dtype=np.uint64)).astype(U32)
    o0, o1 = np.empty(n, U32), np.empty(n, U32)
    core.shim_hash(n, *(_ptr(a) for a in (k0, k1, x0, x1, o0, o1)))
    j0, j1 = threefry2x32_p.bind(*(jnp.asarray(a) for a in (k0, k1, x0, x1)))
    assert np.array_equal(o0, np.asarray(j0))
    assert np.array_equal(o1, np.asarray(j1))
    t0, t1 = threefry2x32_ref(*(torch.from_numpy(a.astype(np.int64))
                                for a in (k0, k1, x0, x1)))
    assert np.array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    assert np.array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("words", [2, 4])
def test_core_split_and_fold_in_items(core, words):
    rs = np.random.default_rng(words)
    keys = _keys(rs, 2000, words)
    jk = _jkeys(keys)
    want = _data(jax.vmap(lambda k: jax.random.split(k, 5))(jk))
    for stride in (0, 2 * words + 1):
        got = core_threefry(core, keys, 5, 0, "pair", stride)
        assert np.array_equal(got, want)
    for data in (0, 7, 2**31 + 5, 2**32 - 1):
        want = _data(jax.vmap(lambda k: jax.random.fold_in(k, data))(jk))
        got = core_threefry(core, keys, 1, data, "pair")[:, 0]
        assert np.array_equal(got, want)


def test_core_bits_uniform_items_and_counters_past_2_32(core):
    rs = np.random.default_rng(2)
    keys = _keys(rs, 1500, 2)
    jk = _jkeys(keys)
    bits = core_threefry(core, keys, 37, 0, "bits", 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (37,)))(jk))
    assert np.array_equal(bits, want.astype(np.int64))
    u = core_threefry(core, keys, 37, 0, "uniform")
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (37,)))(jk))
    assert np.array_equal(u, want)
    # a counter base that carries into the high word, and one far past it
    for base in (2**32 - 20, 2**40 + 3):
        c = base + np.arange(41, dtype=np.uint64)
        hi, lo = (c >> np.uint64(32)).astype(U32), (c & 0xFFFFFFFF).astype(U32)
        flat = (np.repeat(keys[:50, 0], 41), np.repeat(keys[:50, 1], 41),
                np.tile(hi, 50), np.tile(lo, 50))
        j0, j1 = (np.asarray(j).reshape(50, 41) for j in threefry2x32_p.bind(
            *(jnp.asarray(a) for a in flat)))
        pair = core_threefry(core, keys[:50], 41, base, "pair")
        assert np.array_equal(pair[..., 0], np.asarray(j0).astype(np.int64))
        assert np.array_equal(pair[..., 1], np.asarray(j1).astype(np.int64))
        assert np.array_equal(
            core_threefry(core, keys[:50], 41, base, "bits"),
            (np.asarray(j0) ^ np.asarray(j1)).astype(np.int64))
        plain = threefry2x32_keys_ref(torch.from_numpy(
            keys[:50].astype(np.int64)), 41, base, "pair")
        assert np.array_equal(plain.numpy(), pair)


def test_core_philox_matches_rng_bit_generator(core):
    rs = np.random.default_rng(4)
    keys = list(_keys(rs, 12, 4))
    keys += [np.array([1, 2, 0xFFFFFFFF, 0xFFFFFFFF], U32),
             np.array([0xFFFFFFFF] * 4, U32),
             np.array([5, 6, 0xFFFFFFFE, 0], U32)]
    for key in keys:
        nblk = int(rs.integers(1, 40))
        out = np.empty(4 * nblk, U32)
        core.shim_philox(_ptr(np.ascontiguousarray(key)), 0, nblk, _ptr(out))
        _, want = lax.rng_bit_generator(jnp.asarray(key), (4 * nblk,),
                                        dtype=jnp.uint32)
        assert np.array_equal(out, np.asarray(want)), key


@pytest.mark.parametrize("words", [2, 4])
@pytest.mark.parametrize("shape", [(2,), (50, 2), (7, 50, 2), (3,)])
def test_core_split_uniform_items(core, words, shape):
    rs = np.random.default_rng(10 * words + len(shape))
    lanes = 16
    keys = _keys(rs, lanes, words)
    jk = _jkeys(keys)
    pairs = jax.vmap(jax.random.split)(jk)
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
        pairs[:, 1]))
    stride = words + 3
    rows = np.full((lanes, stride), -1, np.int64)
    rows[:, :words] = keys
    nxt = np.empty((lanes, words), np.int64)
    u = np.empty((lanes,) + shape, np.float32)
    core.shim_split_uniform(_ptr(rows), stride, lanes, int(words == 4),
                            int(np.prod(shape)), _ptr(nxt), _ptr(u))
    assert np.array_equal(nxt, _data(pairs[:, 0]))
    assert np.array_equal(u, want_u)


def _k(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("words", [2, 4])
def test_cpu_key_chain_matches_jax(words):
    rs = np.random.default_rng(20 + words)
    keys = _keys(rs, 24, words)
    jk = _jkeys(keys)
    # a [24, 3, W] buffer whose middle rows are the keys: stride-3W views
    buf = torch.from_numpy(rs.integers(0, 2**32, (24, 3, words)).astype(
        np.int64))
    buf[:, 1] = _k(keys)
    tk = buf[:, 1]
    assert not tk.is_contiguous()
    plain0 = threefry2x32.plain_calls
    assert torch.equal(prng.split(tk, 3), _k(_data(
        jax.vmap(lambda k: jax.random.split(k, 3))(jk))))
    assert torch.equal(prng.fold_in(tk, 2**20 + 1), _k(_data(
        jax.vmap(lambda k: jax.random.fold_in(k, 2**20 + 1))(jk))))
    # [E, B] keys, as the PPO update folds them
    e2 = tk.reshape(4, 6, words)
    assert torch.equal(prng.fold_in(e2, 9), _k(_data(jax.vmap(jax.vmap(
        lambda k: jax.random.fold_in(k, 9)))(jk.reshape(4, 6)))))
    # one key split into B lane keys, as the collector's rows do
    one = tk[5]
    assert torch.equal(prng.split(one, 16),
                       _k(_data(jax.random.split(jk[5], 16))))
    assert threefry2x32.plain_calls - plain0 == 4
    if words == 2:
        for shape in ((), (5,), (3, 7)):
            assert torch.equal(prng.random_bits(tk, shape), _k(jax.vmap(
                lambda k: jax.random.bits(k, shape))(jk)))
            assert np.array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.vmap(
                                      lambda k: jax.random.uniform(k, shape))(
                                      jk)))


def test_wrapper_refuses_what_it_cannot_run():
    key = prng.PRNGKey(3)
    with pytest.raises(ValueError, match="unsupported device"):
        threefry2x32(key.to("meta"), 2)
    with pytest.raises(ValueError, match="mode"):
        threefry2x32(prng.PRNGKey(3, impl="rbg"), 2, 0, "bits")
    with pytest.raises(ValueError, match="int64"):
        threefry2x32(key.to(torch.int32), 2)
    with pytest.raises(ValueError, match="out of range"):
        threefry2x32(key, 4, 2**63 - 2)
    assert threefry2x32(key, 0).shape == (0, 2)


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    for name in ("threefry.cu", "rbg_philox.cu", "prng_core.cuh"):
        shutil.copy(os.path.join(build.CSRC, name), tmp_path / name)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = {n: build._lib_path(n) for n in ("threefry", "rbg_philox")}
    with open(tmp_path / "prng_core.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build._lib_path(n) for n in ("threefry", "rbg_philox")}
    assert all(before[n] != after[n] for n in before)
    assert "threefry" in build.SOURCES
