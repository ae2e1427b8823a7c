"""JAX's `rbg` random bits: wrapper of the Philox kernel and its plain
version.

Under `jax_default_prng_impl = "rbg"` a key is four 32-bit words and
`random_bits` is `lax.rng_bit_generator`, which XLA lowers to
Philox4x32-10: the key words (k0, k1) are the Philox key, block i's
128-bit counter is the little-endian words (k2, k3, k0, k1) plus i (with
carry), each block gives 4 words in order, cut to the count. Under
`vmap` (every batched draw of the JAX package) the generator's batching
rule draws ONE stream from the batch's first key over (batch..., shape):
lane b of a batch of B keys gets words [b*n, (b+1)*n) of the first key's
stream, whatever its own key. Both functions here follow that: they take
keys `[..., 4]` (int64 words, the port's convention) and return
`keys.shape[:-1] + shape`.

`rbg_random_bits` / `rbg_uniform` launch `csrc/rbg_philox.cu` on a CUDA
key (one launch, counted in `rbg_random_bits.launches`) or raise; on a
CPU key they run the plain version `rbg_bits_ref` (counted in
`rbg_random_bits.plain_calls`). They serve the draws that follow no
split: the policy's Gumbel, `randint`, `permutation`, the reset.

`split_uniform(keys, shape)` is the engine's split-then-draw in one
launch of the same source, under either impl: for lane keys `[..., W]`
it returns `(split(keys)[..., 0, :], uniform(split(keys)[..., 1, :],
shape))` -- under rbg the uniforms are the Philox stream of the FIRST
lane's second key (the vmapped draw), under threefry each lane's second
key hashes its own iota. On a CUDA key one launch (counted in
`split_uniform.launches`) or an error; on a CPU key the plain version
`split_uniform_ref`, `split` then `uniform` through the plain functions
(counted in `split_uniform.plain_calls`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from .threefry import (
    bits_to_uniform,
    flat_keys,
    key_words,
    threefry2x32_keys_ref,
)

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

_COUNT_LOCK = threading.Lock()


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product m * c for 32-bit words c in
    int64: c split into 16-bit halves so that no product leaves the int64
    range."""
    lo_part = m * (c & _M16)  # < 2^48
    hi_part = m * (c >> 16)  # < 2^48
    s = hi_part + (lo_part >> 16)
    return s >> 16, ((s & _M16) << 16) | (lo_part & _M16)


def rbg_bits_ref(key: torch.Tensor, n: int) -> torch.Tensor:
    """The first `n` words (int64) of the Philox stream of `key`'s first
    key (`key` is `[..., 4]`), in plain torch int64 arithmetic."""
    k = key.reshape(-1, 4)[0].to(torch.int64)
    k0, k1, k2, k3 = (k[i] for i in range(4))
    blk = torch.arange(-(-n // 4), dtype=torch.int64, device=key.device)
    # 128-bit counter (k2, k3, k0, k1) + blk with carry across the words
    w = k2 + blk
    c0, carry = w & _M32, w >> 32
    w = k3 + carry
    c1, carry = w & _M32, w >> 32
    w = k0 + carry
    c2, carry = w & _M32, w >> 32
    c3 = (k1 + carry) & _M32
    a0, a1 = k0, k1
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ a0, lo1, hi0 ^ c3 ^ a1, lo0
        a0 = (a0 + _PHILOX_W[0]) & _M32
        a1 = (a1 + _PHILOX_W[1]) & _M32
    return torch.stack([c0, c1, c2, c3], -1).reshape(-1)[:n]


@functools.cache
def _launcher():
    """The C entry point of the built library, with its signature."""
    from .build import load

    fn = load("rbg_philox").rbg_random_bits_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _split_uniform_launcher():
    from .build import load

    fn = load("rbg_philox").split_uniform_launch
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [vp, ll, ll, ctypes.c_int, ll, vp, vp, vp]
    fn.restype = ctypes.c_int
    return fn


def _draw(keys: torch.Tensor, shape: tuple[int, ...], uniform: bool
          ) -> torch.Tensor:
    if keys.shape[-1] != 4 or keys.dtype != torch.int64:
        raise ValueError(f"want int64 rbg keys [..., 4], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    out_shape = tuple(keys.shape[:-1]) + tuple(int(d) for d in shape)
    n = math.prod(out_shape)
    if keys.device.type == "cpu":
        with _COUNT_LOCK:
            rbg_random_bits.plain_calls += 1
        bits = rbg_bits_ref(keys, n)
        return (bits_to_uniform(bits) if uniform else bits).reshape(out_shape)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    out = torch.empty(out_shape, device=keys.device,
                      dtype=torch.float32 if uniform else torch.int64)
    if n == 0:
        return out
    # the kernel reads the first key's 4 words from the card: in place
    # when they are adjacent (no copy, no host sync)
    first = (keys if keys.stride(-1) == 1
             else keys.reshape(-1, 4)[:1].contiguous())
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _launcher()(first.data_ptr(), out.data_ptr(), n, int(uniform),
                     stream)
    if rc != 0:
        raise RuntimeError(f"rbg_random_bits launch failed (rc={rc})")
    with _COUNT_LOCK:
        rbg_random_bits.launches += 1
    return out


def rbg_random_bits(keys: torch.Tensor, shape: tuple[int, ...] = ()
                    ) -> torch.Tensor:
    """32-bit words (int64) of shape `keys.shape[:-1] + shape`: the kernel
    on a CUDA key, the plain version on a CPU key."""
    return _draw(keys, shape, uniform=False)


def rbg_uniform(keys: torch.Tensor, shape: tuple[int, ...] = ()
                ) -> torch.Tensor:
    """`jax.random.uniform` float32 of shape `keys.shape[:-1] + shape`
    from the same words: the kernel's uniform mode on a CUDA key (one
    launch, counted with the bits'), the plain version on a CPU key."""
    return _draw(keys, shape, uniform=True)


def split_uniform_ref(keys: torch.Tensor, shape: tuple[int, ...]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `split_uniform`: the plain split, then the
    plain draw from the second keys."""
    pairs = threefry2x32_keys_ref(keys, 2)  # [..., 2, W]
    nxt, sub = pairs[..., 0, :], pairs[..., 1, :]
    out_shape = tuple(keys.shape[:-1]) + tuple(int(d) for d in shape)
    n = math.prod(tuple(int(d) for d in shape))
    if keys.shape[-1] == 4:
        total = math.prod(out_shape)
        u = (bits_to_uniform(rbg_bits_ref(sub, total)) if total
             else torch.empty(0, dtype=torch.float32, device=keys.device))
    else:
        u = threefry2x32_keys_ref(sub, n, 0, "uniform")
    return nxt, u.reshape(out_shape)


def split_uniform(keys: torch.Tensor, shape: tuple[int, ...] = ()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(next keys `keys.shape`, float32 uniforms `keys.shape[:-1] +
    shape`): `keys2 = split(keys); (keys2[..., 0, :],
    uniform(keys2[..., 1, :], shape))` (module docstring), one launch on
    a CUDA key under either impl, the plain version on a CPU key."""
    w = key_words(keys)
    shape = tuple(int(d) for d in shape)
    if keys.device.type == "cpu":
        with _COUNT_LOCK:
            split_uniform.plain_calls += 1
        return split_uniform_ref(keys, shape)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    lead = tuple(keys.shape[:-1])
    nxt = torch.empty(lead + (w,), dtype=torch.int64, device=keys.device)
    u = torch.empty(lead + shape, dtype=torch.float32, device=keys.device)
    if nxt.numel() == 0:
        return nxt, u
    flat, stride = flat_keys(keys)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _split_uniform_launcher()(flat.data_ptr(), stride, flat.shape[0],
                                   int(w == 4), math.prod(shape),
                                   nxt.data_ptr(), u.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"split_uniform launch failed (rc={rc})")
    with _COUNT_LOCK:
        split_uniform.launches += 1
    return nxt, u


rbg_random_bits.launches = 0
rbg_random_bits.plain_calls = 0
split_uniform.launches = 0
split_uniform.plain_calls = 0

