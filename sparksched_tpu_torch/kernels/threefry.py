"""JAX's threefry2x32 key chain and draws: wrapper of the hash kernel and
its plain version.

`jax.random.split`, `fold_in` and (under the default impl) `bits` /
`uniform` all hash a 64-bit counter under each key with threefry2x32
(jax 0.9.0, `jax_threefry_partitionable` on: the counter c is the words
(c >> 32, c & 0xFFFFFFFF)): split's counters are 0..num-1, fold_in's the
one datum, random_bits' the flat iota over the draw's shape. An rbg key
(four words) splits and folds as threefry on each 2-word half.

`threefry2x32(keys, n, base, mode)` hashes counters base .. base + n - 1
under every key of `keys` ([..., W] int64 words, W = 2 or 4) and returns,
by `mode`:

- "pair": the two words, `keys.shape[:-1] + [n, W]` (an rbg key's halves
  side by side: split's layout under both impls);
- "bits": a ^ b, `keys.shape[:-1] + [n]` int64 (threefry keys only);
- "uniform": jax.random.uniform's float32 of those bits (threefry only).

On a CUDA key it launches `csrc/threefry.cu` (one launch, counted in
`threefry2x32.launches`) or raises; on a CPU key it runs the plain
version `threefry2x32_keys_ref` (counted in `threefry2x32.plain_calls`),
built on the word hash `threefry2x32_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
MODES = {"pair": 0, "bits": 1, "uniform": 2}

_COUNT_LOCK = threading.Lock()


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_ref(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                     x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 over broadcastable int64 words (jax's unrolled
    `_threefry2x32_lowering`)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform`'s float32 on [0, 1) from 32-bit words."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def threefry2x32_keys_ref(keys: torch.Tensor, n: int, base: int = 0,
                          mode: str = "pair") -> torch.Tensor:
    """The plain version of `threefry2x32`, in int64 torch ops."""
    w = keys.shape[-1]
    halves = keys.unflatten(-1, (w // 2, 2))  # [..., h, 2]
    c = base + torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32_ref(halves[..., 0:1], halves[..., 1:2], c >> 32,
                            c & _M32)  # [..., h, n]
    if mode == "pair":
        return torch.stack([a, b], -1).movedim(-3, -2).flatten(-2)
    bits = (a ^ b)[..., 0, :]
    return bits_to_uniform(bits) if mode == "uniform" else bits


@functools.cache
def _launcher():
    """The C entry point of the built library, with its signature."""
    from .build import load

    fn = load("threefry").threefry2x32_launch
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [vp, ll, ll, ctypes.c_int, ctypes.c_ulonglong, ll,
                   ctypes.c_int, vp, vp]
    fn.restype = ctypes.c_int
    return fn


def key_words(keys: torch.Tensor) -> int:
    """The words of each key (2 or 4); raises on anything else or on a
    dtype other than int64."""
    w = keys.shape[-1] if keys.dim() else 0
    if keys.dtype != torch.int64 or w not in (2, 4):
        raise ValueError(f"want int64 keys [..., 2] or [..., 4], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    return w


def flat_keys(keys: torch.Tensor) -> tuple[torch.Tensor, int]:
    """`keys` as [K, W] with adjacent words (a view where the strides
    allow, a copy otherwise) and its row stride in words."""
    w = keys.shape[-1]
    flat = keys.reshape(-1, w)
    if flat.stride(-1) != 1:
        flat = flat.contiguous()
    return flat, (flat.stride(0) if flat.shape[0] > 1 else w)


def threefry2x32(keys: torch.Tensor, n: int, base: int = 0,
                 mode: str = "pair") -> torch.Tensor:
    """Counters base .. base + n - 1 hashed under every key (module
    docstring): the kernel on a CUDA key, the plain version on a CPU
    key."""
    w = key_words(keys)
    if mode not in MODES or (w == 4 and mode != "pair"):
        raise ValueError(f"mode {mode!r} for keys of {w} words")
    n, base = int(n), int(base)
    if n < 0 or base < 0 or base + n > 2**63:
        raise ValueError(f"counters {base} + [0, {n}) out of range")
    if keys.device.type == "cpu":
        with _COUNT_LOCK:
            threefry2x32.plain_calls += 1
        return threefry2x32_keys_ref(keys, n, base, mode)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + ((n, w) if mode == "pair" else (n,)),
                      dtype=torch.float32 if mode == "uniform"
                      else torch.int64, device=keys.device)
    if out.numel() == 0:
        return out
    flat, stride = flat_keys(keys)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _launcher()(flat.data_ptr(), stride, flat.shape[0], w // 2, base,
                     n, MODES[mode], out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"threefry2x32 launch failed (rc={rc})")
    with _COUNT_LOCK:
        threefry2x32.launches += 1
    return out


threefry2x32.launches = 0
threefry2x32.plain_calls = 0
