"""JAX's threefry2x32 key chain and draws: wrapper of the path kernel and
its plain version.

`jax.random.split`, `fold_in` and (under the default impl) `bits` /
`uniform` all hash a 64-bit counter under each key with threefry2x32
(jax 0.9.0, `jax_threefry_partitionable` on: the counter c is the words
(c >> 32, c & 0xFFFFFFFF)): split's counters are 0..num-1, fold_in's the
one datum, random_bits' the flat iota over the draw's shape. So every
derived key is a root hashed through a path of counters: `fold_in(
split(k, 4)[1], b)` is k through (1, b). An rbg key (four words) splits
and folds as threefry on each 2-word half.

A path table is an int64 tensor `[..., D]` (`path_table`): each row the
counters of one path's hops, `PATH_VAR` for the call's one varying
counter (`base`), padded with `PATH_END`. `threefry2x32(keys, n, base,
mode, paths)` hashes every key of `keys` ([..., W] int64 words, W = 2 or
4) through every path, the last hop at its counter + 0 .. n - 1, and
returns, by `mode`:

- "pair": the two words, `keys.shape[:-1] + paths.shape[:-1] + [n, W]`
  (an rbg key's halves side by side: split's layout under both impls);
- "bits": a ^ b, `keys.shape[:-1] + paths.shape[:-1] + [n]` int64
  (threefry keys only);
- "uniform": jax.random.uniform's float32 of those bits (threefry only).

Without `paths` the table is the one path (`PATH_VAR`,) of shape [1]:
counters base .. base + n - 1 under each key, a plain split, fold_in or
draw (`keys.shape[:-1] + [n, W]`).

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
# path table entries (csrc/prng_core.cuh): a counter >= 0, the call's
# varying counter, or the end of a shorter path
PATH_END = -1
PATH_VAR = -2
MAX_DEPTH = 8

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


def path_table(rows, device, shape: tuple[int, ...] | None = None
               ) -> torch.Tensor:
    """An int64 path table on `device` from `rows`, one sequence of hops
    per path (counters in [0, 2^32), the fold_in and split range, or
    PATH_VAR), padded with PATH_END to the longest: [P, D], or
    `shape + [D]`. Raises on a path of no hop or of more than MAX_DEPTH
    hops, and on any other entry."""
    rows = [tuple(int(c) for c in r) for r in rows]
    depth = max((len(r) for r in rows), default=1)
    if any(not 1 <= len(r) <= MAX_DEPTH for r in rows):
        raise ValueError(f"a path has 1 to {MAX_DEPTH} hops")
    if any(not (0 <= c < 2**32 or c == PATH_VAR) for r in rows for c in r):
        raise ValueError("a hop's counter lies in [0, 2^32) or is PATH_VAR")
    table = torch.tensor([r + (PATH_END,) * (depth - len(r)) for r in rows],
                         dtype=torch.int64).reshape(-1, depth)
    if shape is not None:
        table = table.reshape(tuple(shape) + (depth,))
    return table.to(device)


@functools.lru_cache(maxsize=None)
def _var_path(device: torch.device) -> torch.Tensor:
    """The one path (PATH_VAR,): a plain split, fold_in or draw."""
    return path_table([(PATH_VAR,)], device)[0]


def threefry2x32_keys_ref(keys: torch.Tensor, n: int, base: int = 0,
                          mode: str = "pair",
                          paths: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of `threefry2x32`, in int64 torch ops: every
    path's hops but the last on all of its rows at once (a row past its
    own hops keeps its key), then the last hop at n counters."""
    if paths is None:
        paths = _var_path(keys.device)
    w = keys.shape[-1]
    lead, pshape, depth = keys.shape[:-1], paths.shape[:-1], paths.shape[-1]
    rows = paths.reshape(-1, depth)
    live = ((rows >= 0) | (rows == PATH_VAR)).long().cumprod(-1)
    hops = live.sum(-1)  # [P]
    c = torch.where(rows == PATH_VAR, base, rows)
    halves = keys.reshape(-1, w // 2, 2)  # [R, h, 2]
    shape = (halves.shape[0], rows.shape[0], w // 2)
    k0 = halves[:, None, :, 0].expand(shape)  # [R, P, h]
    k1 = halves[:, None, :, 1].expand(shape)
    for d in range(depth - 1):
        mid = (d < hops - 1)[None, :, None]
        cd = c[None, :, d, None]
        a, b = threefry2x32_ref(k0, k1, cd >> 32, cd & _M32)
        k0, k1 = torch.where(mid, a, k0), torch.where(mid, b, k1)
    last = c.gather(-1, (hops - 1).clamp_min(0)[:, None])  # [P, 1]
    cl = (last + torch.arange(n, dtype=torch.int64, device=keys.device))[
        None, :, None, :]  # [1, P, 1, n]
    a, b = threefry2x32_ref(k0[..., None], k1[..., None], cl >> 32,
                            cl & _M32)  # [R, P, h, n]
    has = (hops > 0)[None, :, None, None]
    a = torch.where(has, a, k0[..., None])
    b = torch.where(has, b, k1[..., None])
    if mode == "pair":
        out = torch.stack([a, b], -1).movedim(-3, -2).flatten(-2)
        return out.reshape(lead + pshape + (n, w))
    bits = (a ^ b)[:, :, 0, :].reshape(lead + pshape + (n,))
    return bits_to_uniform(bits) if mode == "uniform" else bits


@functools.cache
def _launcher():
    """The C entry point of the built library, with its signature."""
    from .build import load

    fn = load("threefry").threefry2x32_launch
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    ci = ctypes.c_int
    fn.argtypes = [vp, ll, ll, ci, vp, ci, ll, ctypes.c_ulonglong, ll, ci,
                   vp, vp]
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
                 mode: str = "pair",
                 paths: torch.Tensor | None = None) -> torch.Tensor:
    """Every key through every path of `paths`, the last hop at n
    counters, `base` the value of PATH_VAR (module docstring): the
    kernel on a CUDA key, the plain version on a CPU key. The table lies
    on the keys' device; one built by `path_table` holds only valid
    entries, and the kernel reads any entry it does not know as an end."""
    w = key_words(keys)
    if mode not in MODES or (w == 4 and mode != "pair"):
        raise ValueError(f"mode {mode!r} for keys of {w} words")
    n, base = int(n), int(base)
    if n < 0 or base < 0 or base + n > 2**63:
        raise ValueError(f"counters {base} + [0, {n}) out of range")
    if paths is None:
        paths = _var_path(keys.device)
    elif (paths.dtype != torch.int64 or paths.dim() < 1
          or not 1 <= paths.shape[-1] <= MAX_DEPTH
          or paths.device != keys.device):
        raise ValueError(f"want an int64 path table [..., 1..{MAX_DEPTH}] "
                         f"on {keys.device}, got {paths.dtype} "
                         f"{tuple(paths.shape)} on {paths.device}")
    if keys.device.type == "cpu":
        with _COUNT_LOCK:
            threefry2x32.plain_calls += 1
        return threefry2x32_keys_ref(keys, n, base, mode, paths)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    lead = tuple(keys.shape[:-1]) + tuple(paths.shape[:-1])
    out = torch.empty(lead + ((n, w) if mode == "pair" else (n,)),
                      dtype=torch.float32 if mode == "uniform"
                      else torch.int64, device=keys.device)
    if out.numel() == 0:
        return out
    flat, stride = flat_keys(keys)
    rows = paths.reshape(-1, paths.shape[-1])
    if not rows.is_contiguous():
        rows = rows.contiguous()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _launcher()(flat.data_ptr(), stride, flat.shape[0], w // 2,
                     rows.data_ptr(), rows.shape[1], rows.shape[0], base, n,
                     MODES[mode], out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"threefry2x32 launch failed (rc={rc})")
    with _COUNT_LOCK:
        threefry2x32.launches += 1
    return out


threefry2x32.launches = 0
threefry2x32.plain_calls = 0
