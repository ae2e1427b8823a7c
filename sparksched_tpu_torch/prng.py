"""Counter-based PRNG with the bits of `jax.random`'s default.

A session's whole trajectory is a function of its key: the job sequence,
the time limit and every task-duration uniform come from `jax.random`
calls in the JAX package. To serve the same decisions from the same
seeds, this module reproduces jax 0.9.0's default generator bit for
bit: impl `threefry2x32` (20 rounds) with `jax_threefry_partitionable`
on, which makes `split` and `random_bits` hash a 64-bit iota counter.

A key is an int64 tensor of shape `[..., 2]` holding two 32-bit words
(torch's uint32 arithmetic is incomplete, so every word lives in int64
and is masked back to 32 bits after each add or shift). All functions
accept a batch of keys in the leading dimensions.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
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


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: words (0, seed)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def _hash(key: torch.Tensor, hi, lo) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash counters (hi, lo) (shape `[n]`) under every key of the batch:
    returns two words of shape `key.shape[:-1] + [n]`."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    return threefry2x32(k0, k1, hi, lo)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    d = torch.full((1,), int(data) & _M32, dtype=torch.int64,
                   device=key.device)
    a, b = _hash(key, zero, d)
    return torch.cat([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: shape `key.shape[:-1] + [num, 2]`."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = _hash(key, torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...] = ()
                ) -> torch.Tensor:
    """32 random bits per element (as int64), shape
    `key.shape[:-1] + shape` — `jax.random.bits` for uint32."""
    n = 1
    for d in shape:
        n *= int(d)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = lo >> 32
    a, b = _hash(key, hi, lo & _M32)
    return (a ^ b).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32 on [0, 1)."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def exponential(key: torch.Tensor, shape: tuple[int, ...] = ()
                ) -> torch.Tensor:
    """`jax.random.exponential(key, shape)` in float32: -log1p(-u).
    XLA's and torch's float32 `log1p` may differ in the last ulp."""
    return -torch.log1p(-uniform(key, shape))


def randint(key: torch.Tensor, shape: tuple[int, ...], minval, maxval
            ) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval, dtype=int32)` for
    bounds inside the int32 range: Python ints, or int tensors that
    broadcast against `key.shape[:-1] + shape` (per-key bounds, as a
    traced bound under vmap). A span of 0 or less returns `minval`."""
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    dev = key.device
    lo_b = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi_b = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = torch.where(hi_b <= lo_b, 1, (hi_b - lo_b) & _M32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (lo_b + off).to(torch.int32)


def _cumsum_f32(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """float32 prefix sum along the last axis with XLA's CPU association:
    sequential within blocks of 16, the block totals summed the same way
    (recursively), each block's exclusive prefix then added. `jnp.cumsum`
    lowers to a reduce-window that XLA rewrites into this form, so the
    bits match where `torch.cumsum` (double accumulation on the CPU, a
    tree on the card) would not."""
    n = x.shape[-1]

    def seq(v: torch.Tensor) -> torch.Tensor:
        cols = [v[..., 0]]
        for i in range(1, v.shape[-1]):
            cols.append(cols[-1] + v[..., i])
        return torch.stack(cols, -1)

    if n <= block:
        return seq(x)
    nb = -(-n // block)
    pad = torch.zeros(x.shape[:-1] + (nb * block - n,), dtype=x.dtype,
                      device=x.device)
    xb = torch.cat([x, pad], -1).reshape(x.shape[:-1] + (nb, block))
    inb = seq(xb)
    pre = _cumsum_f32(inb[..., -1], block)
    excl = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], -1)
    out = inb + excl[..., None]
    return out.reshape(x.shape[:-1] + (nb * block,))[..., :n]


def choice(key: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """`jax.random.choice(key, n, p=p)` (one draw with replacement, the
    default shape ()) per key: i32 of shape `key.shape[:-1]`. `p` is
    float32 `key.shape[:-1] + [n]`; the draw is the first index whose
    cumulative weight reaches `total * (1 - u)`."""
    if p.shape[-1] != n:
        raise ValueError(f"p has {p.shape[-1]} entries, not {n}")
    cum = _cumsum_f32(p.to(torch.float32))
    r = cum[..., -1:] * (1.0 - uniform(key)[..., None])
    return torch.searchsorted(cum.contiguous(), r.contiguous())[..., 0].to(
        torch.int32)


_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` in float32, jax's default mode
    "low": `-log(-log(u))` with `u = uniform(key, shape, tiny, 1)`. XLA's
    and torch's float32 `log` may differ in the last ulp."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # uniform(minval=tiny, maxval=1): floats * (1 - tiny) + tiny, where
    # 1 - tiny rounds to 1 in float32
    u = torch.clamp_min(floats * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis, one draw
    per key: `logits` is float32 `key.shape[:-1] + [n]`; returns int64 of
    shape `key.shape[:-1]` (Gumbel-max; ties go to the first index, as
    `jnp.argmax`)."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)` per key: int64 of shape
    `key.shape[:-1] + [n]`. jax sorts `arange(n)` by fresh 32-bit keys
    `ceil(3 ln n / ln(2^32 - 1))` times, each round on a new split of the
    key, with a stable sort; the bits are random_bits', the sort is
    `torch.sort(stable=True)` on the words as int64."""
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        tuple(key.shape[:-1]) + (n,))
    for _ in range(rounds):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)
        x = torch.gather(x, -1, order.indices)
    return x
