"""Counter-based PRNG with the bits of `jax.random`.

A session's whole trajectory is a function of its key: the job sequence,
the time limit and every task-duration uniform come from `jax.random`
calls in the JAX package. To serve the same decisions from the same
seeds, this module reproduces jax 0.9.0's two generators the package
runs, bit for bit:

- `threefry2x32` (the default; 20 rounds) with `jax_threefry_partitionable`
  on, which makes `split` and `random_bits` hash a 64-bit iota counter
  (`kernels/threefry.py`: the kernel on the card, one launch for a
  split, a fold_in, a draw, or a call site's whole key chain through
  `derive`; its plain version on the CPU);
- `rbg`, which the trainer's `fast_prng: True` selects: a key of four
  words whose `split` and `fold_in` are threefry's applied to each 2-word
  half, and whose `random_bits` is Philox4x32-10 (`kernels/rbg.py`: the
  kernel on the card, its plain version on the CPU). Under `vmap`, which
  every batched draw of the JAX package runs in, JAX draws a batch of rbg
  keys as one stream of the batch's first key, so a draw here over a
  batch of rbg keys does the same.

A key is an int64 tensor of shape `[..., 2]` (threefry) or `[..., 4]`
(rbg) holding 32-bit words (torch's uint32 arithmetic is incomplete, so
every word lives in int64 and is masked back to 32 bits after each add or
shift); its trailing width is its impl, and every function dispatches on
it. `split_uniform` is the engine's split followed by a uniform draw
from the second keys, one launch on the card under either impl
(`kernels/rbg.py`). A CUDA key runs the kernels or raises; only a CPU
key runs the plain versions. All functions accept a batch of keys in the
leading dimensions. There is no process-wide default impl: whoever
creates a key names it (`PRNGKey`'s `impl` defaults to threefry2x32, the
JAX package's default). Every draw takes 32-bit words, the only width
the JAX package draws (float32 uniforms, int32 `randint`,
`permutation`'s sort keys).
"""

from __future__ import annotations

import math

import torch

from .kernels.rbg import rbg_random_bits, rbg_uniform, split_uniform
from .kernels.threefry import PATH_VAR, path_table, threefry2x32_ref
from .kernels.threefry import threefry2x32 as _threefry

_M32 = 0xFFFFFFFF
# impl name -> key width (the JAX package's `jax_default_prng_impl` names)
IMPL_WIDTH = {"threefry2x32": 2, "rbg": 4}
# the plain word hash, under its earlier name
threefry2x32 = threefry2x32_ref


def PRNGKey(seed: int, device: str | torch.device = "cpu",
            impl: str = "threefry2x32") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed under `impl`: words
    (0, seed) for threefry2x32, (0, seed, 0, seed) for rbg."""
    if impl not in IMPL_WIDTH:
        raise ValueError(f"unknown PRNG impl {impl!r} (have: "
                         f"{sorted(IMPL_WIDTH)})")
    half = [0, int(seed) & _M32]
    return torch.tensor(half * (IMPL_WIDTH[impl] // 2), dtype=torch.int64,
                        device=device)


def impl_of(key: torch.Tensor) -> str:
    """The impl of a key, by its trailing width."""
    for name, width in IMPL_WIDTH.items():
        if key.shape[-1] == width:
            return name
    raise ValueError(f"a key has 2 (threefry2x32) or 4 (rbg) words, not "
                     f"{key.shape[-1]}")


def _is_rbg(key: torch.Tensor) -> bool:
    return impl_of(key) == "rbg"


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` (an rbg key: threefry's on both
    2-word halves, in the same launch)."""
    return _threefry(key, 1, int(data) & _M32)[..., 0, :]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: shape `key.shape[:-1] + [num, W]`
    for keys of W words (an rbg key: threefry's on both 2-word halves,
    in the same launch)."""
    return _threefry(key, num)


def derive(roots: torch.Tensor, paths: torch.Tensor, var: int = 0
           ) -> torch.Tensor:
    """Every key a chain of `split` / `fold_in` makes from `roots`, in
    one launch: `fold_in(k, c)` and `split(k, n)[c]` are the same hop, so
    `split(fold_in(k, 5), 4)[2]` is k through the path (5, 2). `paths` is
    a table from `path_table` (each row one key's hops; PATH_VAR stands
    for `var`, a counter that changes per call, taken as fold_in takes
    its datum: its low 32 bits) on the roots' device. Shape
    `roots.shape[:-1] + paths.shape[:-1] + [W]`. Build a site's table
    once and keep it: the table is a device tensor."""
    return _threefry(roots, 1, int(var) & _M32, "pair", paths)[..., 0, :]


def random_bits(key: torch.Tensor, shape: tuple[int, ...] = ()
                ) -> torch.Tensor:
    """32 random bits per element (as int64), shape
    `key.shape[:-1] + shape` — `jax.random.bits` for uint32 (vmapped over
    the leading dimensions)."""
    if _is_rbg(key):
        return rbg_random_bits(key, shape)
    shape = tuple(int(d) for d in shape)
    bits = _threefry(key, math.prod(shape), 0, "bits")
    return bits.reshape(tuple(key.shape[:-1]) + shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32 on [0, 1)."""
    if _is_rbg(key):
        return rbg_uniform(key, shape)
    shape = tuple(int(d) for d in shape)
    u = _threefry(key, math.prod(shape), 0, "uniform")
    return u.reshape(tuple(key.shape[:-1]) + shape)


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
