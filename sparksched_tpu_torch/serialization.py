"""Flax-msgpack files without flax (counterpart of the parts of
`flax.serialization` the JAX package uses).

The JAX package writes model files and train states with
`flax.serialization.to_bytes`: the tree becomes nested dicts (keys
sorted, as `jax.tree_util` orders them), packed by msgpack with two
extension types, 1 for an ndarray and 3 for a numpy scalar, each the
msgpack of `(shape, dtype name, C-order bytes)`. This module carries its
own msgpack codec for that subset — maps, str, bin, int, float, bool,
nil, arrays and the two extensions — so the port reads and writes the
same bytes on a machine with neither flax nor msgpack. Integers take
the smallest encoding, as msgpack's packer does, so the bytes can match
flax's. Flax splits a leaf over 2^30 bytes into chunks
(`MAX_CHUNK_SIZE`); no Decima leaf comes near that, and a chunked leaf
is refused with an error rather than half-read.

`params_to_flax` turns the port's state dict into the JAX package's
parameter tree, the inverse of `schedulers.decima.params_from_flax`.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's leaf-chunking threshold, in bytes
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form up to `fix_max`, then the 8 (when
    `codes[0]` is set), 16 and 32-bit forms."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, C-order
    bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(x: Any, out: bytearray) -> None:
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif t is str:
        b = x.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif t in (bytes, bytearray, memoryview):
        b = bytes(x)
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif t in (list, tuple):
        _pack_len(len(x), out, 0x90, 15, (0, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(x), out, 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"cannot pack {t.__name__}")


def packb(x: Any) -> bytes:
    """msgpack bytes of `x` (str keys, str, bytes, int, float, bool, None,
    lists and tuples, numpy arrays and scalars as flax's extensions)."""
    out = bytearray()
    _pack(x, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _read(r: _Reader) -> Any:
    c = r.take(1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _read_map(r, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return [_read(r) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _FIXED:
        v = r.unpack(_FIXED[c])
        return float(v) if c in (0xCA, 0xCB) else int(v)
    if c in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return r.take(r.unpack(_LEN[1 << (c - 0xC4)]))
    if c in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return r.take(r.unpack(_LEN[1 << (c - 0xD9)])).decode("utf-8")
    if c in (0xDC, 0xDD):  # array 16/32
        n = r.unpack(_LEN[2 if c == 0xDC else 4])
        return [_read(r) for _ in range(n)]
    if c in (0xDE, 0xDF):  # map 16/32
        return _read_map(r, r.unpack(_LEN[2 if c == 0xDE else 4]))
    if 0xD4 <= c <= 0xD8:  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (c - 0xD4)))
    if c in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.unpack(_LEN[1 << (c - 0xC7)])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    """The object `packb` (or msgpack with flax's extensions) wrote."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return out


# ---------------------------------------------------------------------------
# flax's layout
# ---------------------------------------------------------------------------


def _sorted_tree(x: Any) -> Any:
    """Dicts with str keys in sorted order at every level (flax's
    `msgpack_serialize` rebuilds the tree through `jax.tree_util`, which
    sorts dict keys)."""
    if isinstance(x, dict):
        return {str(k): _sorted_tree(x[k]) for k in sorted(x, key=str)}
    if isinstance(x, np.ndarray) and x.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"a leaf of {x.nbytes} bytes would be chunked by "
                         "flax (over MAX_CHUNK_SIZE); chunked leaves are not "
                         "supported")
    return x


def to_bytes(tree: Any) -> bytes:
    """flax's `to_bytes` of a tree of nested dicts with numpy leaves."""
    return packb(_sorted_tree(tree))


def _check_unchunked(x: Any, path: str = "") -> None:
    if isinstance(x, dict):
        if _CHUNKED in x:
            raise ValueError(
                f"leaf {path or '/'} is a flax chunked array (a leaf over "
                f"{MAX_CHUNK_SIZE} bytes); chunked leaves are not supported")
        for k, v in x.items():
            _check_unchunked(v, f"{path}/{k}")


def from_bytes(data: bytes) -> Any:
    """flax's `msgpack_restore`: the nested dicts of numpy arrays (and
    scalars) that `to_bytes` wrote."""
    tree = unpackb(data)
    _check_unchunked(tree)
    return tree


def params_to_flax(state_dict: dict) -> dict:
    """The JAX package's parameter tree from the port's state dict (the
    inverse of `params_from_flax`): `mlp_x.dense_i.{weight,bias}` ->
    `{"params": {mlp_x: {dense_i: {kernel, bias}}}}` as float32 numpy,
    the weight transposed ([out,in] -> [in,out])."""
    tree: dict[str, dict] = {}
    for name, v in state_dict.items():
        mlp, dense, kind = name.split(".")
        a = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                       else v, np.float32)
        leaf = tree.setdefault(mlp, {}).setdefault(dense, {})
        if kind == "weight":
            leaf["kernel"] = np.ascontiguousarray(a.T)
        elif kind == "bias":
            leaf["bias"] = np.ascontiguousarray(a)
        else:
            raise ValueError(f"unexpected parameter {name!r}")
    return {"params": tree}
