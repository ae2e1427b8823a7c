"""The port's flax-msgpack codec (`sparksched_tpu_torch/serialization.py`)
against flax and msgpack, and the model files the port loads.

- `packb` / `unpackb` round-trip every type the JAX package's files use
  (maps, str, bin, ints of every width, floats, bool, nil, arrays, numpy
  arrays and scalars) and `packb`'s bytes equal `msgpack.packb` with
  flax's extension hook, byte for byte.
- All ten `models/decima/*.msgpack` decode to the same arrays as
  `flax.serialization.msgpack_restore`, and re-encode to the file's
  bytes.
- The port's bytes of a state dict load with `flax.serialization.
  from_bytes` into the JAX `DecimaScheduler`'s tree and equal flax's own
  `to_bytes` of the same arrays.
- A reference torch `.pt` state dict maps as the JAX package's
  `load_torch_state_dict` maps it; `DecimaScheduler(state_dict_path=)`
  loads both kinds and names the path.
- A flax chunked leaf is refused with a clear error.
"""

from __future__ import annotations

import glob
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization as fser

from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.schedulers.decima import load_torch_state_dict
from sparksched_tpu_torch import serialization as ser
from sparksched_tpu_torch.schedulers import (
    DecimaScheduler,
    load_state_dict_file,
    params_from_flax,
)

from ._torch_parity import MINI_AGENT
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = sorted(glob.glob(os.path.join(REPO, "models", "decima",
                                       "*.msgpack")))
FLAGSHIP_AGENT = dict(
    embed_dim=16,
    gnn_mlp_kwargs={"hid_dims": [32, 16], "act_cls": "LeakyReLU",
                    "act_kwargs": {"negative_slope": 0.2}},
    policy_mlp_kwargs={"hid_dims": [64, 64], "act_cls": "Tanh"},
)

VALUES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
             -2 ** 31 - 1, -2 ** 63],
    "floats": [0.0, -1.5, 1e300, float("inf")],
    "flags": [True, False, None],
    "strs": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "ü" * 40000],
    "bins": [b"", b"a" * 255, b"b" * 256, b"c" * 70000],
    "nested": {"a": [1, [2, {"b": None}]], "c": {}},
    "map16": {f"k{i}": i for i in range(20)},
    "list16": list(range(20)),
    "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
               "i32": np.array([-1, 2**31 - 1], np.int32),
               "u32": np.array([2**32 - 1, 7], np.uint32),
               "bool": np.array([[True, False]]),
               "f64_0d": np.zeros((), np.float64),
               "empty": np.zeros((0, 3), np.float32)},
    "scalars": [np.float32(2.5), np.int32(-7), np.uint32(9)],
}


def _assert_same(a, b) -> None:
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        assert type(a) is type(b) and a == b


def test_codec_round_trip_and_msgpack_bytes():
    data = ser.packb(VALUES)
    assert data == msgpack.packb(VALUES, default=fser._msgpack_ext_pack,
                                 strict_types=True)
    _assert_same(VALUES, ser.unpackb(data))
    ref = msgpack.unpackb(data, ext_hook=fser._msgpack_ext_unpack,
                          raw=False)
    _assert_same(ref, ser.unpackb(data))
    # flax's layout: keys sorted at every level
    assert ser.to_bytes(VALUES) == fser.msgpack_serialize(dict(VALUES))
    with pytest.raises(ValueError, match="trailing"):
        ser.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        ser.unpackb(data[:-3])


@pytest.mark.parametrize("path", MODELS, ids=os.path.basename)
def test_model_files_load_as_flax_loads_them(path):
    data = open(path, "rb").read()
    got, want = ser.from_bytes(data), fser.msgpack_restore(data)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # through the port's state dict and back: the file's bytes
    assert ser.to_bytes(ser.params_to_flax(params_from_flax(got))) == data


def test_port_bytes_load_in_flax_and_equal_flax_bytes():
    js = JaxDecima(num_executors=6, **MINI_AGENT)
    ts = DecimaScheduler(6, seed=3, device="cpu", **MINI_AGENT)
    tree = ser.params_to_flax(ts.params)
    data = ser.to_bytes(tree)
    restored = fser.from_bytes(js.params, data)
    assert params_from_flax(jax.tree_util.tree_map(np.asarray, restored)
                            ).keys() == ts.params.keys()
    for k, v in params_from_flax(jax.tree_util.tree_map(
            np.asarray, restored)).items():
        assert torch.equal(v, ts.params[k]), k
    flax_tree = jax.tree_util.tree_map(
        lambda t, a: np.asarray(a, np.float32), js.params, tree)
    assert data == fser.to_bytes(flax_tree)


def _reference_state_dict(seed: int) -> dict:
    """A reference-style torch checkpoint of the flagship net: each MLP a
    `Sequential` with its Linear layers at even indices (activations
    between), random values."""
    from sparksched_tpu_torch.schedulers.decima import _TORCH_TO_PORT

    to_ref = {v: k for k, v in _TORCH_TO_PORT.items()}
    g = torch.Generator().manual_seed(seed)
    shapes = DecimaScheduler(10, device="cpu", **FLAGSHIP_AGENT).params
    sd = {}
    for name, v in shapes.items():
        mlp, dense, kind = name.split(".")
        li = int(dense.split("_")[1])
        sd[f"{to_ref[mlp]}.{2 * li}.{kind}"] = torch.randn(v.shape,
                                                           generator=g)
    return sd


def test_torch_checkpoint_maps_as_jax_maps_it(tmp_path):
    path = str(tmp_path / "model.pt")
    torch.save(_reference_state_dict(5), path)
    js = JaxDecima(num_executors=10, **FLAGSHIP_AGENT)
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, load_torch_state_dict(path, js.params)))
    got = load_state_dict_file(path)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ts = DecimaScheduler(10, state_dict_path=path, device="cpu",
                         **FLAGSHIP_AGENT)
    assert ts.name == f"Decima:{path}"
    for k, v in ts.params.items():
        assert torch.equal(v, want[k]), k


def test_scheduler_loads_a_model_file_by_path():
    path = os.path.join(REPO, "models", "decima", "model_tpu.msgpack")
    ts = DecimaScheduler(10, state_dict_path=path, device="cpu",
                         **FLAGSHIP_AGENT)
    js = JaxDecima(num_executors=10, state_dict_path=path, **FLAGSHIP_AGENT)
    assert ts.name == js.name == f"Decima:{path}"
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    for k, v in ts.params.items():
        assert torch.equal(v, want[k]), k


def test_chunked_leaf_is_refused():
    data = ser.packb({"w": {"__msgpack_chunked_array__": True,
                            "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        ser.from_bytes(data)
