"""Decima NodeEncoder: wrapper of the CUDA kernel and its plain version.

`decima_node_encoder` computes the GNN's level-wise message pass of
`sparksched_tpu/schedulers/decima.py` (`DecimaNet.__call__`, the
NodeEncoder part) for a batch of items `[B,K,...]` (B lanes, K jobs per
lane, S stages per job). On a CUDA tensor it launches the kernel of
`csrc/decima_encoder.cu` or raises; on a CPU tensor it runs the plain
version `decima_node_encoder_ref`. Both take the three MLPs as
`EncoderWeights`, packed once by `pack_weights` (the caller keeps them
until the weights change). The edgeless fallback is reduced per lane
over ALL of that lane's jobs, so it is computed here, before the
launch, and handed to the kernel (a job's warps see one job only): a call
on the card makes two launches, that reduction and the kernel.

`decima_node_encoder_bwd` is the gradient of the same function with
respect to the three MLPs' weights and biases, given the gradient of h:
the kernel of `csrc/decima_encoder_bwd.cu` on a CUDA tensor, autograd
through the plain version (`decima_node_encoder_bwd_ref`) on a CPU
tensor. `DecimaNodeEncoderFn` joins the two directions for autograd: its
forward runs the forward wrapper and saves only the inputs (the
recomputation `jax.checkpoint` gives the JAX package), its backward runs
the backward wrapper; x, adj and the masks take no gradient.

Under `compute_dtype="bfloat16"` the same function runs in bf16:
`decima_node_encoder_bf16` and `decima_node_encoder_bwd_bf16` take x
(and dL/dh) in bf16 and the weights packed as a bf16 copy
(`pack_weights(..., dtype=BF16)`), and launch the kernels of
`csrc/decima_encoder_bf16.cu` and `csrc/decima_encoder_bwd_bf16.cu`
(both over `csrc/encoder_bf16.cuh`) or, on a CPU tensor, the same plain
versions evaluated in bf16. Each wrapper takes only its own dtype and
keeps its own counters; the gradients are float32 either way.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

Layers = list[tuple[torch.Tensor, torch.Tensor]]  # [(weight [out,in], bias)]
BF16 = torch.bfloat16
# the compute dtypes of the kernels: float32, and bfloat16 (the JAX
# package's `compute_dtype="bfloat16"`)
DTYPES = (torch.float32, BF16)


def act_slope(slope: float, dtype: torch.dtype) -> float:
    """The LeakyReLU slope as an operand in `dtype`: under bfloat16 the
    JAX package multiplies by the slope rounded to bfloat16 (a Python
    float is weakly typed), 0.01 -> 0.010009765625."""
    if dtype == BF16:
        return float(torch.tensor(slope, dtype=BF16))
    return slope


def dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`h @ w.T + b` in h's dtype, the compute dtype: float32 weights
    are cast at use, and under bfloat16 the product and the bias sum are
    rounded apart, as flax's `Dense(dtype=)` computes them."""
    if w.dtype != h.dtype:
        w, b = w.to(h.dtype), b.to(h.dtype)
    return h @ w.T + b


def _mlp(layers: Layers, h: torch.Tensor, slope: float) -> torch.Tensor:
    """Dense layers (`dense`) with LeakyReLU between them, in h's
    dtype."""
    for i, (w, b) in enumerate(layers):
        h = dense(h, w, b)
        if i < len(layers) - 1:
            h = torch.where(h >= 0, h, slope * h)
    return h


def edgeless_per_lane(adj: torch.Tensor) -> torch.Tensor:
    """bool[B]: the lane's observation has no edge at all."""
    return ~adj.reshape(adj.shape[0], -1).any(1)


@dataclasses.dataclass(frozen=True)
class EncoderWeights:
    """The three NodeEncoder MLPs, as layers for the plain version and
    packed once into the kernel's layout (`pack_weights`)."""

    prep: Layers
    msg: Layers
    update: Layers
    packed: torch.Tensor  # each layer's W.T (in x out) then b, padded, in
    # the kernel's dtype (f32, or a bf16 copy for the bf16 kernels)
    spec: np.ndarray  # i32: per MLP (n, in[0..n-1], out[0..n-1])


def _spec(layers: Layers) -> list[int]:
    return ([len(layers)] + [int(w.shape[1]) for w, _ in layers]
            + [int(w.shape[0]) for w, _ in layers])


def pack_weights(prep: Layers, msg: Layers, update: Layers,
                 dtype: torch.dtype = torch.float32) -> EncoderWeights:
    """Check the MLPs' shapes and pack them for the kernel: each layer's
    W transposed (in x out, row-major, so that the lane computing output
    o reads word o of each input's row) then b, for prep, msg, update in
    that order, zero-padded to a multiple of 16 bytes (the kernels stage
    them 16 bytes at a time). The layers stay float32 (the parameters);
    the packed copy is in `dtype`, the kernel's: float32, or bfloat16 for
    the bf16 kernels (each weight rounded once, as the JAX package casts
    its float32 parameters at use). The packed tensor is a copy: pack
    again after the weights change."""
    if dtype not in DTYPES:
        raise ValueError(f"the kernels take {DTYPES}, not {dtype}")
    d = int(prep[-1][0].shape[0])
    for name, layers in (("mlp_msg", msg), ("mlp_update", update)):
        if int(layers[0][0].shape[1]) != d or int(layers[-1][0].shape[0]) != d:
            raise ValueError(f"{name} must map width {d} to {d}")
    dev = prep[0][0].device
    parts = []
    for layers in (prep, msg, update):
        if not 1 <= len(layers) <= 4:
            raise ValueError("the kernel takes MLPs of 1 to 4 layers")
        for w, b in layers:
            if w.device != dev or w.dtype != torch.float32:
                raise ValueError("weights must be float32 on one device")
            parts += [w.T.reshape(-1), b.reshape(-1)]
    pad = -sum(p.numel() for p in parts) % (16 // dtype.itemsize)
    parts.append(torch.zeros(pad, dtype=torch.float32, device=dev))
    spec = np.asarray(_spec(prep) + _spec(msg) + _spec(update), np.int32)
    return EncoderWeights(prep, msg, update,
                          torch.cat(parts).to(dtype).contiguous(), spec)


def decima_node_encoder_ref(x, adj, node_level, node_mask,
                            w: EncoderWeights, num_levels: int,
                            negative_slope: float) -> torch.Tensor:
    """Plain PyTorch NodeEncoder, op for op the JAX package's, in x's
    dtype (the compute dtype: under bfloat16 every Dense output, every
    activation, the aggregation and the update's sum rounded to bfloat16
    where the JAX package's bf16 `DecimaNet` rounds them).
    x f32|bf16[B,K,S,F], adj bool[B,K,S,S], node_level i32[B,K,S],
    node_mask bool[B,K,S] -> h [B,K,S,D] in x's dtype."""
    act = act_slope(negative_slope, x.dtype)
    h_init = _mlp(w.prep, x, act)
    adj_f = adj.to(h_init.dtype)
    has_child = adj.any(-1)
    h = torch.where(has_child[..., None], 0.0, _mlp(w.update, h_init, act))
    s_cap = x.shape[-2]
    nl = min(num_levels, s_cap) if num_levels else s_cap
    for lvl in range(nl - 1, -1, -1):
        agg = adj_f @ _mlp(w.msg, h, act)
        upd = (node_level == lvl) & has_child
        h = torch.where(upd[..., None], h_init + _mlp(w.update, agg, act), h)
    edgeless = edgeless_per_lane(adj)
    h = torch.where(edgeless[:, None, None, None], h_init, h)
    return torch.where(node_mask[..., None], h, 0.0)


def _check(x, adj, node_level, node_mask, w: EncoderWeights,
           dtype: torch.dtype = torch.float32) -> None:
    """The inputs as the kernel of compute dtype `dtype` takes them: x
    and the packed weights in `dtype`, on one device, contiguous."""
    b, k, s, f = x.shape
    want = {
        "x": (x, dtype, (b, k, s, f)),
        "adj": (adj, torch.bool, (b, k, s, s)),
        "node_level": (node_level, torch.int32, (b, k, s)),
        "node_mask": (node_mask, torch.bool, (b, k, s)),
    }
    for name, (t, dt, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dt} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if int(w.prep[0][0].shape[1]) != f:
        raise ValueError("mlp_prep input width != feature width")
    if w.packed.device != x.device:
        raise ValueError(f"weights are on {w.packed.device}, x on {x.device}")
    if w.packed.dtype != dtype:
        raise ValueError(f"weights packed as {w.packed.dtype}, the kernel "
                         f"takes {dtype}")


# the launch counters are bumped from the serving thread and from the
# online learner's thread (and autograd's) at once
_COUNT_LOCK = threading.Lock()


@functools.cache
def _launcher(lib: str = "decima_encoder"):
    """The C entry point of a built forward library (`decima_encoder`,
    `decima_encoder_bf16`), with its signature."""
    from .build import load

    fn = getattr(load(lib), lib.replace("decima_encoder",
                                        "decima_node_encoder") + "_launch")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                   ctypes.c_float, ctypes.POINTER(ci), vp]
    fn.restype = ci
    return fn


def _encode(wrapper, lib: str, dtype: torch.dtype, x, adj, node_level,
            node_mask, w: EncoderWeights, num_levels: int,
            negative_slope: float) -> torch.Tensor:
    """A forward wrapper's body: the plain version on a CPU tensor, the
    kernel of `lib` on a CUDA tensor, each counted on `wrapper`."""
    _check(x, adj, node_level, node_mask, w, dtype)
    if x.device.type == "cpu":
        with _COUNT_LOCK:
            wrapper.plain_calls += 1
        return decima_node_encoder_ref(
            x, adj, node_level, node_mask, w, num_levels, negative_slope,
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, k, s, f = x.shape
    if s > 32:
        raise ValueError(f"the kernel takes at most 32 stage slots, got {s}")
    fn = _launcher(lib)
    d = int(w.prep[-1][0].shape[0])
    s_nl = min(num_levels, s) if num_levels else s
    edgeless = edgeless_per_lane(adj).contiguous()
    spec_c = w.spec.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    out = torch.empty((b, k, s, d), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), adj.data_ptr(), node_level.data_ptr(),
            node_mask.data_ptr(), edgeless.data_ptr(), w.packed.data_ptr(),
            out.data_ptr(), b, k, s, f, d, s_nl,
            act_slope(float(negative_slope), dtype), spec_c, stream)
    if rc != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed (cudaGetLastError={rc})"
        )
    with _COUNT_LOCK:
        wrapper.launches += 1
    return out


def decima_node_encoder(x, adj, node_level, node_mask, w: EncoderWeights,
                        num_levels: int, negative_slope: float
                        ) -> torch.Tensor:
    """NodeEncoder of a batch of items in float32: the CUDA kernel on a
    CUDA tensor (one launch, counted in `decima_node_encoder.launches`),
    the plain version on a CPU tensor (counted in `.plain_calls`)."""
    return _encode(decima_node_encoder, "decima_encoder", torch.float32, x,
                   adj, node_level, node_mask, w, num_levels, negative_slope)


def decima_node_encoder_bf16(x, adj, node_level, node_mask,
                             w: EncoderWeights, num_levels: int,
                             negative_slope: float) -> torch.Tensor:
    """The NodeEncoder under `compute_dtype="bfloat16"`: x bf16 and the
    weights packed as bf16 (`pack_weights(..., dtype=BF16)`), h bf16. The
    kernel of `csrc/decima_encoder_bf16.cu` on a CUDA tensor (counted in
    `decima_node_encoder_bf16.launches`), the plain version in bf16 on a
    CPU tensor (`.plain_calls`). The slope is rounded to bf16 here."""
    return _encode(decima_node_encoder_bf16, "decima_encoder_bf16", BF16, x,
                   adj, node_level, node_mask, w, num_levels, negative_slope)


for _w in (decima_node_encoder, decima_node_encoder_bf16):
    _w.launches = _w.plain_calls = 0


def encoder_params(w: EncoderWeights) -> list[torch.Tensor]:
    """The layers' tensors in the packed order: per MLP (prep, msg,
    update), per layer, weight [out,in] then bias."""
    return [t for ls in (w.prep, w.msg, w.update) for pair in ls
            for t in pair]


def unpack_grad(w: EncoderWeights, g: torch.Tensor) -> list[torch.Tensor]:
    """A gradient in the packed layout (each layer's W.T then b) as
    tensors shaped like `encoder_params(w)`."""
    out, off = [], 0
    for layers in (w.prep, w.msg, w.update):
        for wt, b in layers:
            o, i = wt.shape
            out.append(g[off:off + i * o].view(i, o).t())
            off += i * o
            out.append(g[off:off + o])
            off += o
    return out


def decima_node_encoder_bwd_ref(x, adj, node_level, node_mask,
                                w: EncoderWeights, num_levels: int,
                                negative_slope: float, grad_h: torch.Tensor
                                ) -> list[torch.Tensor]:
    """Plain backward: autograd through `decima_node_encoder_ref`.
    Returns the gradients of `encoder_params(w)`, in that order."""
    params = [t.detach().requires_grad_(True) for t in encoder_params(w)]
    it = iter(params)
    layers = [[(next(it), next(it)) for _ in ls]
              for ls in (w.prep, w.msg, w.update)]
    wg = EncoderWeights(*layers, packed=w.packed, spec=w.spec)
    with torch.enable_grad():
        h = decima_node_encoder_ref(x, adj, node_level, node_mask, wg,
                                    num_levels, negative_slope)
        grads = torch.autograd.grad(h, params, grad_h, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


@functools.cache
def _bwd_launcher(lib: str = "decima_encoder_bwd"):
    """(scratch query, launch) of a built backward library
    (`decima_encoder_bwd`, `decima_encoder_bwd_bf16`)."""
    from .build import load

    dll = load(lib)
    name = lib.replace("decima_encoder", "decima_node_encoder")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    scratch = getattr(dll, name + "_scratch")
    scratch.argtypes = [ci] * 5 + [ctypes.POINTER(ci), ci,
                                   ctypes.POINTER(ctypes.c_longlong)]
    scratch.restype = ci
    fn = getattr(dll, name + "_launch")
    fn.argtypes = [vp] * 8 + [ctypes.c_longlong, vp] + [ci] * 6 + [
        ctypes.c_float, ctypes.POINTER(ci), ci, vp]
    fn.restype = ci
    return scratch, fn


def _encode_bwd(wrapper, lib: str, dtype: torch.dtype, x, adj, node_level,
                node_mask, w: EncoderWeights, num_levels: int,
                negative_slope: float, grad_h: torch.Tensor
                ) -> list[torch.Tensor]:
    """A backward wrapper's body: the plain version on a CPU tensor, the
    kernel of `lib` on a CUDA tensor, each counted on `wrapper`; grad_h in
    the compute dtype `dtype`, the gradients float32."""
    _check(x, adj, node_level, node_mask, w, dtype)
    b, k, s, f = x.shape
    d = int(w.prep[-1][0].shape[0])
    if (grad_h.dtype != dtype or tuple(grad_h.shape) != (b, k, s, d)
            or grad_h.device != x.device):
        raise ValueError(f"grad_h: want {dtype} {(b, k, s, d)} on "
                         f"{x.device}, got {grad_h.dtype} "
                         f"{tuple(grad_h.shape)} on {grad_h.device}")
    if x.device.type == "cpu":
        with _COUNT_LOCK:
            wrapper.plain_calls += 1
        return decima_node_encoder_bwd_ref(
            x, adj, node_level, node_mask, w, num_levels, negative_slope,
            grad_h,
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if s > 32:
        raise ValueError(f"the kernel takes at most 32 stage slots, got {s}")
    query, fn = _bwd_launcher(lib)
    grad_h = grad_h.contiguous()
    s_nl = min(num_levels, s) if num_levels else s
    edgeless = edgeless_per_lane(adj).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    spec_c = w.spec.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    nbytes = ctypes.c_longlong()
    if query(b, k, s, f, d, spec_c, sms, ctypes.byref(nbytes)) != 0:
        raise ValueError("the backward kernel does not take these widths")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
    grad = torch.empty(w.packed.numel(), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), adj.data_ptr(), node_level.data_ptr(),
            node_mask.data_ptr(), edgeless.data_ptr(), w.packed.data_ptr(),
            grad_h.data_ptr(), scratch.data_ptr(), nbytes.value,
            grad.data_ptr(), b, k, s, f, d, s_nl,
            act_slope(float(negative_slope), dtype), spec_c, sms, stream)
    if rc != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed (cudaGetLastError={rc})"
        )
    with _COUNT_LOCK:
        wrapper.launches += 1
    wrapper.scratch_bytes = nbytes.value
    return unpack_grad(w, grad)


def decima_node_encoder_bwd(x, adj, node_level, node_mask, w: EncoderWeights,
                            num_levels: int, negative_slope: float,
                            grad_h: torch.Tensor) -> list[torch.Tensor]:
    """Gradients of `encoder_params(w)` given dL/dh (float32): on a CUDA
    tensor the live-job list, the backward kernel and its fixed-order
    reductions (one call counted in `decima_node_encoder_bwd.launches`;
    the scratch it took, in bytes, in
    `decima_node_encoder_bwd.scratch_bytes`), the plain version on a CPU
    tensor (counted in `.plain_calls`)."""
    return _encode_bwd(decima_node_encoder_bwd, "decima_encoder_bwd",
                       torch.float32, x, adj, node_level, node_mask, w,
                       num_levels, negative_slope, grad_h)


def decima_node_encoder_bwd_bf16(x, adj, node_level, node_mask,
                                 w: EncoderWeights, num_levels: int,
                                 negative_slope: float, grad_h: torch.Tensor
                                 ) -> list[torch.Tensor]:
    """The gradient of `decima_node_encoder_bf16` (x, grad_h and the
    packed weights bf16; float32 gradients): the kernel of
    `csrc/decima_encoder_bwd_bf16.cu` on a CUDA tensor (counted in
    `decima_node_encoder_bwd_bf16.launches`, its scratch in
    `.scratch_bytes`), autograd through the bf16 plain version on a CPU
    tensor (`.plain_calls`)."""
    return _encode_bwd(decima_node_encoder_bwd_bf16, "decima_encoder_bwd_bf16",
                       BF16, x, adj, node_level, node_mask, w, num_levels,
                       negative_slope, grad_h)


for _w in (decima_node_encoder_bwd, decima_node_encoder_bwd_bf16):
    _w.launches = _w.plain_calls = _w.scratch_bytes = 0


class DecimaNodeEncoderFn(torch.autograd.Function):
    """The NodeEncoder for autograd: `apply(x, adj, node_level, node_mask,
    w, num_levels, negative_slope, *encoder_params(w))`, in x's dtype
    (float32, or bf16 through the bf16 wrappers). The forward
    launches the forward wrapper and saves only its inputs; the backward
    recomputes inside the backward wrapper (the kernel on the card, the
    plain version on the CPU) and returns the parameters' gradients."""

    @staticmethod
    def forward(ctx, x, adj, node_level, node_mask, w, num_levels,
                negative_slope, *params):
        ctx.save_for_backward(x, adj, node_level, node_mask)
        ctx.w, ctx.num_levels, ctx.slope = w, num_levels, negative_slope
        fn = decima_node_encoder_bf16 if x.dtype == BF16 else \
            decima_node_encoder
        return fn(x, adj, node_level, node_mask, w, num_levels,
                  negative_slope)

    @staticmethod
    def backward(ctx, grad_h):
        x, adj, node_level, node_mask = ctx.saved_tensors
        fn = decima_node_encoder_bwd_bf16 if x.dtype == BF16 else \
            decima_node_encoder_bwd
        grads = fn(x, adj, node_level, node_mask, ctx.w, ctx.num_levels,
                   ctx.slope, grad_h.contiguous())
        return (None,) * 7 + tuple(grads)
