"""The fused bulk event pass: wrapper of `csrc/bulk_events.cu` and the
dispatch to its plain version.

`bulk_events_fused(params, bank, state, enabled, stop_at_limit,
max_events)` is `core._bulk_events_fused`: one maximal run of simple
events per lane, consumed in (time, seq) order, with the pass's
split-then-draw and every step's duration sample. On a CUDA state it is
one launch of the kernel (counted in `bulk_events_fused.launches`): no
`split_uniform` launch, no host sync. On a CPU state it runs the plain
version `core._bulk_events_fused_ref` (counted in
`bulk_events_fused.plain_calls`). Any other device, a dtype or shape
the kernel does not read (a bank of more than MAX_LEVELS executor
levels among them), or a non-contiguous field (but for `rng`'s rows)
raises. Both return `(state, k_rel[B], k_rdy[B])` with every
output bit-equal; the fields the pass does not write are the input's
own tensors, as `state.replace` leaves them.

`pack` lays the arguments out for the kernel's C entry point (one array
of tensor addresses in `engine_core.cuh`'s BULK_EVENTS_POINTERS order,
one of sizes); the tier-1 test hands the same arrays, on CPU tensors, to
a g++ build of `csrc/engine_core.cuh`.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

_COUNT_LOCK = threading.Lock()

_f32, _i32, _bool = torch.float32, torch.int32, torch.bool
# the EnvState fields the pass reads, in BULK_EVENTS_POINTERS order (after
# `rng` and `enabled`), with their dtypes and shapes: "b" [B], "j" [B,J],
# "s" [B,J,S], "a" [B,J,S,S], "n" [B,N]
_IN = (
    ("wall_time", _f32, "b"), ("time_limit", _f32, "b"),
    ("seq_counter", _i32, "b"), ("job_template", _i32, "j"),
    ("job_arrival_time", _f32, "j"), ("job_arrival_seq", _i32, "j"),
    ("job_arrived", _bool, "j"), ("job_saturated_stages", _i32, "j"),
    ("stage_exists", _bool, "s"), ("stage_num_tasks", _i32, "s"),
    ("stage_remaining", _i32, "s"), ("stage_executing", _i32, "s"),
    ("stage_completed_tasks", _i32, "s"), ("stage_duration", _f32, "s"),
    ("adj", _bool, "a"), ("exec_at_common", _bool, "n"),
    ("exec_job", _i32, "n"), ("exec_stage", _i32, "n"),
    ("exec_moving", _bool, "n"), ("exec_dst_job", _i32, "n"),
    ("exec_dst_stage", _i32, "n"), ("exec_arrive_time", _f32, "n"),
    ("exec_arrive_seq", _i32, "n"), ("exec_executing", _bool, "n"),
    ("exec_task_valid", _bool, "n"), ("exec_task_stage", _i32, "n"),
    ("exec_finish_time", _f32, "n"), ("exec_finish_seq", _i32, "n"),
    ("stage_sat", _bool, "s"), ("unsat_parent_count", _i32, "s"),
    ("incomplete_parent_count", _i32, "s"), ("commit_count", _i32, "s"),
    ("moving_count", _i32, "s"), ("source_valid", _bool, "b"),
    ("source_job", _i32, "b"), ("source_stage", _i32, "b"),
)
# the bank tensors, in order, with their dtypes (`dur` any of DUR_KINDS)
# and shapes: "t" [T,BS], "c" [T,BS,3,BL], "p" [T,BS,BL], "i" [BI],
# "d" [T,BS,3,BL,BK], "T" [T] (`dur_scale`, None but for int codes)
_BANK = (
    ("cnt", _i32, "c"), ("dur", None, "d"), ("level_present", _bool, "p"),
    ("max_present", _i32, "t"), ("rough_duration", _f32, "t"),
    ("itv_left_val", _i32, "i"), ("itv_right_val", _i32, "i"),
    ("itv_left_idx", _i32, "i"), ("itv_right_idx", _i32, "i"),
    ("dur_scale", _f32, "T"),
)
# the fields the pass writes, in order; then k_rel and k_rdy
OUT_FIELDS = (
    "rng", "wall_time", "seq_counter", "job_saturated_stages",
    "stage_remaining", "stage_executing", "stage_completed_tasks",
    "stage_duration", "exec_at_common", "exec_job", "exec_stage",
    "exec_moving", "exec_arrive_time", "exec_executing", "exec_task_valid",
    "exec_task_stage", "exec_finish_time", "exec_finish_seq", "stage_sat",
    "unsat_parent_count", "moving_count",
)
NUM_POINTERS = 2 + len(_IN) + len(_BANK) + len(OUT_FIELDS) + 2
NUM_DIMS = 13
DUR_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2,
             torch.int8: 3}
MAX_LEVELS = 32  # engine_core.cuh's kMaxLevels: a presence row is one word


def _need(name: str, t: torch.Tensor, dtype, shape, device,
          contiguous: bool = True) -> torch.Tensor:
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"bulk_events_fused: {name} is {t.dtype}, "
                         f"want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"bulk_events_fused: {name} is {tuple(t.shape)}, "
                         f"want {shape}")
    if t.device != device:
        raise ValueError(f"bulk_events_fused: {name} on {t.device}, the "
                         f"state on {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"bulk_events_fused: {name} is not contiguous")
    return t


def pack(params, bank, state, enabled: torch.Tensor,
         stop_at_limit: bool, max_events: int):
    """(outputs, pointer list, dims list, warmup delay) of one launch:
    the outputs allocated (uninitialised: the kernel writes every entry)
    and every tensor checked (dtype, shape, device, contiguity)."""
    dev = state.rng.device
    b, w = state.rng.shape
    n = state.exec_job.shape[1]
    j_cap, s_cap = state.stage_remaining.shape[1:]
    if w not in (2, 4):
        raise ValueError(f"bulk_events_fused: keys of {w} words")
    if state.rng.stride(1) != 1:
        raise ValueError("bulk_events_fused: rng's words are not adjacent")
    if bank.dur.dtype not in DUR_KINDS or bank.dur.dim() != 5:
        raise ValueError(f"bulk_events_fused: bank.dur is {bank.dur.dtype} "
                         f"{tuple(bank.dur.shape)}")
    t, bs, _, bl, bk = bank.dur.shape
    if bl > MAX_LEVELS:
        raise ValueError(f"bulk_events_fused: {bl} executor levels, the "
                         f"kernel reads at most {MAX_LEVELS}")
    if s_cap > bs:
        raise ValueError(f"bulk_events_fused: {s_cap} stage slots, the bank "
                         f"{bs}")
    bi = bank.itv_left_val.shape[0]
    shapes = {"b": (b,), "j": (b, j_cap), "s": (b, j_cap, s_cap),
              "a": (b, j_cap, s_cap, s_cap), "n": (b, n), "t": (t, bs),
              "c": (t, bs, 3, bl), "p": (t, bs, bl), "i": (bi,),
              "d": (t, bs, 3, bl, bk), "T": (t,)}
    # the keys are read through their row stride (`keys[:, 0]` of a
    # split is a view), every other tensor must be contiguous
    ins = [_need("rng", state.rng, torch.int64, (b, w), dev,
                 contiguous=False),
           _need("enabled", enabled, torch.bool, (b,), dev)]
    ins += [_need(f, getattr(state, f), dt, shapes[sh], dev)
            for f, dt, sh in _IN]
    for f, dt, sh in _BANK:
        x = getattr(bank, f)
        ins.append(None if x is None
                   else _need(f"bank.{f}", x, dt, shapes[sh], dev))
    outs = {f: torch.empty_like(getattr(state, f)) for f in OUT_FIELDS}
    outs["k_rel"] = torch.empty(b, dtype=torch.int32, device=dev)
    outs["k_rdy"] = torch.empty(b, dtype=torch.int32, device=dev)
    ptrs = [0 if x is None else x.data_ptr() for x in ins]
    ptrs += [x.data_ptr() for x in outs.values()]
    dims = [b, n, j_cap, s_cap, w, state.rng.stride(0), max_events + n,
            int(bool(stop_at_limit)), DUR_KINDS[bank.dur.dtype], bs, bl, bk,
            bi]
    return outs, ptrs, dims, float(params.warmup_delay)


def unpack(state, outs: dict):
    """(state, k_rel, k_rdy) from the kernel's outputs."""
    return (state.replace(**{f: outs[f] for f in OUT_FIELDS}),
            outs["k_rel"], outs["k_rdy"])


@functools.cache
def _launcher():
    """The C entry point of the built library, with its signature."""
    from .build import load

    lib = load("bulk_events")
    np_, nd = ctypes.c_int(), ctypes.c_int()
    lib.bulk_events_arg_counts(ctypes.byref(np_), ctypes.byref(nd))
    if (np_.value, nd.value) != (NUM_POINTERS, NUM_DIMS):
        raise RuntimeError(
            f"bulk_events.cu takes {np_.value} pointers and {nd.value} "
            f"sizes, the wrapper packs {NUM_POINTERS} and {NUM_DIMS}")
    fn = lib.bulk_events_fused_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def bulk_events_fused(params, bank, state, enabled: torch.Tensor,
                      stop_at_limit: bool = False, max_events: int = 8):
    """`core._bulk_events_fused`: one kernel launch on a CUDA state, the
    plain version on a CPU state (module docstring)."""
    dev = state.rng.device
    if dev.type == "cpu":
        from ..env.core import _bulk_events_fused_ref

        with _COUNT_LOCK:
            bulk_events_fused.plain_calls += 1
        return _bulk_events_fused_ref(params, bank, state, enabled,
                                      stop_at_limit=stop_at_limit,
                                      max_events=max_events)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs, ptrs, dims, warmup = pack(params, bank, state, enabled,
                                    stop_at_limit, max_events)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()((ctypes.c_int64 * NUM_POINTERS)(*ptrs),
                     (ctypes.c_int64 * NUM_DIMS)(*dims), warmup, stream)
    if rc != 0:
        raise RuntimeError(f"bulk_events_fused launch failed (rc={rc})")
    with _COUNT_LOCK:
        bulk_events_fused.launches += 1
    return unpack(state, outs)


bulk_events_fused.launches = 0
bulk_events_fused.plain_calls = 0
