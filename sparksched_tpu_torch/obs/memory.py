"""Device-memory samples and the serving hot-set model (counterpart of
`sparksched_tpu/obs/memory.py`: `device_memory_stats` and
`hot_set_fit`)."""

from __future__ import annotations

from typing import Any, Iterable

import torch


def device_memory_stats(device) -> dict[str, int] | None:
    """The caching allocator's `bytes_in_use` and `peak_bytes_in_use`
    (`torch.cuda.memory_stats`: allocated bytes, current and peak) of a
    CUDA device; None on the CPU, which reports no allocator stats."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0))}


def hot_set_fit(
    slot_leaves: Iterable[torch.Tensor],
    candidates: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048),
    *,
    budget_bytes: int,
    fixed_bytes: int = 0,
) -> dict[str, Any]:
    """Hot-set capacity model of the paged session store: how many
    device slots fit `budget_bytes`.

    `slot_leaves` are the tensors of ONE session's slot (a `LoopState`
    of one lane). The [H]-stacked slot store is the only store-sized
    buffer the serve programs keep resident, so bytes(H) = fixed + H x
    slot_bytes, with slot_bytes the leaves' `nbytes` (the card's
    allocations are dense: no tile padding, unlike the TPU model the JAX
    package uses). `fixed_bytes` carries the resident constants (the
    workload bank) and any working-set allowance the caller budgets.
    Monotone in H by construction.

    Returns `{budget_bytes, fixed_bytes, slot_bytes, max_hot_fit,
    candidates: [{hot, est_bytes, fits}]}`, the JAX package's keys."""
    slot = sum(int(t.numel()) * t.element_size() for t in slot_leaves)
    rows = []
    max_fit = 0
    for h in sorted(int(c) for c in candidates):
        est = int(fixed_bytes) + h * slot
        fits = est <= budget_bytes
        if fits:
            max_fit = max(max_fit, h)
        rows.append({"hot": h, "est_bytes": est, "fits": fits})
    return {
        "budget_bytes": int(budget_bytes),
        "fixed_bytes": int(fixed_bytes),
        "slot_bytes": slot,
        "max_hot_fit": max_fit,
        "candidates": rows,
    }
