"""Device-memory samples (counterpart of the runtime part of
`sparksched_tpu/obs/memory.py`: `device_memory_stats`)."""

from __future__ import annotations

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
