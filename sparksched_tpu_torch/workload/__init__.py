"""Workload factory and data-sampler registry (counterpart of
`sparksched_tpu/workload/__init__.py`)."""

from __future__ import annotations

import os.path as osp
from typing import Any, Callable

import torch

from ..config import resolve_device
from .bank import (  # noqa: F401
    BANK_DTYPES,
    EXEC_LEVEL_VALUES,
    NUM_EXEC_LEVELS,
    WorkloadBank,
    bank_dtype_label,
    load_tpch_templates,
    pack_bank,
    quantize_bank,
)
from .synthetic import make_templates  # noqa: F401


def _tpch_provider(
    *, num_executors: int, max_stages: int, bucket_size: int,
    data_dir: str, seed: int,
) -> list[dict[str, Any]]:
    """Real TPC-H traces when present on disk, else the synthetic bank."""
    if osp.isdir(data_dir):
        return load_tpch_templates(data_dir)
    return make_templates(seed=seed, bucket_size=bucket_size)


_DATA_SAMPLERS: dict[str, Callable[..., list[dict[str, Any]]]] = {
    "TPCHDataSampler": _tpch_provider,
}


def register_data_sampler(
    name: str, provider: Callable[..., list[dict[str, Any]]]
) -> None:
    """Register a custom workload provider selectable via the
    `data_sampler_cls` config string."""
    _DATA_SAMPLERS[name] = provider


def make_workload_bank(
    num_executors: int,
    max_stages: int = 20,
    bucket_size: int = 16,
    data_dir: str = "data/tpch",
    seed: int = 2024,
    data_sampler_cls: str | None = None,
    bank_dtype: str | None = None,
    device: str | torch.device = "cuda",
    **_: object,
) -> WorkloadBank:
    """Build the template bank through the provider registry, packed on
    `device` (the card unless the caller asks for the CPU). `bank_dtype`
    (an `env:` config key: "int16", "int8" or "bf16", default f32)
    narrows the duration table through `quantize_bank`."""
    dev = resolve_device(device)
    name = data_sampler_cls or "TPCHDataSampler"
    if name not in _DATA_SAMPLERS:
        raise ValueError(
            f"'{name}' is not a registered data sampler "
            f"(have: {sorted(_DATA_SAMPLERS)})"
        )
    templates = _DATA_SAMPLERS[name](
        num_executors=num_executors, max_stages=max_stages,
        bucket_size=bucket_size, data_dir=data_dir, seed=seed,
    )
    max_stages = max(max_stages, max(t["adj"].shape[0] for t in templates))
    bank = pack_bank(templates, num_executors, max_stages, bucket_size,
                     device=dev)
    if bank_dtype is not None:
        bank = quantize_bank(bank, bank_dtype)
    return bank


make_data_sampler = make_workload_bank
