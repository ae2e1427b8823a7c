"""The port's CUDA kernel against its plain version on the card (needs
an NVIDIA card; skips elsewhere). Run there with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`--noconftest`: the suite's conftest imports JAX, which the card's
machine need not have)."""

from __future__ import annotations

import pytest
import torch

from sparksched_tpu_torch.kernels.decima_encoder import (
    decima_node_encoder,
    decima_node_encoder_ref,
    pack_weights,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layers(gen, dims, dev):
    return [(torch.randn(o, i, generator=gen).to(dev) * i ** -0.5,
             torch.randn(o, generator=gen).to(dev) * 0.1)
            for i, o in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("b,k,s", [(1, 1, 3), (3, 5, 20), (8, 32, 20)])
def test_kernel_matches_plain_version(card, b, k, s):
    gen = torch.Generator().manual_seed(b * 100 + k)
    d = 16
    x = torch.randn(b, k, s, 5, generator=gen).to(card)
    adj = torch.triu(torch.rand(b, k, s, s, generator=gen) < 0.2, 1)
    adj[0] = False  # lane 0 edgeless, the rest edged
    lvl = torch.zeros(b, k, s, dtype=torch.int32)
    for c in range(s):  # topological generation: 1 + deepest parent
        par = adj[..., :, c].float() * (lvl.float() + 1)
        lvl[..., c] = par.amax(-1).int()
    mask = torch.rand(b, k, s, generator=gen) < 0.9
    w = pack_weights(_layers(gen, [5, 32, 16, d], card),
                     _layers(gen, [d, 32, 16, d], card),
                     _layers(gen, [d, 32, 16, d], card))
    args = (w, 0, 0.2)
    ins = (x, adj.to(card), lvl.to(card), mask.to(card))
    before = decima_node_encoder.launches
    out = decima_node_encoder(*ins, *args)
    torch.cuda.synchronize()
    assert decima_node_encoder.launches == before + 1
    ref = decima_node_encoder_ref(*ins, *args)
    assert float((out - ref).abs().max()) <= 1e-5
