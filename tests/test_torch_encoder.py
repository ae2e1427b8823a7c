"""The NodeEncoder kernel's surroundings on the CPU.

- The plain version `decima_node_encoder_ref`, which is the kernel's
  yardstick on the card, against the flax NodeEncoder of the JAX package
  on the seeded adversarial inputs of `make_case` (`_torch_parity.py`:
  levels that are no topological order, edges into nodes outside
  node_mask, jobs with no valid node but with edges, a truncated
  `num_levels`), with the weights carried across by `params_from_flax`,
  within rtol 1e-4 / atol 1e-5 (the tolerance of `test_torch_decima.py`).
- The kernel's transposed weight layout read back into the layers.
- The kernel's schedule — which rows of which MLP it computes, and in
  what order — replayed in plain PyTorch on the same inputs, every row
  it does not compute left NaN, against the plain version within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.schedulers.decima import DecimaFeatures
from sparksched_tpu_torch.kernels.decima_encoder import (
    _mlp,
    decima_node_encoder,
    decima_node_encoder_ref,
)
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax

from ._torch_parity import CASES, jax_h_node, make_case
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

N = 10
B, K, S, F = 3, 5, 20, 5
KW = dict(  # the flagship's NodeEncoder widths (config/decima_tpch.yaml)
    num_executors=N, embed_dim=16,
    gnn_mlp_kwargs={"hid_dims": [32, 16], "act_cls": "LeakyReLU",
                    "act_kwargs": {"negative_slope": 0.2}},
)


def _pair(num_levels: int):
    js = JaxDecima(**KW, num_levels=num_levels)
    ts = DecimaScheduler(**KW, num_levels=num_levels, device="cpu")
    ts.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           js.params)))
    return js, ts


@pytest.mark.parametrize("num_levels", [0, 3])
@pytest.mark.parametrize("case", CASES)
def test_encoder_ref_matches_flax_on_adversarial_inputs(case, num_levels):
    x, adj, lvl, mask = make_case(case, B, K, S, F, seed=CASES.index(case))
    adj[0] = False  # lane 0 edgeless beside edged lanes
    assert adj[1:].any() and int(lvl.max()) > 3  # deeper than num_levels 3
    js, ts = _pair(num_levels)
    jf = DecimaFeatures(
        x=jnp.asarray(x), node_mask=jnp.asarray(mask),
        job_mask=jnp.asarray(mask.any(-1)),
        stage_mask=jnp.zeros(mask.shape, bool),
        exec_mask=jnp.ones((B, K, N), bool),
        adj=jnp.asarray(adj), node_level=jnp.asarray(lvl),
    )
    ins = [torch.from_numpy(a) for a in (x, adj, lvl, mask)]
    args = (ts.net.encoder_weights(), num_levels, ts.net.slope)
    got = decima_node_encoder_ref(*ins, *args).numpy()
    np.testing.assert_allclose(got, jax_h_node(js, jf), rtol=1e-4, atol=1e-5)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(decima_node_encoder(*ins, *args).numpy(),
                                  got)


def test_packed_weights_read_back_into_the_layers():
    """`pack_weights` lays each layer out as W.T (in x out, row-major)
    then b, prep, msg, update in turn, padded with zeros to a multiple of
    4 floats; `spec` gives each MLP's (n, in[...], out[...])."""
    _, ts = _pair(0)
    w = ts.net.encoder_weights()
    flat, spec = w.packed.numpy(), list(w.spec)
    assert flat.size % 4 == 0
    off = 0
    for layers in (w.prep, w.msg, w.update):
        n = spec.pop(0)
        ins, outs = spec[:n], spec[n:2 * n]
        del spec[:2 * n]
        assert n == len(layers)
        for (wt, b), i, o in zip(layers, ins, outs):
            np.testing.assert_array_equal(
                flat[off:off + i * o].reshape(i, o), wt.numpy().T)
            np.testing.assert_array_equal(
                flat[off + i * o:off + i * o + o], b.numpy())
            off += i * o + o
    assert not spec
    assert flat.size - off < 4 and not flat[off:].any()


def _kernel_schedule(x, adj, lvl, mask, w, num_levels, slope):
    """`csrc/decima_encoder.cu`'s schedule of each job in plain PyTorch:
    prep on the rows that are output or feed an update; h0 on the leaves
    that are output or send a message before their parent's update; the
    first messages from h0; then per level with work, deepest first, the
    aggregation and update of that level's nodes and the messages of
    those that a shallower parent reads. Rows it does not compute are
    NaN, so a row read before it is written shows in the output."""
    b, k, s, _ = x.shape
    d = int(w.prep[-1][0].shape[0])
    nl = min(num_levels, s) if num_levels else s
    out = torch.zeros(b, k, s, d)
    for bi in range(b):
        edgeless = not bool(adj[bi].any())
        for ki in range(k):
            v, a, ml = mask[bi, ki], adj[bi, ki], lvl[bi, ki]
            if not v.any():
                continue
            h_init, h, m = (torch.full((s, d), float("nan")) for _ in range(3))
            if edgeless:
                h_init[v] = _mlp(w.prep, x[bi, ki][v], slope)
                out[bi, ki] = torch.where(v[:, None], h_init, 0.0)
                continue
            has = a.any(1)
            upd = has & (ml >= 0) & (ml < nl)
            # who reads m[c]: a parent updated at a level >= c's (or any
            # updated parent, if c is never updated) before c's update,
            # one at a lower level after it
            reads = a & upd[:, None]  # [q, c]
            early = reads & ((ml[:, None] >= ml[None, :]) | ~upd[None, :])
            before, after = early.any(0), (reads & ~early).any(0)
            todo = upd & (v | after)
            rows = v | todo | (before & ~has)
            h_init[rows] = _mlp(w.prep, x[bi, ki][rows], slope)
            h[has] = 0.0
            r = ~has & (v | before)
            h[r] = _mlp(w.update, h_init[r], slope)
            m[before] = _mlp(w.msg, h[before], slope)
            for lv in sorted(set(ml[upd].tolist()), reverse=True):
                p = todo & (ml == lv)
                if not p.any():
                    continue
                agg = torch.stack([m[a[q]].sum(0) for q in p.nonzero()[:, 0]])
                h[p] = h_init[p] + _mlp(w.update, agg, slope)
                m[p & after] = _mlp(w.msg, h[p & after], slope)
            out[bi, ki] = torch.where(v[:, None], h, 0.0)
    return out


@pytest.mark.parametrize("num_levels", [0, 3])
@pytest.mark.parametrize("case", CASES)
def test_kernel_schedule_matches_plain_version(case, num_levels):
    x, adj, lvl, mask = (torch.from_numpy(a) for a in
                         make_case(case, B, K, S, F, seed=10 + CASES.index(case)))
    adj[0] = False  # lane 0 edgeless beside edged lanes
    _, ts = _pair(num_levels)
    w, slope = ts.net.encoder_weights(), ts.net.slope
    got = _kernel_schedule(x, adj, lvl, mask, w, num_levels, slope)
    want = decima_node_encoder_ref(x, adj, lvl, mask, w, num_levels, slope)
    assert not got.isnan().any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
