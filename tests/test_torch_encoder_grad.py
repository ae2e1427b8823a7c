"""Gradients of the port's NodeEncoder against the JAX package.

- The plain backward (`decima_node_encoder_bwd_ref`, autograd through the
  plain forward), reached through `DecimaNodeEncoderFn` on CPU tensors,
  against `jax.grad` of the flax net, for a loss over
  `evaluate_actions`: every parameter's gradient within rtol 1e-4 /
  atol 1e-6, on real features, on a batch with edgeless items, on levels
  that are no topological order and at `num_levels` 3.
- The backward kernel's algorithm (`csrc/decima_encoder_bwd.cu`: two
  versions of each node, the reverse level sweep, the message gradients
  scattered to the version each child sent), replayed in PyTorch job by
  job, against the plain backward on the seeded stress cases of
  `make_case` within 1e-4 * max|ref| + 1e-6 — the tolerance the card
  holds the kernel to.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.schedulers.decima import DecimaAction as JaxAction
from sparksched_tpu.schedulers.decima import DecimaFeatures as JaxFeatures
from sparksched_tpu.schedulers.decima import evaluate_actions as jax_eval
from sparksched_tpu_torch.kernels.decima_encoder import (
    DecimaNodeEncoderFn,
    decima_node_encoder_bwd,
    decima_node_encoder_bwd_ref,
    edgeless_per_lane,
    encoder_params,
)
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax
from sparksched_tpu_torch.schedulers.decima import (
    DecimaAction,
    DecimaFeatures,
    evaluate_actions,
)

from ._torch_parity import CASES, make_case

N, J, S = 5, 6, 8
KW = dict(
    num_executors=N, embed_dim=8,
    gnn_mlp_kwargs={"hid_dims": [16, 8], "act_cls": "LeakyReLU",
                    "act_kwargs": {"negative_slope": 0.2}},
    policy_mlp_kwargs={"hid_dims": [16, 16], "act_cls": "Tanh"},
)
FIELDS = ("x", "node_mask", "job_mask", "stage_mask", "exec_mask", "adj",
          "node_level")


def _features(b: int, seed: int, case: str, edgeless_odd: bool):
    """Random [b]-item features whose NodeEncoder inputs come from
    `make_case` and whose masks and actions are consistent."""
    x, adj, lvl, mask = make_case(case, b, J, S, 5, seed)
    rng = np.random.default_rng(seed + 1)
    x = (np.abs(x) * 0.5).astype(np.float32)
    job_mask = mask.any(-1)
    job_mask[:, 0] = True
    mask[:, 0, 0] = True
    stage = mask & (rng.random(mask.shape) < 0.6)
    stage[:, 0, 0] = True
    exec_mask = (np.arange(N)[None, None] < rng.integers(1, N + 1, (b, J, 1))
                 ) & job_mask[..., None]
    if edgeless_odd:
        adj[1::2] = False
    f = dict(x=x, node_mask=mask, job_mask=job_mask, stage_mask=stage,
             exec_mask=exec_mask, adj=adj, node_level=lvl)
    # one stored action per item: a schedulable node, an allowed count
    flat = stage.reshape(b, -1)
    si = np.array([rng.choice(np.flatnonzero(r)) for r in flat], np.int32)
    job = (si // S).astype(np.int32)
    ne = np.array([rng.integers(0, exec_mask[i, job[i]].sum())
                   for i in range(b)], np.int32)
    si[-1] = -1  # an item that chose no stage
    return f, (si, job, ne)


def _pair(num_levels: int):
    js = JaxDecima(**KW, num_levels=num_levels)
    js.params = jax.tree_util.tree_map(lambda a: a * 0.3, js.params)
    ts = DecimaScheduler(**KW, num_levels=num_levels, device="cpu")
    ts.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    ts.net.requires_grad_(True)
    return js, ts


@pytest.mark.parametrize("case,edgeless_odd,num_levels", [
    ("dag", False, 0),
    ("dag", True, 0),
    ("random_levels", False, 0),
    ("masked_children", True, 3),
])
def test_loss_gradients_match_jax_grad(case, edgeless_odd, num_levels):
    b = 4
    f, (si, job, ne) = _features(b, 11, case, edgeless_odd)
    js, ts = _pair(num_levels)
    w_ent = 0.04

    def jloss(params):
        jf = JaxFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
        ja = JaxAction(stage_idx=jnp.asarray(si), job_idx=jnp.asarray(job),
                       num_exec=jnp.asarray(ne))
        lg, ent = jax.vmap(lambda ff, aa: jax_eval(
            *js.net.apply(params, ff), ff, aa, N))(jf, ja)
        return (lg * jnp.arange(1, b + 1)).sum() + w_ent * ent.sum()

    jg = jax.grad(jloss)(js.params)
    tf = DecimaFeatures(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in f.items()})
    ta = DecimaAction(torch.from_numpy(si), torch.from_numpy(job),
                      torch.from_numpy(ne))
    lg, ent = ts.evaluate_actions(tf, ta)
    loss = (lg * torch.arange(1, b + 1)).sum() + w_ent * ent.sum()
    ts.net.zero_grad()
    loss.backward()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: p.grad for k, p in ts.net.named_parameters()}
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # the values too: the Function's forward is the plain forward here
    jlg, jent = jax.vmap(lambda ff, aa: jax_eval(
        *js.net.apply(js.params, ff), ff, aa, N))(
        JaxFeatures(**{k: jnp.asarray(v) for k, v in f.items()}),
        JaxAction(stage_idx=jnp.asarray(si), job_idx=jnp.asarray(job),
                  num_exec=jnp.asarray(ne)))
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(jent),
                               rtol=1e-5, atol=1e-6)


def test_function_saves_inputs_and_uses_the_backward_wrapper():
    """Grad through `DecimaNet.encode` goes through `DecimaNodeEncoderFn`;
    without grad the plain forward wrapper runs, as when serving."""
    _, ts = _pair(0)
    f, _ = _features(2, 3, "dag", False)
    tf = DecimaFeatures(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in f.items()})
    h = ts.net.encode(tf)
    assert h.grad_fn is not None and "DecimaNodeEncoderFn" in type(
        h.grad_fn).__name__
    with torch.no_grad():
        h2 = ts.net.encode(tf)
    assert h2.grad_fn is None
    np.testing.assert_array_equal(h.detach().numpy(), h2.numpy())


# -------------------------------------------------------------------------
# the kernel's algorithm, replayed in PyTorch


def _mlp_fwd(layers, a, slope):
    pre = []
    for i, (w, b) in enumerate(layers):
        y = a @ w.T + b
        if i < len(layers) - 1:
            pre.append(y)
            a = torch.where(y >= 0, y, slope * y)
        else:
            a = y
    return a, pre


def _mlp_bwd(layers, inp, pre, g, gw, slope):
    """Manual backward of one MLP application (as `mlp_bwd`): adds the
    weight/bias gradients into gw (list of pairs), returns d input."""
    delta = g
    for i in range(len(layers) - 1, -1, -1):
        w, _ = layers[i]
        a = inp if i == 0 else torch.where(pre[i - 1] >= 0, pre[i - 1],
                                           slope * pre[i - 1])
        gw[i][0].add_(delta.T @ a)
        gw[i][1].add_(delta.sum(0))
        gin = delta @ w
        if i > 0:
            delta = gin * torch.where(pre[i - 1] >= 0, 1.0, slope)
    return gin


def _kernel_bwd_replay(x, adj, lvl, mask, w, num_levels, slope, g):
    """`decima_node_encoder_bwd_kernel`, job by job."""
    b, k, s, _ = x.shape
    nl = min(num_levels, s) if num_levels else s
    el_lane = edgeless_per_lane(adj)
    gws = [[[torch.zeros_like(wt), torch.zeros_like(bt)] for wt, bt in ls]
           for ls in (w.prep, w.msg, w.update)]
    gprep, gmsg, gupd = gws
    for i in range(b):
        for j in range(k):
            V = mask[i, j]
            if not bool(V.any()):
                continue
            xs, a, lv = x[i, j], adj[i, j], lvl[i, j]
            gj = torch.where(V[:, None], g[i, j], 0.0)
            hin, a_prep = _mlp_fwd(w.prep, xs, slope)
            if bool(el_lane[i]):
                _mlp_bwd(w.prep, xs, a_prep, gj, gprep, slope)
                continue
            hc = a.any(1)
            U = hc & (lv >= 0) & (lv < nl)
            u0, a_u0 = _mlp_fwd(w.update, hin, slope)
            h0 = torch.where(hc[:, None], 0.0, u0)
            m0, a_m0 = _mlp_fwd(w.msg, h0, slope)
            hf = torch.zeros_like(h0)
            mf = torch.zeros_like(h0)
            agg = torch.zeros_like(h0)
            saved = {}
            for lvl_ in range(nl - 1, -1, -1):
                P = U & (lv == lvl_)
                if not bool(P.any()):
                    continue
                fin = U & (lv > lvl_)
                msgs = torch.where(fin[:, None], mf, m0)
                agg[P] = (a.float() @ msgs)[P]
                u, a_uf = _mlp_fwd(w.update, agg[P], slope)
                hf[P] = hin[P] + u
                m, a_mf = _mlp_fwd(w.msg, hf[P], slope)
                mf[P] = m
                saved[lvl_] = (a_uf, a_mf)
            g_hf = torch.where(U[:, None], gj, 0.0)
            g_h0 = torch.where(U[:, None], 0.0, gj)
            g_hin = torch.zeros_like(h0)
            g_m0 = torch.zeros_like(h0)
            g_mf = torch.zeros_like(h0)
            for lvl_ in range(nl):
                P = U & (lv == lvl_)
                if not bool(P.any()):
                    continue
                a_uf, a_mf = saved[lvl_]
                g_hf[P] += _mlp_bwd(w.msg, hf[P], a_mf, g_mf[P], gmsg, slope)
                g_hin[P] += g_hf[P]
                g_agg = torch.zeros_like(h0)
                g_agg[P] = _mlp_bwd(w.update, agg[P], a_uf, g_hf[P], gupd,
                                    slope)
                fin = U & (lv > lvl_)
                scat = a.float().T @ (g_agg * P[:, None])
                g_mf += torch.where(fin[:, None], scat, 0.0)
                g_m0 += torch.where(fin[:, None], 0.0, scat)
            g_h0 += _mlp_bwd(w.msg, h0, a_m0, g_m0, gmsg, slope)
            g_h0 = torch.where(hc[:, None], 0.0, g_h0)
            g_hin += _mlp_bwd(w.update, hin, a_u0, g_h0, gupd, slope)
            _mlp_bwd(w.prep, xs, a_prep, g_hin, gprep, slope)
    return [t for ls in gws for pair in ls for t in pair]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("num_levels", [0, 3])
def test_kernel_algorithm_matches_plain_backward(case, num_levels):
    _, ts = _pair(num_levels)
    x, adj, lvl, mask = (torch.from_numpy(a) for a in
                         make_case(case, 3, 4, S, 5, seed=5))
    adj = adj.clone()
    adj[0] = False  # an edgeless item beside edged ones
    w = ts.net.encoder_weights()
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 4, S, 8)).astype(np.float32))
    ref = decima_node_encoder_bwd_ref(x, adj, lvl, mask, w, num_levels,
                                      ts.net.slope, g)
    # on a CPU tensor the wrapper is the plain version
    for a, b in zip(decima_node_encoder_bwd(x, adj, lvl, mask, w, num_levels,
                                            ts.net.slope, g), ref):
        assert torch.equal(a, b)
    with torch.no_grad():
        got = _kernel_bwd_replay(x, adj, lvl, mask, w, num_levels,
                                 ts.net.slope, g)
    for p, a, b in zip(encoder_params(w), got, ref):
        assert a.shape == p.shape
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol
    assert any(float(r.abs().max()) > 0 for r in ref)
