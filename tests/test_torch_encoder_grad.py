"""Gradients of the port's NodeEncoder against the JAX package.

- The plain backward (`decima_node_encoder_bwd_ref`, autograd through the
  plain forward), reached through `DecimaNodeEncoderFn` on CPU tensors,
  against `jax.grad` of the flax net, for a loss over
  `evaluate_actions`: every parameter's gradient within rtol 1e-4 /
  atol 1e-6, on real features, on a batch with edgeless items, on levels
  that are no topological order and at `num_levels` 3.
- The backward kernel's schedule (`csrc/decima_encoder_bwd.cu`: the
  live-job list, a warp per job taking slots w, w + W, ..., the row
  passes and the level steps with the two versions of each node and the
  reverse level sweep, the level rows recorded, each MLP's weight
  gradient taken once per job, the warps' accumulators summed in groups
  in a fixed order), replayed in PyTorch, against the plain backward on
  the seeded stress cases of `make_case` within 1e-4 * max|ref| + 1e-6 —
  the tolerance the card holds the kernel to — over several warp and
  group counts with live and dead jobs interleaved, and with a NaN in x
  on a masked row, whose NaN pattern must be the plain backward's.
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
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

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
# the kernel's schedule, replayed in PyTorch
#
# `decima_node_encoder_bwd_kernel` (csrc/decima_encoder_bwd.cu): the live
# jobs in job order; warp w of W takes the live slots w, w + W, ...; per
# job the row passes over all S rows (a lane per row: here a batch over
# rows), the level steps over their own rows, the level rows' inputs,
# pre-activations and deltas recorded; each MLP's weight gradient taken
# once per job over its S rows then its recorded level rows, added to the
# warp's accumulator; the accumulators summed in groups of `group` warps in
# warp order, then the groups in order.


def _act(z, slope):
    return torch.where(z >= 0, z, slope * z)


def _fwd(layers, a, slope):
    """An MLP's output and its layers' pre-activations (the last one is the
    output)."""
    pre = []
    for i, (w, b) in enumerate(layers):
        z = (a if i == 0 else _act(pre[-1], slope)) @ w.T + b
        pre.append(z)
    return pre[-1], pre


def _bwd(layers, inp, pre, g, slope):
    """The deltas of each layer (dL/d pre-activation) and the input
    gradient of one MLP application."""
    deltas = [None] * len(layers)
    delta = g
    for i in range(len(layers) - 1, -1, -1):
        deltas[i] = delta
        gin = delta @ layers[i][0]
        if i > 0:
            delta = gin * torch.where(pre[i - 1] >= 0, 1.0, slope)
    return deltas, gin


def _rows(layers, inp, pre, deltas, slope):
    """Per layer (input rows, delta rows) of one MLP application."""
    return [(inp if i == 0 else _act(pre[i - 1], slope), deltas[i])
            for i in range(len(layers))]


def _dw(dense, level):
    """A job's weight gradient of one MLP: per layer, the sum over the
    dense rows, then over the level rows in node order."""
    out = []
    for i, (a, d) in enumerate(dense):
        gw, gb = d.T @ a, d.sum(0)
        for rows in level:
            la, ld = rows[i]
            gw, gb = gw + ld.T @ la, gb + ld.sum(0)
        out += [gw, gb]
    return out


def _job_replay(xs, a, lv, valid, el, w, nl, slope, gj):
    """One warp's job: its (prep, msg, update) weight-gradient sums."""
    hc = a.any(1)
    gh = torch.where(valid[:, None], gj, 0.0)
    hin, p_prep = _fwd(w.prep, xs, slope)
    if el:  # prep alone carries the gradient
        d, _ = _bwd(w.prep, xs, p_prep, gh, slope)
        return (_dw(_rows(w.prep, xs, p_prep, d, slope), []),
                [torch.zeros_like(t) for ls in w.msg for t in ls],
                [torch.zeros_like(t) for ls in w.update for t in ls])
    U = hc & (lv >= 0) & (lv < nl)
    u0, _ = _fwd(w.update, hin, slope)
    hv = torch.where(hc[:, None], 0.0, u0)
    m, _ = _fwd(w.msg, hv, slope)
    levels = sorted({int(v) for v in lv[U]})
    rec_u, rec_m = {}, {}  # node -> (input, pre-activations), then deltas
    for lvl in reversed(levels):  # deepest first
        P = torch.nonzero(U & (lv == lvl)).reshape(-1)
        agg = a[P].float() @ m  # the children's current messages
        y, pre = _fwd(w.update, agg, slope)
        rec_u[lvl] = [P, agg, pre]
        hv = hv.clone()
        hv[P] = hin[P] + y
        if lvl >= 1:  # a level-0 node's msg(h_fin) is never read
            y, pre = _fwd(w.msg, hv[P], slope)
            rec_m[lvl] = [P, hv[P], pre]
            m = m.clone()
            m[P] = y
    gm = torch.zeros_like(m)
    for lvl in levels:  # the reverse sweep
        P, agg, pre = rec_u[lvl]
        if lvl >= 1:
            _, inp, pre_m = rec_m[lvl]
            d, gin = _bwd(w.msg, inp, pre_m, gm[P], slope)
            rec_m[lvl].append(d)
            gh = gh.clone()
            gh[P] = gh[P] + gin
            gm[P] = 0.0  # from now on the h0 messages' gradient
        d, gagg = _bwd(w.update, agg, pre, gh[P], slope)
        rec_u[lvl].append(d)
        gm = gm + a[P].float().T @ gagg  # scatter along the edges
    # the level rows in node order, per MLP
    lvl_u = sorted(((int(p), (agg[i:i + 1], [z[i:i + 1] for z in pre],
                              [t[i:i + 1] for t in d]))
                    for P, agg, pre, d in rec_u.values()
                    for i, p in enumerate(P.tolist())))
    lvl_m = sorted(((int(p), (inp[i:i + 1], [z[i:i + 1] for z in pre],
                              [t[i:i + 1] for t in d]))
                    for P, inp, pre, d in rec_m.values()
                    for i, p in enumerate(P.tolist())))

    def level_rows(layers, recs):
        return [_rows(layers, inp, pre, d, slope) for _, (inp, pre, d) in recs]

    h0 = torch.where(hc[:, None], 0.0, hv)
    _, pre = _fwd(w.msg, h0, slope)
    d, gin = _bwd(w.msg, h0, pre, gm, slope)
    g_msg = _dw(_rows(w.msg, h0, pre, d, slope), level_rows(w.msg, lvl_m))
    gh = torch.where(hc[:, None], gh, gh + gin)
    _, pre = _fwd(w.update, hin, slope)
    d, gin = _bwd(w.update, hin, pre, torch.where(hc[:, None], 0.0, gh),
                  slope)
    g_upd = _dw(_rows(w.update, hin, pre, d, slope),
                level_rows(w.update, lvl_u))
    g_hin = torch.where(U[:, None], gh, 0.0) + gin
    d, _ = _bwd(w.prep, xs, p_prep, g_hin, slope)
    return _dw(_rows(w.prep, xs, p_prep, d, slope), []), g_msg, g_upd


def _kernel_bwd_replay(x, adj, lvl, mask, w, num_levels, slope, g,
                       warps=8, group=2):
    """`decima_node_encoder_bwd` as the kernel schedules it, with `warps`
    warps and accumulators summed `group` at a time."""
    b, k, s, _ = x.shape
    nl = min(num_levels, s) if num_levels else s
    el_lane = edgeless_per_lane(adj)
    live = torch.nonzero(mask.reshape(b * k, s).any(1)).reshape(-1).tolist()
    zero = [torch.zeros_like(t) for t in encoder_params(w)]
    accs = []
    for wi in range(min(warps, len(live))):
        acc = list(zero)
        for slot in range(wi, len(live), warps):
            i, j = divmod(live[slot], k)
            parts = _job_replay(x[i, j], adj[i, j], lvl[i, j], mask[i, j],
                                bool(el_lane[i]), w, nl, slope, g[i, j])
            acc = [t + u for t, u in zip(acc, [t for p in parts for t in p])]
        accs.append(acc)
    total = list(zero)
    for g0 in range(0, max(len(accs), 1), group):
        part = list(zero)
        for acc in accs[g0:g0 + group]:
            part = [t + u for t, u in zip(part, acc)]
        total = [t + u for t, u in zip(total, part)]
    return total


def _case_inputs(case, b, k, seed):
    x, adj, lvl, mask = (torch.from_numpy(a) for a in
                         make_case(case, b, k, S, 5, seed=seed))
    adj = adj.clone()
    adj[0] = False  # an edgeless item beside edged ones
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, k, S, 8)).astype(np.float32))
    return x, adj, lvl, mask, g


def _assert_replay_close(got, ref, w):
    for p, a, b in zip(encoder_params(w), got, ref):
        assert a.shape == p.shape
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol
    assert any(float(r.abs().max()) > 0 for r in ref)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("num_levels", [0, 3])
def test_kernel_algorithm_matches_plain_backward(case, num_levels):
    _, ts = _pair(num_levels)
    x, adj, lvl, mask, g = _case_inputs(case, 3, 4, seed=5)
    w = ts.net.encoder_weights()
    ref = decima_node_encoder_bwd_ref(x, adj, lvl, mask, w, num_levels,
                                      ts.net.slope, g)
    # on a CPU tensor the wrapper is the plain version
    for a, b in zip(decima_node_encoder_bwd(x, adj, lvl, mask, w, num_levels,
                                            ts.net.slope, g), ref):
        assert torch.equal(a, b)
    with torch.no_grad():
        got = _kernel_bwd_replay(x, adj, lvl, mask, w, num_levels,
                                 ts.net.slope, g)
    _assert_replay_close(got, ref, w)


@pytest.mark.parametrize("warps,group", [(1, 1), (3, 2), (5, 2), (40, 3)])
def test_kernel_schedule_partitions_live_jobs(warps, group):
    """Live and dead jobs interleaved (every other job dead, an edgeless
    lane) over more live jobs than warps and more warps than one group:
    each warp takes several jobs, the groups split the warps; the sum in
    that order matches the plain backward, and dead jobs add exactly 0."""
    _, ts = _pair(3)
    x, adj, lvl, mask, g = _case_inputs("dead_jobs", 5, 6, seed=9)
    w = ts.net.encoder_weights()
    live = int(mask.reshape(30, S).any(1).sum())
    assert warps < live or warps > 2 * live
    ref = decima_node_encoder_bwd_ref(x, adj, lvl, mask, w, 3, ts.net.slope,
                                      g)
    with torch.no_grad():
        got = _kernel_bwd_replay(x, adj, lvl, mask, w, 3, ts.net.slope, g,
                                 warps=warps, group=group)
        # the dead jobs' inputs do not enter the sum at all
        dead = ~mask.any(-1)
        x2 = torch.where(dead[..., None, None], float("nan"), x)
        g2 = torch.where(dead[..., None, None], float("nan"), g)
        again = _kernel_bwd_replay(x2, adj, lvl, mask, w, 3, ts.net.slope,
                                   g2, warps=warps, group=group)
    _assert_replay_close(got, ref, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", CASES)
def test_kernel_schedule_nan_pattern_matches_plain_backward(case):
    """A NaN in x on a masked row of a live job on an edged lane: the NaN
    pattern of every gradient tensor is the plain backward's (0 x NaN is
    NaN; nothing is pruned by the mask or a zero delta)."""
    _, ts = _pair(0)
    x, adj, lvl, mask, g = _case_inputs(case, 3, 4, seed=5)
    mask = mask.clone()
    mask[1, 2, 3] = False
    assert bool(mask[1, 2].any()) and bool(adj[1].any())
    x = x.clone()
    x[1, 2, 3, 1] = float("nan")
    w = ts.net.encoder_weights()
    ref = decima_node_encoder_bwd_ref(x, adj, lvl, mask, w, 0, ts.net.slope,
                                      g)
    with torch.no_grad():
        got = _kernel_bwd_replay(x, adj, lvl, mask, w, 0, ts.net.slope, g)
    assert any(bool(torch.isnan(r).any()) for r in ref)
    assert any(bool(torch.isfinite(r).any()) for r in ref)
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
