"""Shared helpers of the PyTorch-port parity tests (`test_torch_*.py`):
the same inputs go through the JAX package and the port, and the leaves
are compared as numpy arrays. Also the seeded NodeEncoder inputs of
`make_case`, which `chip_smoke.py` loads from this file by path."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import pytest
import torch

from sparksched_tpu_torch.env import flat_loop as tfl


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for a test module that imports this fixture.

    The suite's workers share the box's cores with each other and with
    XLA's compiler threads. There torch's intra-op threads, spinning at
    every parallel region of these small tensors, cost several times the
    single-threaded time (a mini training iteration: 7.6 s on one
    thread, 51 s on eight, with the cores busy). The process's count
    comes back after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_leaves(ls) -> list[np.ndarray]:
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(ls)]


def jax_h_node(js, jf) -> np.ndarray:
    """h_node of a JAX `DecimaScheduler`'s flax net on features `jf`: the
    NodeEncoder output, read off the input of `mlp_dag` (concat[x,
    h_node])."""
    import flax.linen as fnn

    seen = {}

    def icpt(next_fun, args, kwargs, context):
        if context.module.name == "mlp_dag" and context.method_name == "__call__":
            seen["h"] = np.asarray(args[0][..., 5:])
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(icpt):
        js.net.apply(js.params, jf)
    return seen["h"]


def port_leaves(ls, lane: int | None = 0) -> list[tuple[str, np.ndarray]]:
    """(name, numpy) of one lane of a port LoopState (every lane, with the
    lane axis, for `lane=None`); the rng words come back as uint32 like
    the JAX key."""
    out = []
    for name, v in tfl.leaves(ls):
        a = (v if lane is None else v[lane]).cpu().numpy()
        if name == "rng":
            a = a.astype(np.uint32)
        out.append((name, a))
    return out


def mismatched_leaves(jl, pl, rtol: float) -> list[str]:
    """Names of the leaves that differ: integer and bool leaves must be
    equal, float leaves equal up to `rtol` (0 = bit-equal) with the same
    infinities and NaNs."""
    assert len(jl) == len(pl), (len(jl), len(pl))
    bad = []
    for a, (name, b) in zip(jl, pl):
        if a.shape != b.shape:
            bad.append(name)
        elif a.dtype.kind == "f":
            inf = np.isinf(a)
            ok = (np.array_equal(np.isnan(a), np.isnan(b))
                  and np.array_equal(inf, np.isinf(b))
                  and np.array_equal(a[inf], b[inf]))
            fin = np.isfinite(a)
            if ok and rtol:
                ok = np.allclose(a[fin], b[fin], rtol=rtol, atol=0)
            elif ok:
                ok = np.array_equal(a[fin], b[fin])
            if not ok:
                bad.append(name)
        elif not (a == b).all():
            bad.append(name)
    return bad


def fixture_templates(spec) -> list[dict]:
    """The workload templates `reference_fixtures.make_tpu_env_state`
    packs for a spec (one template per job, constant durations)."""
    from sparksched_tpu_torch.workload.bank import EXEC_LEVEL_VALUES

    templates = []
    for jspec in spec["jobs"]:
        s_n = jspec["adj"].shape[0]
        durations = {}
        for s in range(s_n):
            durations[s] = {
                "fresh_durations": {
                    lv: [jspec["fresh"][s]] for lv in EXEC_LEVEL_VALUES
                },
                "first_wave": {
                    lv: [jspec["first"][s]] for lv in EXEC_LEVEL_VALUES
                },
                "rest_wave": {
                    lv: [jspec["rest"][s]] for lv in EXEC_LEVEL_VALUES
                },
            }
        templates.append(
            {"adj": jspec["adj"], "num_tasks": np.array(jspec["num_tasks"]),
             "durations": durations}
        )
    return templates


def port_fixture_state(spec, num_executors: int):
    """(params, bank, LoopState) of the port for a reference fixture
    spec: the counterpart of `reference_fixtures.make_tpu_env_state`."""
    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.env.core import reset_from_sequence
    from sparksched_tpu_torch.workload.bank import pack_bank

    templates = fixture_templates(spec)
    max_stages = max(t["adj"].shape[0] for t in templates)
    params = EnvParams(
        num_executors=num_executors, max_jobs=len(spec["jobs"]),
        max_stages=max_stages, max_levels=max_stages,
    )
    bank = pack_bank(templates, num_executors, max_stages, bucket_size=1,
                     device="cpu")
    j_cap = params.max_jobs
    arrivals = np.full(j_cap, np.inf, dtype=np.float32)
    arrivals[: len(spec["arrivals"])] = spec["arrivals"]
    mask = np.isfinite(arrivals)
    state = reset_from_sequence(
        params, bank, prng.PRNGKey(0)[None],
        torch.tensor([np.inf], dtype=torch.float32),
        torch.from_numpy(arrivals)[None],
        torch.arange(j_cap, dtype=torch.int32)[None],
        torch.tensor([int(mask.sum())], dtype=torch.int32),
        torch.from_numpy(mask)[None],
    )
    return params, bank, tfl.init_loop_state(state)


def port_from_jax(jls):
    """The port LoopState holding the same values as a JAX LoopState with
    a leading lane axis (leaf for leaf, in the JAX pytree's order; the
    rng words as int64)."""
    import dataclasses

    import jax

    from sparksched_tpu_torch.env.state import EnvState

    env_names = [f.name for f in dataclasses.fields(EnvState)]
    loop_names = [f.name for f in dataclasses.fields(tfl.LoopState)
                  if f.name != "env"]
    vals = [np.asarray(x) for x in jax.tree_util.tree_leaves(jls)]
    assert len(vals) == len(env_names) + len(loop_names)
    ts = {}
    for name, a in zip(env_names + loop_names, vals):
        if name == "rng":
            a = a.astype(np.int64)
        ts[name] = torch.from_numpy(np.ascontiguousarray(a))
    env = EnvState(**{k: ts[k] for k in env_names})
    return tfl.LoopState(env=env, **{k: ts[k] for k in loop_names})


def jax_env_from_port(env):
    """The JAX EnvState holding the same values as a port EnvState (lane
    axis kept; the rng words as uint32)."""
    import dataclasses

    import jax.numpy as jnp

    from sparksched_tpu.env.state import EnvState as JaxEnvState

    vals = {}
    for f in dataclasses.fields(env):
        a = getattr(env, f.name).cpu().numpy()
        if f.name == "rng":
            a = a.astype(np.uint32)
        vals[f.name] = jnp.asarray(a)
    return JaxEnvState(**vals)


# -------------------------------------------------------------------------
# Seeded NodeEncoder inputs that stress the kernel's bookkeeping.
#
# `make_case(name, b, k, s, f, seed)` returns numpy arrays `x f32[b,k,s,f]`,
# `adj bool[b,k,s,s]`, `node_level i32[b,k,s]` and `node_mask bool[b,k,s]`
# for the checks of `decima_node_encoder` against its plain version
# (`chip_smoke.py` on the card, `tests/test_torch_cuda.py`) and of the
# plain version against the JAX package (`tests/test_torch_encoder.py`).
# `adj[p, c]` is an edge from parent p to child c, as in the features.
#
# - ``dag``: random DAG edges (parent index below child), levels the
#   topological generation (1 + deepest parent), every node valid but a
#   few at the end — the shape of real features.
# - ``random_levels``: random edges in both directions, self loops
#   included, and levels drawn at random from 0 to S (S is the padding
#   level), so the levels are no topological order.
# - ``masked_children``: a DAG whose node_mask is false on about half of
#   the nodes that have a parent: edges into nodes outside node_mask.
# - ``dead_jobs``: a DAG where every other job's node_mask row is all
#   false while its edges stay.

CASES = ("dag", "random_levels", "masked_children", "dead_jobs")


def _dag(rng, b, k, s, density):
    adj = np.triu(rng.random((b, k, s, s)) < density, 1)
    lvl = np.zeros((b, k, s), np.int32)
    for c in range(s):  # 1 + deepest parent
        par = np.where(adj[..., :, c], lvl + 1, 0)
        lvl[..., c] = par.max(-1)
    return adj, lvl


def make_case(name: str, b: int, k: int, s: int, f: int, seed: int):
    """(x, adj, node_level, node_mask) as numpy arrays for case `name`."""
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}; known: {CASES}")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k, s, f)).astype(np.float32)
    mask = np.ones((b, k, s), bool)
    mask[..., s - max(1, s // 5):] = rng.random((b, k, max(1, s // 5))) < 0.5
    if name == "random_levels":
        adj = rng.random((b, k, s, s)) < 0.15
        lvl = rng.integers(0, s + 1, (b, k, s)).astype(np.int32)
        return x, adj, lvl, mask
    adj, lvl = _dag(rng, b, k, s, 0.2)
    if name == "masked_children":
        has_parent = adj.any(-2)
        mask &= ~(has_parent & (rng.random((b, k, s)) < 0.5))
    elif name == "dead_jobs":
        mask[:, 1::2] = False
    return x, adj, lvl, mask


def _weights64(w):
    from sparksched_tpu_torch.kernels.decima_encoder import EncoderWeights

    return EncoderWeights(*([(a.double(), b.double()) for a, b in ls]
                            for ls in (w.prep, w.msg, w.update)),
                          packed=w.packed, spec=w.spec)


def fwd_ref64(x, adj, lvl, mask, w, num_levels, slope):
    """The NodeEncoder's plain forward evaluated in float64 (x and the
    weights cast): the reference the forward kernel is held to on the
    card at training's weights, whose outputs reach the hundreds, where
    a float32 ulp is 1e-5 and both float32 versions round apart."""
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder_ref,
    )

    return decima_node_encoder_ref(x.double(), adj, lvl, mask, _weights64(w),
                                   num_levels, slope)


def bwd_ref64(x, adj, lvl, mask, w, num_levels, slope, g, lanes=None):
    """The NodeEncoder's plain backward evaluated in float64 (x, weights
    and dL/dh cast): the reference the backward kernel is held to on the
    card, where the float32 plain backward can stray further from exact
    than the kernel at thousands of jobs. With `lanes`, evaluated that
    many items at a time and summed (the items are independent: the
    edgeless fallback is per item), which bounds its memory."""
    from sparksched_tpu_torch.kernels.decima_encoder import (
        decima_node_encoder_bwd_ref,
    )

    w64 = _weights64(w)
    step = lanes or x.shape[0]
    total = None
    for i in range(0, x.shape[0], step):
        sl = slice(i, i + step)
        part = decima_node_encoder_bwd_ref(
            x[sl].double(), adj[sl], lvl[sl], mask[sl], w64, num_levels,
            slope, g[sl].double())
        total = part if total is None else [a + b for a, b in
                                            zip(total, part)]
    return total


def bf16_ulps(got, ref) -> float:
    """The largest |got - ref| in bfloat16 ulps at the scale of ref (the
    ulp of max |ref|): the tolerance unit of the bf16 NodeEncoder, whose
    two evaluations round apart where a float32 sum in another order
    lands on the other side of a bf16 rounding boundary."""
    a, b = got.double().cpu(), ref.double().cpu()
    top = float(b.abs().max())
    if top == 0.0:
        return 0.0 if torch.equal(a, b) else float("inf")
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return float((a - b).abs().max()) / ulp


def rel_norm(got, ref) -> float:
    """||got - ref|| / ||ref|| of one tensor (0 when both are 0)."""
    a, b = got.double().cpu(), ref.double().cpu()
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den else (0.0 if num == 0.0 else float("inf"))


def _fma32(a, w, c):
    """fmaf(a, w, c) of float32 tensors, rounded once: the product of two
    float32s is exact in float64, so is the sum but in rare halfway
    cases."""
    return (a.double() * w.double() + c.double()).float()


def _pinned_mlp(layers32, layers64, a32, a64, slope):
    """One MLP in two precisions side by side: float32 as the backward
    kernel computes it (each output = bias, then one fmaf per input in
    input order), float64 for autograd, whose LeakyReLU takes the branch
    the float32 pre-activation takes."""
    s32 = torch.tensor(slope, dtype=torch.float32, device=a32.device)
    for i, ((w32, b32), (w64, b64)) in enumerate(zip(layers32, layers64)):
        z32 = b32.expand(*a32.shape[:-1], b32.shape[0])
        for k in range(w32.shape[1]):
            z32 = _fma32(a32[..., k:k + 1], w32[:, k], z32)
        z64 = a64 @ w64.T + b64
        if i < len(layers32) - 1:
            keep = z32 >= 0
            a32 = torch.where(keep, z32, s32 * z32)
            a64 = torch.where(keep, z64, slope * z64)
        else:
            a32, a64 = z32, z64
    return a32, a64


def _pinned_items(x, adj, lvl, mask, w, w64, nl, slope, g):
    """The output of the NodeEncoder on these items in float64, through the
    backward kernel's structure (row passes over all rows; per level,
    deepest first, the update of its nodes from the children's current
    messages, then their msg when the level is >= 1), each LeakyReLU on the
    branch of the kernel's float32 forward; contracted with g."""
    from sparksched_tpu_torch.kernels.decima_encoder import edgeless_per_lane

    def mlp(name, a32, a64):
        return _pinned_mlp(getattr(w, name), w64[name], a32, a64, slope)

    x64 = x.double()
    hc = adj.any(-1)[..., None]
    U = adj.any(-1) & (lvl >= 0) & (lvl < nl)
    hin32, hin64 = mlp("prep", x, x64)
    u32, u64 = mlp("update", hin32, hin64)
    hv32 = torch.where(hc, 0.0, u32)
    hv64 = torch.where(hc, 0.0, u64)
    m32, m64 = mlp("msg", hv32, hv64)
    adj64 = adj.double()
    for level in range(nl - 1, -1, -1):
        P = (U & (lvl == level))[..., None]
        if not bool(P.any()):
            continue
        agg32 = torch.zeros_like(m32)  # children in order, from 0
        for c in range(adj.shape[-1]):
            agg32 = agg32 + torch.where(adj[..., c:c + 1],
                                        m32[..., c:c + 1, :], 0.0)
        y32, y64 = mlp("update", agg32, adj64 @ m64)
        hv32 = torch.where(P, hin32 + y32, hv32)
        hv64 = torch.where(P, hin64 + y64, hv64)
        if level >= 1:
            f32, f64 = mlp("msg", hv32, hv64)
            m32 = torch.where(P, f32, m32)
            m64 = torch.where(P, f64, m64)
    el = edgeless_per_lane(adj)[:, None, None, None]
    out = torch.where(mask[..., None], torch.where(el, hin64, hv64), 0.0)
    return (out * g.double()).sum()


def bwd_ref64_pinned(x, adj, lvl, mask, w, num_levels, slope, g, lanes=64):
    """The NodeEncoder's plain backward in float64 with each LeakyReLU's
    derivative taken on the branch the backward kernel's float32 forward
    takes (recomputed here in the kernel's order of operations): the
    exact gradient of the kernel's own branch pattern. Against this the
    kernel differs only by rounding. Against `bwd_ref64` a float32
    evaluation also differs wherever a pre-activation lies within its
    rounding of 0, which at ~10^5 live jobs happens a few dozen times and
    moves a gradient element by up to several times 1e-4 of its tensor's
    largest (the float32 plain backward as much as the kernel). Evaluated
    `lanes` items at a time and summed."""
    from sparksched_tpu_torch.kernels.decima_encoder import encoder_params

    s = x.shape[2]
    nl = min(num_levels, s) if num_levels else s
    total = None
    for i in range(0, x.shape[0], lanes):
        sl = slice(i, i + lanes)
        params = [t.detach().double().requires_grad_(True)
                  for t in encoder_params(w)]
        it = iter(params)
        w64 = {name: [(next(it), next(it)) for _ in getattr(w, name)]
               for name in ("prep", "msg", "update")}
        with torch.enable_grad():
            loss = _pinned_items(x[sl], adj[sl], lvl[sl], mask[sl], w, w64,
                                 nl, slope, g[sl])
            part = torch.autograd.grad(loss, params, allow_unused=True)
        part = [torch.zeros_like(p) if d is None else d
                for p, d in zip(params, part)]
        total = part if total is None else [a + b for a, b in
                                            zip(total, part)]
    return total


# -------------------------------------------------------------------------
# The training slice: a small Decima model on both sides, and Rollouts as
# named numpy leaves in the JAX pytree's order.

MINI_AGENT = dict(
    embed_dim=8,
    gnn_mlp_kwargs={"hid_dims": [16, 8], "act_cls": "LeakyReLU",
                    "act_kwargs": {"negative_slope": 0.2}},
    policy_mlp_kwargs={"hid_dims": [16, 16], "act_cls": "Tanh"},
)


def decima_pair(num_executors: int, scale: float = 0.3, **kw):
    """(JAX DecimaScheduler, port DecimaScheduler on the CPU) with the
    JAX init's weights scaled by `scale` carried to the port. The scale
    keeps the Tanh heads out of saturation, where two float32
    implementations may order near-tied choices differently."""
    import jax

    from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
    from sparksched_tpu_torch.schedulers import (
        DecimaScheduler,
        params_from_flax,
    )

    args = dict(MINI_AGENT, num_executors=num_executors, **kw)
    js = JaxDecima(**args)
    js.params = jax.tree_util.tree_map(lambda a: a * scale, js.params)
    ts = DecimaScheduler(**args, device="cpu")
    ts.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return js, ts


def port_rollout_leaves(ro) -> list[tuple[str, np.ndarray]]:
    """(name, numpy) of every leaf of a port Rollout, in the JAX
    Rollout's pytree order; the rng words as uint32."""
    import dataclasses

    out = [(f"obs.{f.name}", getattr(ro.obs, f.name).cpu().numpy())
           for f in dataclasses.fields(ro.obs)]
    for name in ("stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
                 "wall_times", "valid", "resets"):
        out.append((name, getattr(ro, name).cpu().numpy()))
    for f in dataclasses.fields(ro.final_state):
        a = getattr(ro.final_state, f.name).cpu().numpy()
        if f.name == "rng":
            a = a.astype(np.uint32)
        out.append((f"final_state.{f.name}", a))
    out.append(("final_reset_count", ro.final_reset_count.cpu().numpy()))
    return out


def port_rollout_from_jax(jro):
    """The port Rollout holding the values of a JAX Rollout ([B] lanes;
    the rng words as int64)."""
    import dataclasses

    from sparksched_tpu_torch.env.state import EnvState
    from sparksched_tpu_torch.trainers.rollout import Rollout, StoredObs

    def t(a, name=""):
        a = np.asarray(a)
        if name == "rng":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a))

    obs = StoredObs(**{f.name: t(getattr(jro.obs, f.name))
                       for f in dataclasses.fields(StoredObs)})
    env = EnvState(**{f.name: t(getattr(jro.final_state, f.name), f.name)
                      for f in dataclasses.fields(EnvState)})
    return Rollout(
        obs=obs, final_state=env,
        **{k: t(getattr(jro, k)) for k in (
            "stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
            "wall_times", "valid", "resets", "final_reset_count")})


def mini_train_cfg(**trainer) -> dict:
    """The small training config of the slice's tests: 5 executors, 6 job
    slots on the synthetic bank, 2 sequence groups x 2 lanes, T = 48,
    2 epochs x 3 minibatches, the flagship's PPO and Adam settings, the
    flat single-eval engine and the health block."""
    return {
        "trainer": {
            "trainer_cls": "PPO", "num_iterations": 2, "num_sequences": 2,
            "num_rollouts": 2, "seed": 42, "num_epochs": 2,
            "num_batches": 3, "clip_range": 0.2, "target_kl": 0.01,
            "entropy_coeff": 0.04, "beta_discount": 5.0e-3,
            "opt_cls": "Adam", "opt_kwargs": {"lr": 3.0e-4},
            "max_grad_norm": 0.5, "rollout_steps": 48,
            "rollout_engine": "flat", "flat_single_eval": True,
            "artifacts_dir": "test_artifacts/torch_train",
            "checkpointing_freq": 1000,
        } | trainer,
        "agent": {"agent_cls": "DecimaScheduler", "job_bucket": 3,
                  **MINI_AGENT},
        "env": {"num_executors": 5, "job_arrival_cap": 6,
                "moving_delay": 2000.0, "mean_time_limit": 2.0e7,
                "job_arrival_rate": 4.0e-5, "warmup_delay": 1000.0},
        "health": {"enabled": True},
        "obs": {"runlog": False, "memory": False},
    }



# Adam divides each gradient by its running RMS: at eps 1e-8 an element
# whose gradient sits near rounding level (the policy heads' output
# biases have an exact gradient of 0, since log-softmax and entropy are
# invariant to a shift of all scores; the heads' hidden units sum
# near-cancelling terms over nodes and executor rows) steps along float32
# noise, in the JAX update as in the port. At eps 1e-2 and lr 3e-2 a step
# is linear in the gradient, which makes the change of every parameter a
# strict check of the loss, the minibatches and the optimizer.
POLICY_HEADS = ("mlp_stage.", "mlp_exec.")
LINEAR_ADAM = {"lr": 3.0e-2, "eps": 1.0e-2}


def assert_update_close(want: dict, got: dict, p0: dict, steps: int,
                        lr: float, linear: bool,
                        heads_per_tensor: bool = False) -> float:
    """Parameters after an update (`got`, name -> tensor) against the
    reference's (`want`), both from `p0`. With `linear` (LINEAR_ADAM),
    every parameter's change against the reference's change, per
    element within rtol 1e-4 / atol 1e-7 per applied step (a step there
    is lr / eps = 3 times the gradient, whose float32 rounding reaches
    ~3e-8 where its exact value is 0); with `heads_per_tensor` the
    policy heads per tensor instead, within 1e-4 x the tensor's largest
    change + 1e-7 per applied step: their gradients sum terms over every
    node and executor row that nearly cancel, so another float32
    summation order (the card's) moves an element whose change is small
    against the tensor's at the 1e-4 level of the tensor's scale, while
    a wrong gradient misses by the scale itself. Otherwise every
    parameter within rtol 1e-4 / atol 1e-6, but the policy heads within
    Adam's step bound, 2 lr per applied step, which only catches a step
    of the wrong size: their check is the linear case. Returns the
    worst error over its tolerance."""
    assert set(want) == set(got)
    worst = 0.0
    for k, g in got.items():
        a = g.detach().cpu().double()
        b = torch.as_tensor(np.asarray(want[k])).double()
        head = k.startswith(POLICY_HEADS)
        if linear:
            base = p0[k].detach().cpu().double()
            a, b = a - base, b - base
            scale = b.abs().max() if head and heads_per_tensor else b.abs()
            tol = 1e-7 * steps + 1e-4 * scale
        elif head:
            tol = torch.full_like(b, 2 * lr * steps)
        else:
            tol = 1e-6 + 1e-4 * b.abs()
        ratio = float(((a - b).abs() / tol).max())
        assert ratio <= 1.0, f"{k}: {ratio:.3g}x its tolerance"
        worst = max(worst, ratio)
    return worst


# the heads' output biases of MINI_AGENT and the flagship: log-softmax and
# the entropy do not change when every score moves alike, so their exact
# gradient is 0 and any two float32 updates step them along noise
OUT_BIASES = ("mlp_stage.dense_2.bias", "mlp_exec.dense_2.bias")


def assert_linear_update_close(want: dict, got: dict, p0: dict,
                               heads_per_tensor: bool = False) -> float:
    """One step at LINEAR_ADAM (`got` against `want`, both from `p0`):
    `assert_update_close` on every parameter but OUT_BIASES, which are
    held within 1e-7 + 1e-4 of their head's largest change. Returns the
    worst error over its tolerance."""
    want, got = dict(want), dict(got)
    worst = 0.0
    for k in OUT_BIASES:
        head = k.split(".")[0]
        w = torch.as_tensor(np.asarray(want.pop(k))).double()
        scale = max(float((torch.as_tensor(np.asarray(v)).double()
                           - p0[n].detach().cpu().double()).abs().max())
                    for n, v in want.items() if n.startswith(head))
        err = float((got.pop(k).detach().cpu().double() - w).abs().max())
        ratio = err / (1e-7 + 1e-4 * scale)
        assert ratio <= 1.0, f"{k}: {ratio:.3g}x its tolerance"
        worst = max(worst, ratio)
    return max(worst, assert_update_close(
        want, got, p0, 1, LINEAR_ADAM["lr"], True, heads_per_tensor))


# The bf16 NodeEncoder kernels against their plain versions (the card, and
# their arithmetic built with g++): the forward within BF16_FWD_ULPS bf16
# ulps at the output's scale and at least BF16_FWD_EQUAL of it bit-equal
# (a float32 sum in another order lands on the other side of a bf16
# rounding boundary now and then, and the level chain carries it on); the
# backward within BF16_BWD_REL of each gradient tensor's norm (the plain
# version rounds each use's weight gradient to bf16, the kernel sums the
# uses in float32). A bf16 update's change of all parameters together
# within BF16_UPDATE_REL of the reference's norm (XLA:CPU sums the
# cotangents of broadcasts, biases' among them, one bf16 addition at a
# time; torch and the kernels in float32).
BF16_FWD_ULPS, BF16_FWD_EQUAL, BF16_BWD_REL = 2.0, 0.98, 2e-2
BF16_UPDATE_REL = 5e-2


SERVE_AGENT = dict(embed_dim=8, gnn_mlp_kwargs={"hid_dims": [16]},
                   policy_mlp_kwargs={"hid_dims": [16]}, job_bucket=4)
SERVE_INT_FIELDS = ("session_id", "stage_idx", "job_idx", "num_exec",
                    "decided", "done", "health_mask", "batched",
                    "params_version")
SERVE_FLOAT_FIELDS = ("lgprob", "reward", "dt", "wall_time")


def serve_setup():
    """The serving tests' small setup (tests/test_serve.py: 5 executors,
    6 jobs, embed 8, job_bucket 4, the weights scaled by 0.3 and carried
    across): ((JAX params, bank, scheduler), (port params, bank,
    scheduler on the CPU))."""
    from sparksched_tpu.config import EnvParams as JaxParams
    from sparksched_tpu.workload import make_workload_bank as jax_bank
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.workload import make_workload_bank

    jp = JaxParams(num_executors=5, max_jobs=6, max_stages=20, max_levels=20,
                   mean_time_limit=None)
    jb = jax_bank(jp.num_executors, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    js, ts = decima_pair(5, **SERVE_AGENT)
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=jp.max_stages,
                   max_levels=jp.max_levels)
    tb = make_workload_bank(5, tp.max_stages, device="cpu")
    return (jp, jb, js), (tp, tb, ts)


def assert_same_result(a, b, same_sid: bool = True) -> None:
    """One served decision of the JAX package (`a`) against the port's
    (`b`): integers and bools equal (the session ids too unless
    `same_sid` is off), floats within rtol 1e-5 (atol 1e-6 near
    zero)."""
    for k in SERVE_INT_FIELDS[0 if same_sid else 1:]:
        assert getattr(a, k) == getattr(b, k), (k, a.to_dict(), b.to_dict())
    for k in SERVE_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def slot_bytes(ls, lane: int) -> list[tuple[str, str, bytes]]:
    """(name, dtype, raw bytes) of every leaf of one lane of a port
    LoopState: equal lists mean bit-equal slots, NaNs included."""
    return [(name, str(v.dtype), v[lane].cpu().numpy().tobytes())
            for name, v in tfl.leaves(ls)]


def fleet_builder(weights: dict[str, np.ndarray], device: str = "cpu"):
    """A router replica's builder (`ReplicaSpec.builder`
    "tests._torch_parity:fleet_builder"): the port side of
    `serve_setup()` on `device`, with the weights given as numpy (each
    replica rebuilds the same bits). Imports no JAX, and fails the boot
    if anything in the replica did."""
    import sys

    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.workload import make_workload_bank

    torch.set_num_threads(1)  # the replica's own process, as the suite
    tb = make_workload_bank(5, 20, device=device)
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=tb.max_stages,
                   max_levels=tb.max_stages)
    ts = DecimaScheduler(**SERVE_AGENT, num_executors=5, device=device)
    ts.load_params(weights)
    if "jax" in sys.modules:
        raise RuntimeError("a replica imported jax")
    return tp, tb, ts


def drill_cfg(art, num_iterations=3, health=None, chaos_blk=None,
              fast_prng=False) -> dict:
    """`scripts_chaos_drill.py:drill_cfg` (5 executors, 3 job slots, 2
    lanes, T = 30) on the flat single-eval engine, the one the port
    runs."""
    import scripts_chaos_drill as drill

    cfg = drill.drill_cfg(str(art), num_iterations, health, chaos_blk)
    cfg["trainer"].update(rollout_engine="flat", flat_single_eval=True,
                          fast_prng=fast_prng)
    return cfg


def runlog_records(art) -> list[dict]:
    """Every record of the run logs under `art/runlog`, in file order."""
    import json
    import pathlib

    recs = []
    for p in sorted(pathlib.Path(art, "runlog").glob("*.jsonl")):
        recs.extend(json.loads(ln) for ln in open(p))
    return recs


# -------------------------------------------------------------------------
# The collectors' parity tests (`test_torch_collect_*.py`): a small
# environment where episodes end within a few dozen decisions (a mean
# time limit of 1e6), lanes and keys laid out as the trainer lays them
# out, and the leaf-by-leaf comparison of two Rollouts.

COLLECT_N, COLLECT_J = 4, 4


def collect_env(mean_time_limit: float = 1e6):
    """(JAX params, JAX bank, port params, port bank) at 4 executors and
    4 job slots on the synthetic bank."""
    from sparksched_tpu.config import EnvParams as JaxParams
    from sparksched_tpu.workload import make_workload_bank as jax_bank
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.workload import make_workload_bank

    kw = dict(num_executors=COLLECT_N, max_jobs=COLLECT_J,
              moving_delay=500.0, warmup_delay=200.0,
              mean_time_limit=mean_time_limit)
    jp = JaxParams(**kw)
    jb = jax_bank(COLLECT_N, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    tp = EnvParams(**kw).replace(max_stages=jp.max_stages,
                                 max_levels=jp.max_levels)
    return jp, jb, tp, make_workload_bank(COLLECT_N, tp.max_stages,
                                          device="cpu")


def collect_policies(kind: str):
    """(JAX per-lane policy, port lane policy, split_policy_keys) of the
    fair heuristic or of a small Decima (`decima_pair`)."""
    from sparksched_tpu.schedulers.heuristics import (
        round_robin_policy as j_round_robin,
    )
    from sparksched_tpu_torch.schedulers.heuristics import round_robin_policy

    if kind == "fair":
        return (lambda k, o: j_round_robin(o, COLLECT_N, True) + ({},),
                lambda k, o: round_robin_policy(o, COLLECT_N, True) + ({},),
                False)
    js, ts = decima_pair(COLLECT_N)
    return (lambda k, o: js.policy(k, o, js.params), ts.lane_policy, True)


def to_port_key(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def group_lanes(seed: int, iteration: int = 0):
    """The trainer's lanes at an iteration under jax's current default
    impl: 2 sequence groups x 2 lanes. Returns a dict of JAX arrays
    (`seq`, `lane`: the reset keys; `bases`: fold_in(master, g);
    `salts`: 1000 + r; `pol`: lane b's fold_in(fold_in(key, b), 7) of
    `key` = fold_in(master, 99)) and the same as port tensors."""
    import jax
    import jax.numpy as jnp

    master = jax.random.PRNGKey(seed)
    g_ids, r_ids = (0, 0, 1, 1), (0, 1, 0, 1)
    bases = jnp.stack([jax.random.fold_in(master, g) for g in g_ids])
    seq = jnp.stack([jax.random.fold_in(b, iteration) for b in bases])
    lane = jnp.stack([jax.random.fold_in(s, 1000 + r)
                      for s, r in zip(seq, r_ids)])
    key = jax.random.fold_in(master, 99)
    pol = jnp.stack([jax.random.fold_in(jax.random.fold_in(key, b), 7)
                     for b in range(4)])
    salts = jnp.asarray([1000 + r for r in r_ids], jnp.int32)
    j = dict(seq=seq, lane=lane, bases=bases, salts=salts, pol=pol, key=key)
    t = {k: (torch.from_numpy(np.array(v)) if k == "salts"
             else to_port_key(v)) for k, v in j.items()}
    return j, t


@contextlib.contextmanager
def jax_impl(impl: str):
    """jax's default PRNG impl set to `impl` inside, restored after."""
    import jax

    saved = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", impl)
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", saved)


def jax_telemetry_array(tm) -> np.ndarray:
    """A JAX Telemetry's counters as the port's [B, F] layout."""
    from sparksched_tpu_torch.obs.telemetry import FIELDS

    return np.stack([np.asarray(getattr(tm, f)) for f in FIELDS], -1)


def rollout_mismatches(jro, tro, lg_rtol: float = 1e-5,
                       reward_rtol: float = 1e-6, wall_rtol: float = 0.0,
                       actions_where_valid: bool = False) -> list[str]:
    """The leaves of a port Rollout that differ from a JAX Rollout's:
    every leaf bit-equal but the rewards (within `reward_rtol`), the
    log-probs (within `lg_rtol`) and the final state's floats (within
    1e-6: a reset's exponential arrival gaps take float32 `log1p`, where
    torch and XLA may part in the last ulp); `wall_rtol` > 0 holds the
    wall times so too (elapsed times summed across resets). With
    `actions_where_valid`, `job_idx` and `num_exec_k` only on the valid
    steps (the rows a `core.step` collector leaves out)."""
    pl = port_rollout_leaves(tro)
    jl = jax_leaves(jro)
    assert len(pl) == len(jl)
    valid = tro.valid.numpy()
    bad = []
    for a, (name, b) in zip(jl, pl):
        if actions_where_valid and name in ("job_idx", "num_exec_k"):
            a, b = a[valid], b[valid]
        rtol = {"lgprob": lg_rtol, "reward": reward_rtol,
                "wall_times": wall_rtol}.get(name, 0.0)
        if a.dtype.kind == "f" and rtol:
            if a.shape != b.shape or not np.allclose(a, b, rtol=rtol,
                                                     atol=1e-6):
                bad.append(name)
        else:
            bad += mismatched_leaves(
                [a], [(name, b)],
                rtol=1e-6 if name.startswith("final_state.") else 0.0)
    return bad
