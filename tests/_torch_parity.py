"""Shared helpers of the PyTorch-port parity tests (`test_torch_*.py`):
the same inputs go through the JAX package and the port, and the leaves
are compared as numpy arrays. Also the seeded NodeEncoder inputs of
`make_case`, which `chip_smoke.py` loads from this file by path."""

from __future__ import annotations

import numpy as np
import torch

from sparksched_tpu_torch.env import flat_loop as tfl


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
