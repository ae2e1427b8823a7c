"""Shared helpers of the PyTorch-port parity tests (`test_torch_*.py`):
the same inputs go through the JAX package and the port, and the leaves
are compared as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from sparksched_tpu_torch.env import flat_loop as tfl


def jax_leaves(ls) -> list[np.ndarray]:
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(ls)]


def port_leaves(ls, lane: int = 0) -> list[tuple[str, np.ndarray]]:
    """(name, numpy) of one lane of a port LoopState; the rng words come
    back as uint32 like the JAX key."""
    out = []
    for name, v in tfl.leaves(ls):
        a = v[lane].cpu().numpy()
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
