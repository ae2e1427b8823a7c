"""The port's rollout collection against the JAX package's.

- `store_obs` / `stored_to_observation`: the stored record of mid-episode
  observations and the Observation rebuilt from it equal the JAX
  package's, leaf for leaf.
- `collect_flat_sync_batch` (single-eval, sync, stochastic Decima
  sampling, health on) from the same reset lanes, keys and carried
  weights: every `Rollout` leaf — the stored observations, actions,
  rewards, wall times, the valid and reset masks, the final state and
  the reset counts — and the health mask equal the JAX package's;
  floats within rtol 1e-6, log-probs within rtol 1e-5 (scores of two
  float32 GNN implementations). At `job_bucket` 3 both the compact and
  the full-width branch of the net run (lanes with more live jobs than
  3 fall back); at 0 the net always runs full width. T = 48 cuts some
  lanes' episodes (`test_torch_collect_tail.py` lets every lane finish).

Sizes: 5 executors, 6 job slots on the synthetic bank, 4 lanes (2
sequence groups x 2), weights x0.3."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.env import core as jcore
from sparksched_tpu.env.observe import observe as jobserve
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.trainers import rollout as jro
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env import core, flat_loop
from sparksched_tpu_torch.env.observe import observe
from sparksched_tpu_torch.trainers import rollout as tro
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import (
    decima_pair,
    jax_leaves,
    mismatched_leaves,
    port_rollout_leaves,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

N, J, LANES = 5, 6, 4


@functools.lru_cache(maxsize=None)
def _env():
    jp = JaxParams(num_executors=N, max_jobs=J, mean_time_limit=2e7)
    jb = jax_bank(N, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    tp = EnvParams(num_executors=N, max_jobs=J, max_stages=jp.max_stages,
                   max_levels=jp.max_levels, mean_time_limit=2e7)
    tb = make_workload_bank(N, tp.max_stages, device="cpu")
    return jp, jb, tp, tb


def _reset_keys(seed: int):
    """Two sequence groups of two lanes, as the trainer lays them out."""
    master = jax.random.PRNGKey(seed)
    seq = [jax.random.fold_in(jax.random.fold_in(master, g), 0)
           for g in (0, 0, 1, 1)]
    lane = [jax.random.fold_in(s, 1000 + r) for s, r in zip(seq, (0, 1, 0, 1))]
    js, jl = jnp.stack(seq), jnp.stack(lane)

    def port(k):
        return torch.from_numpy(np.asarray(k).astype(np.int64))
    return (js, jl), (port(js), port(jl))


def test_store_and_rebuild_observation_match_jax():
    jp, jb, tp, tb = _env()
    (js, jl), (ts_, tl) = _reset_keys(3)
    ls = flat_loop.init_loop_state(core.reset_pair(tp, tb, ts_, tl))
    for d in range(5):  # progressed episodes: live jobs, finished stages
        sch = ls.env.schedulable.reshape(LANES, -1)
        si = torch.where(sch.any(1), torch.argmax(sch.int(), 1), -1)
        ls, _ = flat_loop.apply_and_drain(
            tp, tb, ls, si.int(), torch.full((LANES,), 2, dtype=torch.int32),
            prng.split(prng.PRNGKey(d), LANES))
    env = ls.env
    to = observe(tp, env)
    so = tro.store_obs(to, env)
    from ._torch_parity import jax_env_from_port
    jenv = jax_env_from_port(env)
    jo = jax.vmap(lambda e: jobserve(jp, e))(jenv)
    jso = jax.vmap(jro.store_obs)(jo, jenv)
    for f in dataclasses.fields(so):
        assert np.array_equal(np.asarray(getattr(jso, f.name)),
                              getattr(so, f.name).numpy()), f.name
    assert int(so.node_mask.sum()) > 0
    tob = tro.stored_to_observation(tb, so)
    job = jax.vmap(lambda s: jro.stored_to_observation(jb, s))(jso)
    for f in dataclasses.fields(tob):
        a = np.asarray(getattr(job, f.name))
        b = getattr(tob, f.name).numpy()
        assert a.shape[-b.ndim:] == b.shape[-a.ndim:], f.name
        assert np.array_equal(np.broadcast_to(a, b.shape), b), f.name


@functools.lru_cache(maxsize=None)
def _collected(job_bucket: int, T: int):
    jp, jb, tp, tb = _env()
    jsch, tsch = decima_pair(N, job_bucket=job_bucket)
    (js, jl), (ts_, tl) = _reset_keys(7)
    key = jax.random.PRNGKey(21)
    jstates = jax.vmap(lambda s, l: jcore.reset_pair(jp, jb, s, l))(js, jl)
    jout, jtm = jro.collect_flat_sync_batch(
        jp, jb, lambda k, o: jsch.batch_policy(k, o, jsch.params), key, T,
        jstates, telemetry_zeros_like((LANES,)), health=True)
    counts = {}
    tout, thm = tro.collect_flat_sync_batch(
        tp, tb, lambda k, o: tsch.batch_policy(k, o),
        torch.from_numpy(np.asarray(key).astype(np.int64)), T,
        core.reset_pair(tp, tb, ts_, tl), health=True, counts=counts)
    return jout, np.asarray(jtm.health_mask), tout, thm.numpy(), counts


@pytest.mark.parametrize("job_bucket,T", [(3, 48), (0, 48)])
def test_collect_flat_sync_batch_matches_jax(job_bucket, T):
    jout, jhm, tout, thm, counts = _collected(job_bucket, T)
    pl = port_rollout_leaves(tout)
    jl = jax_leaves(jout)
    names = [n for n, _ in pl]
    lg = names.index("lgprob")
    np.testing.assert_allclose(pl[lg][1], jl[lg], rtol=1e-5, atol=1e-6)
    rest = [i for i in range(len(pl)) if i != lg]
    bad = mismatched_leaves([jl[i] for i in rest], [pl[i] for i in rest],
                            rtol=1e-6)
    assert not bad, bad
    assert np.array_equal(jhm, thm) and not thm.any()
    valid = tout.valid.numpy()
    assert valid.sum() > LANES * 10
    if T == 48:
        assert counts["rows"] == T and valid[:, -1].any()
    else:  # every lane finished: the loop left early
        assert counts["rows"] < T and not valid[:, -1].any()
    if job_bucket:  # both branches of the compacted net ran
        live = tout.obs.job_mask.sum(-1)[tout.valid]
        assert int(live.max()) > job_bucket >= int(live.min())
