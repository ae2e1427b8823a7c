"""The port's engine telemetry (`sparksched_tpu_torch/obs/telemetry.py`,
threaded through `env/core.py`, `env/flat_loop.py` and the collector)
against the JAX package's.

- The 2-lane trainer collection (`mini_train_cfg` at one sequence group,
  weights x0.3, health on, which turns telemetry on in both trainers):
  every counter of every lane, and the `summarize` dict, equal the JAX
  `Trainer._collect`'s.
- `run_flat` under the fair policy with auto-reset at `event_burst` 2
  (`micro_step` and `event_micro_step`, the bulk fulfillment on) and
  `core.step` with the bulk passes on and off: every counter equals the
  JAX package's, step for step for `core.step`.
- With telemetry off nothing changes: the collection's every leaf and the
  health mask are bit-equal to the telemetry-on run's (which the rollout
  tests hold to the JAX collector), and off returns no counters.

Sizes: 5 executors, 6 job slots on the synthetic bank."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.obs.telemetry import summarize as jax_summarize
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.schedulers import round_robin_policy as j_round_robin
from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.env import core, flat_loop
from sparksched_tpu_torch.obs.telemetry import (
    FIELDS,
    summarize,
    telemetry_zeros,
)
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import mini_train_cfg, port_rollout_leaves
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_heuristics import _fair_port, _keys, _synthetic

N, LANES = 5, 4


def _jax_counts(tm) -> np.ndarray:
    return np.stack([np.asarray(getattr(tm, f)) for f in FIELDS], -1)


@functools.lru_cache(maxsize=None)
def _trainer_collections():
    cfg = mini_train_cfg(num_sequences=1)
    jt = jax_make_trainer(cfg)
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    tt = make_trainer(cfg, device="cpu")
    tt.scheduler.load_params(params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.scheduler.params)))
    assert jt.obs_telemetry and tt.obs_telemetry
    rng = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    jro, _, jtm = jt._collect_jit(jt.scheduler.params, jnp.int32(0), rng,
                                  None)
    counts: dict = {}
    trng = prng.fold_in(prng.PRNGKey(42), 0)
    ro, hm = tt._collect(0, trng, counts)
    tt.obs_telemetry = False
    off: dict = {}
    ro_off, hm_off = tt._collect(0, trng, off)
    return jro, jtm, ro, hm, counts, ro_off, hm_off, off


def test_trainer_collection_counters_match_jax():
    jro, jtm, ro, hm, counts, *_ = _trainer_collections()
    tm = counts["telemetry"]
    assert np.array_equal(_jax_counts(jtm), tm.numpy())
    assert summarize(tm) == jax_summarize(jtm)
    s = summarize(tm)
    assert s["decisions"] == int(ro.valid.sum()) == int(
        np.asarray(jro.valid).sum())
    assert s["events_total"] > 0 and s["bulk"]["relaunch_events"] > 0


def test_telemetry_off_changes_nothing():
    _, _, ro, hm, counts, ro_off, hm_off, off = _trainer_collections()
    assert "telemetry" not in off and off["rows"] == counts["rows"]
    for (name, a), (_, b) in zip(port_rollout_leaves(ro),
                                 port_rollout_leaves(ro_off)):
        assert np.array_equal(a, b, equal_nan=True), name
    assert torch.equal(hm, hm_off)


def test_run_flat_counters_match_jax():
    jp, jb, tp, tb = _synthetic()
    jk, tk = _keys(3)
    rk, trk = _keys(9)

    @jax.jit
    def run(keys_reset, keys):
        def pol(rng, obs):
            si, ne = j_round_robin(obs, N, True)
            return si, ne, {}

        states = jax.vmap(lambda k: jcore.reset(jp, jb, k))(keys_reset)
        return jax.vmap(lambda s, k, tm: jfl.run_flat(
            jp, jb, pol, k, 60, s, auto_reset=True, event_burst=2,
            fulfill_bulk=True, telemetry=tm))(
            states, keys, telemetry_zeros_like((LANES,)))

    _, jtm = run(jk, rk)
    ls, tm = flat_loop.run_flat(tp, tb, _fair_port(tp), trk, 60,
                                core.reset(tp, tb, tk), auto_reset=True,
                                event_burst=2, fulfill_bulk=True,
                                telemetry=telemetry_zeros(LANES))
    assert np.array_equal(_jax_counts(jtm), tm.numpy())
    assert summarize(tm) == jax_summarize(jtm)
    s = summarize(tm)
    assert s["phase_iters"]["bulk"] > 0 and s["bulk"]["fulfill_hits"] > 0
    assert s["composition"]["decide"] > 0 and s["composition"]["event"] > 0


@pytest.mark.parametrize("bulk", [True, False])
def test_core_step_counters_match_jax(bulk):
    jp, jb, tp, tb = _synthetic()
    jk, tk = _keys(5)

    @jax.jit
    def jstep(st, si, ne, tm):
        return jax.vmap(lambda s, i, n, t: jcore.step(
            jp, jb, s, i, n, bulk=bulk, telemetry=t))(st, si, ne, tm)

    jst = jax.vmap(lambda k: jcore.reset(jp, jb, k))(jk)
    tst = core.reset(tp, tb, tk)
    jtm, tm = telemetry_zeros_like((LANES,)), telemetry_zeros(LANES)
    for d in range(40):
        sch = np.asarray(jst.schedulable).reshape(LANES, -1)
        si = np.where(sch.any(1) & (d % 5 != 4), sch.argmax(1), -1)
        ne = 1 + (np.arange(LANES) + d) % 3
        jst, *_, jtm = jstep(jst, jnp.asarray(si, jnp.int32),
                             jnp.asarray(ne, jnp.int32), jtm)
        tst, *_, tm = core.step(
            tp, tb, tst, torch.as_tensor(si, dtype=torch.int32),
            torch.as_tensor(ne, dtype=torch.int32), bulk=bulk, telemetry=tm)
        assert np.array_equal(_jax_counts(jtm), tm.numpy()), f"step {d}"
    s = summarize(tm)
    assert s["decisions"] > 0 and s["events_total"] > 0
