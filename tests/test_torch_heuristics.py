"""The port's heuristic schedulers, `run_flat` and metrics against the
JAX package's.

- `round_robin_policy` (fair and FIFO) and `random_policy` give the JAX
  actions on the same observations (mid-episode states of several
  lanes); `make_scheduler` builds the port's classes.
- `run_flat` with `auto_reset` under the fair and FIFO policies, at
  `event_burst` 1 and 4, equals JAX `run_flat` (vmapped over lanes) on
  every LoopState leaf; a `loop_state` resume equals one run; an
  `event_micro_step` leaves every lane that is not in EVENT mode
  untouched.
- The episode metrics equal the JAX package's on finished states.

Sizes: 5 executors, 6 job slots on the synthetic bank, and the
reference fixtures. Tolerances: actions and integer leaves equal; float
leaves within rtol 1e-6 on the synthetic bank (arrival times carry
last-ulp log1p/cumsum differences), bit-equal on the fixtures; metrics
within rtol 1e-6."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu import metrics as jmetrics
from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.env.observe import observe as jobserve
from sparksched_tpu.schedulers import random_policy as j_random
from sparksched_tpu.schedulers import round_robin_policy as j_round_robin
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch import metrics, prng
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env import core, flat_loop
from sparksched_tpu_torch.env.observe import observe
from sparksched_tpu_torch.schedulers import (
    DecimaScheduler,
    RandomScheduler,
    RoundRobinScheduler,
    make_scheduler,
    random_policy,
    round_robin_policy,
)
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import (
    jax_env_from_port,
    jax_leaves,
    mismatched_leaves,
    port_fixture_state,
    port_leaves,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .reference_fixtures import spec_diamond, spec_multi_job

N, J = 5, 6
LANES = 4


@functools.lru_cache(maxsize=None)
def _synthetic(mean_time_limit=5e5):
    jp = JaxParams(num_executors=N, max_jobs=J, mean_time_limit=mean_time_limit)
    jb = jax_bank(N, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    tp = EnvParams(num_executors=N, max_jobs=J, max_stages=jp.max_stages,
                   max_levels=jp.max_levels, mean_time_limit=mean_time_limit)
    tb = make_workload_bank(N, tp.max_stages, device="cpu")
    return jp, jb, tp, tb


def _keys(seed: int, n: int = LANES):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _fair_port(tp, dynamic=True):
    def pol(rng, obs):
        si, ne = round_robin_policy(obs, tp.num_executors, dynamic)
        return si, ne, {}
    return pol


@functools.lru_cache(maxsize=None)
def _mid_episode_states():
    """Port LoopStates of LANES lanes at several points of a fair-policy
    run with auto-reset (mixed modes, live sources, finished jobs)."""
    jp, jb, tp, tb = _synthetic()
    _, tk = _keys(11)
    ls = flat_loop.init_loop_state(core.reset(tp, tb, tk))
    out = []
    for i in range(6):
        ls = flat_loop.run_flat(tp, tb, _fair_port(tp), prng.fold_in(tk, i),
                                7, loop_state=ls, fulfill_bulk=True)
        out.append(ls)
    return jp, jb, tp, tb, out


@pytest.mark.parametrize("dynamic", [True, False], ids=["fair", "fifo"])
def test_round_robin_policy_matches_jax(dynamic):
    jp, jb, tp, tb, states = _mid_episode_states()
    jpol = jax.jit(jax.vmap(lambda e: j_round_robin(
        jobserve(jp, e), N, dynamic)))
    sched = RoundRobinScheduler(N, dynamic_partition=dynamic)
    assert sched.name == ("Fair" if dynamic else "FIFO")
    picked = 0
    for ls in states:
        jsi, jne = jpol(jax_env_from_port(ls.env))
        tsi, tne, info = sched.policy(None, observe(tp, ls.env))
        assert info == {}
        assert np.array_equal(np.asarray(jsi), tsi.numpy())
        assert np.array_equal(np.asarray(jne), tne.numpy())
        assert tsi.dtype == tne.dtype == torch.int32
        picked += int((tsi >= 0).sum())
    assert picked > 0


def test_random_policy_matches_jax():
    jp, jb, tp, tb, states = _mid_episode_states()
    jpol = jax.jit(jax.vmap(lambda k, e: j_random(k, jobserve(jp, e))))
    picked = 0
    for i, ls in enumerate(states):
        for seed in range(3):
            jk, tk = _keys(100 * i + seed)
            jsi, jne = jpol(jk, jax_env_from_port(ls.env))
            tsi, tne = random_policy(tk, observe(tp, ls.env))
            assert np.array_equal(np.asarray(jsi), tsi.numpy())
            assert np.array_equal(np.asarray(jne), tne.numpy())
            picked += int((tsi >= 0).sum())
    assert picked > 0
    # the scheduler's own key chain: one split per decision
    sched = RandomScheduler(seed=5)
    one = flat_loop.tree_map(lambda a: a[:1], states[-1])
    obs = observe(tp, one.env)
    key = jax.random.PRNGKey(5)
    for _ in range(3):
        key, sub = jax.random.split(key)
        jsi, jne = j_random(sub, jobserve(jp, jax.tree_util.tree_map(
            lambda a: a[0], jax_env_from_port(one.env))))
        act, _ = sched.schedule(obs)
        assert act == {"stage_idx": int(jsi), "num_exec": int(jne)}


def test_make_scheduler_builds_the_port_classes():
    fair = make_scheduler({"agent_cls": "RoundRobinScheduler",
                           "num_executors": 5, "dynamic_partition": False})
    assert isinstance(fair, RoundRobinScheduler) and fair.name == "FIFO"
    rnd = make_scheduler({"agent_cls": "RandomScheduler", "seed": 3})
    assert isinstance(rnd, RandomScheduler)
    dec = make_scheduler({"agent_cls": "DecimaScheduler", "num_executors": 5,
                          "embed_dim": 8, "device": "cpu"})
    assert isinstance(dec, DecimaScheduler)
    with pytest.raises(ValueError, match="not a valid scheduler"):
        make_scheduler({"agent_cls": "NoSuchScheduler"})


@functools.lru_cache(maxsize=None)
def _jax_run_flat(burst: int, fulfill_bulk: bool):
    """JAX `run_flat` vmapped over lanes, compiled once per burst: the
    fair/FIFO choice is a traced argument, so both policies share it."""
    jp, jb, _, _ = _synthetic()

    @functools.partial(jax.jit, static_argnums=3)
    def run(states, keys, dynamic, groups):
        def pol(rng, obs):
            fair = j_round_robin(obs, N, True)
            fifo = j_round_robin(obs, N, False)
            return (jnp.where(dynamic, fair[0], fifo[0]),
                    jnp.where(dynamic, fair[1], fifo[1]), {})

        return jax.vmap(lambda s, k: jfl.run_flat(
            jp, jb, pol, k, groups, s, auto_reset=True, event_burst=burst,
            fulfill_bulk=fulfill_bulk))(states, keys)

    return run


@pytest.mark.parametrize("dynamic", [True, False], ids=["fair", "fifo"])
@pytest.mark.parametrize("burst,fulfill_bulk", [(1, True), (4, False)],
                         ids=["burst1", "burst4"])
def test_run_flat_auto_reset_matches_jax(burst, fulfill_bulk, dynamic):
    jp, jb, tp, tb = _synthetic()
    groups = 160 // burst
    jk, tk = _keys(3)
    js0 = jax.vmap(lambda k: jcore.reset(jp, jb, k))(jk)
    ts0 = core.reset(tp, tb, tk)
    rk, trk = _keys(9)
    jls = _jax_run_flat(burst, fulfill_bulk)(js0, rk, jnp.bool_(dynamic),
                                             groups)
    tls = flat_loop.run_flat(tp, tb, _fair_port(tp, dynamic), trk, groups,
                             ts0, auto_reset=True, event_burst=burst,
                             fulfill_bulk=fulfill_bulk)
    bad = mismatched_leaves(jax_leaves(jls), port_leaves(tls, None), 1e-6)
    assert not bad, bad
    assert int(tls.episodes.sum()) >= LANES  # episodes ended and restarted
    assert int(tls.bulked.sum()) > 0


def _fixture_run(groups, key, state=None, loop_state=None):
    tp, tb, ls = port_fixture_state(spec_diamond(), 4)
    return flat_loop.run_flat(
        tp, tb, _fair_port(tp), key, groups,
        ls.env if loop_state is None else None, auto_reset=False,
        loop_state=loop_state)


def test_run_flat_loop_state_resume_matches_single_run():
    """With no auto-reset the keys feed only unused reset draws, so two
    chained runs equal one run of their length."""
    whole = _fixture_run(120, prng.PRNGKey(0)[None])
    half = _fixture_run(60, prng.PRNGKey(1)[None])
    chunked = _fixture_run(60, prng.PRNGKey(2)[None], loop_state=half)
    for (n, a), (_, b) in zip(flat_loop.leaves(whole),
                              flat_loop.leaves(chunked)):
        assert torch.equal(a, b), n


def test_event_micro_step_leaves_non_event_lanes_untouched():
    jp, jb, tp, tb, states = _mid_episode_states()
    ls = flat_loop.tree_map(lambda *a: torch.cat(a), *states[:3])
    is_ev = ls.mode == flat_loop.M_EVENT
    assert bool(is_ev.any()) and not bool(is_ev.all())
    _, tk = _keys(4, ls.mode.shape[0])
    out = flat_loop.event_micro_step(tp, tb, ls, tk)
    for (n, a), (_, b) in zip(flat_loop.leaves(out), flat_loop.leaves(ls)):
        assert torch.equal(a[~is_ev], b[~is_ev]), n
    assert not torch.equal(out.env.wall_time[is_ev], ls.env.wall_time[is_ev]) \
        or not torch.equal(out.env.rng[is_ev], ls.env.rng[is_ev])
    # a batch with no EVENT lane comes back as it was
    dec = flat_loop.init_loop_state(core.reset(tp, tb, tk[:2]))
    again = flat_loop.event_micro_step(tp, tb, dec, tk[:2])
    for (n, a), (_, b) in zip(flat_loop.leaves(again),
                              flat_loop.leaves(dec)):
        assert torch.equal(a, b), n


def test_metrics_match_jax_on_finished_states():
    # the multi-job fixture run to its end, and synthetic lanes run past
    # their (short) time limits
    tp, tb, ls = port_fixture_state(spec_multi_job(5, 7), 5)
    fx = flat_loop.run_flat(tp, tb, _fair_port(tp), prng.PRNGKey(0)[None],
                            400, ls.env, auto_reset=False,
                            fulfill_bulk=True).env
    assert bool(fx.all_jobs_complete.all())
    jp, jb, sp, sb = _synthetic()
    _, tk = _keys(21)
    sy = flat_loop.run_flat(sp, sb, _fair_port(sp), tk, 150,
                            core.reset(sp, sb, tk), auto_reset=False).env
    assert bool(flat_loop._lane_done(sy).all())
    for env in (fx, sy):
        je = jax_env_from_port(env)
        d, m = metrics.job_durations(env)
        jd, jm = jax.vmap(jmetrics.job_durations)(je)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
        assert np.array_equal(m.numpy(), np.asarray(jm))
        for name in ("avg_job_duration", "avg_num_jobs"):
            np.testing.assert_allclose(
                getattr(metrics, name)(env).numpy(),
                np.asarray(jax.vmap(getattr(jmetrics, name))(je)),
                rtol=1e-6, err_msg=name)
        for name in ("num_completed_jobs", "num_job_arrivals"):
            a = getattr(metrics, name)(env)
            assert a.dtype == torch.int32
            assert np.array_equal(
                a.numpy(), np.asarray(jax.vmap(getattr(jmetrics, name))(je)))
        assert int(metrics.num_completed_jobs(env).sum()) > 0
        np.testing.assert_allclose(
            metrics.job_duration_percentiles(env),
            jmetrics.masked_percentiles(jd, jm), rtol=1e-6)
    assert np.array_equal(metrics.masked_percentiles(np.zeros(3),
                                                     np.zeros(3, bool)),
                          np.zeros(4))
