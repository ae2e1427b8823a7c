"""The port's bulk event engine against the JAX package's.

- Each bulk pass (`_bulk_fulfill`, `_bulk_relaunch`, `_bulk_ready`,
  `_bulk_events_fused`) on mid-episode states, one per lane, against the
  JAX pass under `jax.vmap`: all 61 LoopState leaves and the returned
  counts, with `stop_at_limit` on time limits that fall inside the run.
  The states come from the JAX flat engine (sequential, fair policy) and
  are carried across leaf for leaf. `_bulk_fulfill` also runs on the
  rarer states of a random-policy run where an executor leaves a
  job-pool source before a later candidate starts on that same job, with
  a duration sampler pinned to the job-local executor count (the real
  bank's intervals hide a count off by one there).
- (`apply_and_drain` over whole episodes is in `test_torch_drain.py`.)
- `core.step` with `bulk=True/False` against JAX `core.step`.
- The port's bulk engine against its own sequential engine with the
  duration sampler pinned to a table lookup (the JAX package's
  `test_bulk_paths_match_sequential_on_synthetic_bank`), and `run_flat`
  with and without the bulk passes on the fixtures, where the engines'
  rng streams differ and every other leaf must agree.

Sizes: 5 executors, 6 job slots on the synthetic bank, and the
reference fixtures. Tolerances: integer and bool leaves equal; float
leaves bit-equal on the fixtures and between the port's own engines,
within rtol 1e-6 against JAX on the synthetic bank (its arrival times
carry last-ulp log1p/cumsum differences) and under the pinned sampler
(XLA may round its float32 sums an ulp apart)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.schedulers import round_robin_policy as j_round_robin
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env import core, flat_loop
from sparksched_tpu_torch.env.observe import observe
from sparksched_tpu_torch.schedulers import round_robin_policy
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import (
    jax_leaves,
    mismatched_leaves,
    port_fixture_state,
    port_from_jax,
    port_leaves,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .reference_fixtures import make_tpu_env_state, spec_diamond, spec_multi_job

N, J = 5, 6
LANES = 16  # mid-episode states per pass test


def _i32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def _keys(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def _stack(states):
    return jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)),
                                  *states)


def _lane(ls, i):
    return jax.tree_util.tree_map(lambda a: a[i], ls)


def _synthetic(mean_time_limit=2e7, moving_delay=2000.0):
    jp = JaxParams(num_executors=N, max_jobs=J, mean_time_limit=mean_time_limit,
                   moving_delay=moving_delay)
    jb = jax_bank(N, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    tp = EnvParams(num_executors=N, max_jobs=J, max_stages=jp.max_stages,
                   max_levels=jp.max_levels, mean_time_limit=mean_time_limit,
                   moving_delay=moving_delay)
    tb = make_workload_bank(N, tp.max_stages, device="cpu")
    return jp, jb, tp, tb


def _fixture():
    spec = spec_multi_job(5, 7)
    jp, jb, jstate = make_tpu_env_state(spec, 5)
    tp, tb, _ = port_fixture_state(spec, 5)
    return jp, jb, tp, tb, jfl.init_loop_state(jstate)


def _det_samplers(dur_scale: float):
    """The pinned duration sampler of the JAX package's bulk-vs-
    sequential test, for each package: a table lookup with no rng."""

    def jax_sampler(params, bank, u2, template, stage, num_local, task_valid,
                    same_stage):
        base = bank.rough_duration[template, stage] * dur_scale
        return (base + jnp.where(task_valid & same_stage, 7.0, 131.0)
                + 17.0 * stage.astype(jnp.float32))

    def port_sampler(params, bank, u2, template, stage, num_local,
                     task_valid, same_stage):
        template, stage, task_valid, same_stage, _ = torch.broadcast_tensors(
            template, stage, torch.as_tensor(task_valid),
            torch.as_tensor(same_stage), u2[..., 0])
        base = bank.rough_duration[template.long(), stage.long()] * dur_scale
        return (base + torch.where(task_valid & same_stage, 7.0, 131.0)
                + 17.0 * stage.to(torch.float32))

    return jax_sampler, port_sampler


@functools.lru_cache(maxsize=None)
def _snapshots(source: str):
    """(jp, jb, tp, tb, rtol, states): every lane's state after each
    micro-step of the JAX flat engine (sequential, fair policy, no
    auto-reset), for the pass tests to pick from."""
    if source == "fixture":
        jp, jb, tp, tb, js = _fixture()
        js = _stack([js])
        steps, rtol = 200, 0.0
    else:
        jp, jb, tp, tb = _synthetic()
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        js = jax.vmap(lambda k: jfl.init_loop_state(jcore.reset(jp, jb, k)))(
            keys)
        steps, rtol = 100, 1e-6

    def pol(rng, obs):
        si, ne = j_round_robin(obs, jp.num_executors, True)
        return si, ne, {}

    @jax.jit
    def mstep(ls, keys):
        return jax.vmap(lambda l, k: jfl.micro_step(
            jp, jb, pol, l, k, auto_reset=False, event_bulk=False,
            fulfill_bulk=False))(ls, keys)

    out = []
    for i in range(steps):
        ls_keys = jax.random.split(jax.random.PRNGKey(100 + i),
                                   js.mode.shape[0])
        js = mstep(js, ls_keys)
        host = jax.device_get(js)
        out += [_lane(host, b) for b in range(js.mode.shape[0])]
    return jp, jb, tp, tb, rtol, out


def _pick(states, pred, n=LANES):
    """Up to n states satisfying `pred`, spread over the run, stacked."""
    hits = [s for s in states if bool(pred(s))]
    assert len(hits) >= 4, "too few states to test the pass on"
    idx = np.linspace(0, len(hits) - 1, min(n, len(hits))).astype(int)
    return _stack([hits[i] for i in idx])


def _with_limits(jls):
    """Time limits inside each lane's next events: the second-earliest
    pending finish or arrival (the earliest when only one is pending), so
    a pass crosses the limit after its first event or two."""
    lims = []
    for b in range(jls.mode.shape[0]):
        env = _lane(jls, b).env
        t = np.concatenate([np.asarray(env.exec_finish_time),
                            np.asarray(env.exec_arrive_time)])
        t = np.sort(t[np.isfinite(t)])
        lims.append(t[min(1, len(t) - 1)] if len(t) else np.inf)
    lim = jnp.asarray(np.array(lims, np.float32))
    return jls.replace(env=jls.env.replace(time_limit=lim))


def _assert_same(jls, tls, rtol, what: str) -> None:
    bad = mismatched_leaves(jax_leaves(jls), port_leaves(tls, None), rtol)
    assert not bad, f"{what}: leaves differ: {bad}"


@pytest.mark.parametrize("source", ["fixture", "synthetic"])
def test_bulk_fulfill_matches_jax(source):
    jp, jb, tp, tb, rtol, states = _snapshots(source)
    jls = _pick(states, lambda l: (l.mode == jfl.M_FULFILL)
                & (l.fulfill_k == 0) & (l.num_idle > 0))
    tls = port_from_jax(jls)
    jenv, jm = jax.jit(jax.vmap(lambda l: jcore._bulk_fulfill(
        jp, jb, l.env, l.num_idle, l.exec_order, l.slot_order)))(jls)
    tenv, tm = core._bulk_fulfill(tp, tb, tls.env, tls.num_idle,
                                  tls.exec_order, tls.slot_order)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert tm.dtype == torch.int32 and int(tm.sum()) > 0
    _assert_same(jls.replace(env=jenv), tls.replace(env=tenv), rtol,
                 "_bulk_fulfill")


def _event_lanes(states):
    return _pick(states, lambda l: (l.mode == jfl.M_EVENT)
                 & jcore._has_pending_event(l.env))


def _enabled(b: int):
    on = np.arange(b) % 4 != 3  # every fourth lane disabled: a no-op
    return jnp.asarray(on), torch.from_numpy(on)


def _with_source_join(jls):
    """Make the second-earliest moving executor (the earliest when one
    moves) arrive into the live source pool: the source becomes its
    destination job's pool, or its stage's pool where it will start a
    task, so a pass must stop right after consuming that arrival."""
    env = jax.device_get(jls.env)
    valid = np.array(env.source_valid)
    sj, ss = np.array(env.source_job), np.array(env.source_stage)
    for b in range(jls.mode.shape[0]):
        t = np.where(env.exec_moving[b], env.exec_arrive_time[b], np.inf)
        order = np.argsort(t, kind="stable")
        e = order[min(1, int(np.isfinite(t).sum()) - 1)]
        dj, ds = int(env.exec_dst_job[b, e]), int(env.exec_dst_stage[b, e])
        done = (env.stage_completed_tasks[b, dj, ds]
                >= env.stage_num_tasks[b, dj, ds])
        front = env.stage_exists[b, dj, ds] & ~done
        front &= env.incomplete_parent_count[b, dj, ds] == 0
        valid[b], sj[b], ss[b] = True, dj, ds if front else -1
    return jls.replace(env=jls.env.replace(
        source_valid=jnp.asarray(valid), source_job=jnp.asarray(sj),
        source_stage=jnp.asarray(ss)))


def _with_tie(jls):
    """Make a moving executor arrive at the earliest pending finish's
    time (and no other arrival or job earlier), its sequence number just before
    that finish's on even lanes and just after it on odd ones: the
    passes must order the two events by (time, seq)."""
    env = jax.device_get(jls.env)
    at, aq = np.array(env.exec_arrive_time), np.array(env.exec_arrive_seq)
    jt = np.array(env.job_arrival_time)
    for b in range(jls.mode.shape[0]):
        ft = env.exec_finish_time[b]
        moving = np.flatnonzero(env.exec_moving[b])
        f = int(np.argmin(ft))
        if len(moving) and np.isfinite(ft[f]):
            # no other arrival and no job arrival comes first
            at[b, moving] = np.maximum(at[b, moving], ft[f] + 1.0)
            later = ~env.job_arrived[b]
            jt[b, later] = np.maximum(jt[b, later], ft[f] + 1.0)
            e = moving[0]
            at[b, e] = ft[f]
            aq[b, e] = env.exec_finish_seq[b, f] + (-1 if b % 2 == 0 else 1)
    return jls.replace(env=jls.env.replace(
        exec_arrive_time=jnp.asarray(at), exec_arrive_seq=jnp.asarray(aq),
        job_arrival_time=jnp.asarray(jt)))


@pytest.mark.parametrize("source", ["fixture", "synthetic"])
@pytest.mark.parametrize("bulk_pass,variant", [
    ("relaunch", "plain"), ("relaunch", "limit"), ("relaunch", "tie"),
    ("ready", "plain"), ("ready", "limit"), ("ready", "join"),
    ("fused", "plain"), ("fused", "limit"), ("fused", "join"),
])
def test_bulk_event_pass_matches_jax(bulk_pass, variant, source):
    """`limit`: `stop_at_limit` with the time limit inside the run;
    `join`: an arrival into the live source pool ends the run (the
    relaunch pass never consumes an arrival, so it has no such case);
    `tie`: an arrival at a finish's time (its competitor)."""
    jp, jb, tp, tb, rtol, states = _snapshots(source)
    stop_at_limit = variant == "limit"
    if variant in ("join", "tie"):
        jls = _pick(states, lambda l: (
            (l.mode == jfl.M_EVENT) & l.env.exec_moving.any()))
        jls = (_with_source_join if variant == "join" else _with_tie)(jls)
    else:
        jls = _event_lanes(states)
    if stop_at_limit:
        jls = _with_limits(jls)
    tls = port_from_jax(jls)
    jon, ton = _enabled(jls.mode.shape[0])
    kw = {"stop_at_limit": stop_at_limit}
    if bulk_pass != "ready":
        kw["max_events"] = 8
    jfn = {"relaunch": jcore._bulk_relaunch, "ready": jcore._bulk_ready,
           "fused": jcore._bulk_events_fused}[bulk_pass]
    tfn = {"relaunch": core._bulk_relaunch, "ready": core._bulk_ready,
           "fused": core._bulk_events_fused}[bulk_pass]
    jout = jax.jit(jax.vmap(lambda e, on: jfn(jp, jb, e, on, **kw)))(
        jls.env, jon)
    tout = tfn(tp, tb, tls.env, ton, **kw)
    counts = 0
    for a, b in zip(jout[1:], tout[1:]):
        assert np.array_equal(np.asarray(a), b.numpy()), (a, b)
        assert b.dtype == torch.int32
        assert not b[~ton].any()
        counts += int(b.sum())
    assert counts > 0, "the pass consumed no event on any lane"
    _assert_same(jls.replace(env=jout[0]), tls.replace(env=tout[0]), rtol,
                 bulk_pass)
    if stop_at_limit:
        k = sum(b for b in tout[1:])
        crossed = (k > 0) & (tout[0].wall_time >= tout[0].time_limit)
        assert bool(crossed.any()), "no pass crossed its time limit"


def _episodes(monkeypatch, source):
    """(jp, jb, tp, tb, JAX LoopState [B], rtol) of a whole-episode run."""
    if source == "fixture":
        jp, jb, tp, tb, js = _fixture()
        return jp, jb, tp, tb, _stack([js]), 0.0
    if source == "dense":
        # tiny durations and a short moving delay: relaunch-generated
        # finishes interleave densely with arrival bursts
        jsamp, tsamp = _det_samplers(0.02)
        monkeypatch.setattr(jcore, "sample_task_duration", jsamp)
        monkeypatch.setattr(core, "sample_task_duration", tsamp)
        jp, jb, tp, tb = _synthetic(mean_time_limit=None, moving_delay=700.0)
        # XLA and torch round the pinned sampler's float32 sums alike to
        # within an ulp, not always to the bit
        rtol = 1e-6
    else:
        jp, jb, tp, tb = _synthetic(mean_time_limit=2e6)
        rtol = 1e-6
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    js = jax.vmap(lambda k: jfl.init_loop_state(jcore.reset(jp, jb, k)))(keys)
    return jp, jb, tp, tb, js, rtol


@pytest.mark.parametrize("source,bulk", [("fixture", False),
                                         ("synthetic", True)])
def test_core_step_matches_jax(monkeypatch, source, bulk):
    jp, jb, tp, tb, js, rtol = _episodes(monkeypatch, source)
    jst, b = js.env, js.mode.shape[0]
    tst = port_from_jax(js).env

    @jax.jit
    def jstep(st, si, ne):
        return jax.vmap(lambda s, i, n: jcore.step(
            jp, jb, s, i, n, bulk=bulk))(st, si, ne)

    for d in range(60):
        if bool(np.asarray(jst.terminated | jst.truncated).all()):
            break
        sch = np.asarray(jst.schedulable).reshape(b, -1)
        si = np.where(sch.any(1) & (d % 5 != 4), sch.argmax(1), -1)
        ne = 1 + (np.arange(b) + d) % 3
        jst, jr, jterm, jtrunc = jstep(jst, jnp.asarray(si, jnp.int32),
                                       jnp.asarray(ne, jnp.int32))
        tst, tr, tterm, ttrunc = core.step(tp, tb, tst, _i32(si), _i32(ne),
                                           bulk=bulk)
        _assert_same(jax.vmap(jfl.init_loop_state)(jst),
                     flat_loop.init_loop_state(tst), rtol, f"step {d}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                                   rtol=max(rtol, 1e-6), atol=1e-3)
        assert np.array_equal(np.asarray(jterm), tterm.numpy())
        assert np.array_equal(np.asarray(jtrunc), ttrunc.numpy())


def _neq_ignoring_rng(a, b) -> list[str]:
    return [n for (n, x), (_, y) in zip(flat_loop.leaves(a),
                                        flat_loop.leaves(b))
            if n != "rng" and not torch.equal(x, y)]


@pytest.mark.parametrize("dur_scale,moving_delay", [(1.0, 2000.0),
                                                    (0.02, 700.0)])
def test_bulk_paths_match_sequential(monkeypatch, dur_scale, moving_delay):
    """Under the pinned sampler the port's bulk `core.step` equals its
    sequential one on every leaf but the rng, step by step over the
    first 25 decisions of two episodes."""
    _, tsamp = _det_samplers(dur_scale)
    monkeypatch.setattr(core, "sample_task_duration", tsamp)
    _, _, tp, tb = _synthetic(mean_time_limit=None, moving_delay=moving_delay)
    keys = torch.stack([prng.PRNGKey(s) for s in (0, 3)])
    sa = sb = core.reset(tp, tb, keys)
    for d in range(25):
        si, ne = round_robin_policy(observe(tp, sa), tp.num_executors)
        sa, *_ = core.step(tp, tb, sa, si, ne, bulk=True)
        sb, *_ = core.step(tp, tb, sb, si, ne, bulk=False)
        bad = _neq_ignoring_rng(flat_loop.init_loop_state(sa),
                                flat_loop.init_loop_state(sb))
        assert not bad, f"step {d}: {bad}"
    assert not bool(sa.terminated.any())


@pytest.mark.parametrize("fixture", ["diamond", "multi_job"])
def test_run_flat_bulk_matches_sequential(fixture):
    """`run_flat` (fair policy, no auto-reset) lands on the same terminal
    state with the bulk passes (fused, chained three cycles, with the
    bulk fulfillment) as without them, on every leaf but the rng and
    the bulk bookkeeping (`bulked`; `mode`, dead on a frozen lane)."""
    spec, n, seq_groups, bulk_groups = (
        (spec_diamond(), 4, 80, 60) if fixture == "diamond"
        else (spec_multi_job(4, 11), 5, 250, 160))
    tp, tb, ls = port_fixture_state(spec, n)

    def pol(rng, obs):
        si, ne = round_robin_policy(obs, tp.num_executors)
        return si, ne, {}

    keys = prng.PRNGKey(0)[None]
    outs = {
        name: flat_loop.run_flat(tp, tb, pol, keys, groups, ls.env,
                                 auto_reset=False, **kw)
        for name, groups, kw in (
            ("sequential", seq_groups, {"event_bulk": False}),
            ("bulk", bulk_groups, {"fulfill_bulk": True}),
            ("cycles3", bulk_groups, {"fulfill_bulk": True,
                                      "bulk_cycles": 3}),
            ("unfused", bulk_groups, {"bulk_fused": False}),
        )
    }
    b = outs["sequential"]
    assert b.episodes.tolist() == [1]
    for name in ("bulk", "cycles3", "unfused"):
        a = outs[name]
        assert a.episodes.tolist() == [1], name
        assert torch.equal(a.decisions, b.decisions), name
        bad = [n for n in _neq_ignoring_rng(a, b)
               if n not in ("bulked", "mode")]
        assert not bad, f"{name}: {bad}"
        assert int(a.bulked.sum()) > 0


def _job_pool_leaver_states():
    """Lanes of a JAX random-policy run (sequential engine, auto-reset)
    at the start of a fulfillment phase whose source is a job pool and
    where an executor of that job is sent elsewhere before a later
    candidate's commitment lands on the job itself: the candidate's
    job-local executor count must not include the leaver."""
    from sparksched_tpu.schedulers import random_policy as j_random

    jp, jb, tp, tb = _synthetic()

    def pol(rng, obs):
        return (*j_random(rng, obs), {})

    @jax.jit
    def mstep(ls, keys):
        return jax.vmap(lambda l, k: jfl.micro_step(
            jp, jb, pol, l, k, auto_reset=True, event_bulk=False,
            fulfill_bulk=False))(ls, keys)

    hits = []
    for seed, steps in ((0, 34), (1, 20)):
        keys = jax.random.split(jax.random.PRNGKey(seed), LANES)
        js = jax.vmap(lambda k: jfl.init_loop_state(jcore.reset(jp, jb, k)))(
            keys)
        for i in range(steps):
            js = mstep(js, jax.random.split(
                jax.random.PRNGKey(1000 * seed + i), LANES))
        host = jax.device_get(js)
        for b in range(LANES):
            ls = _lane(host, b)
            env, n = ls.env, int(ls.num_idle)
            if not (ls.mode == jfl.M_FULFILL and ls.fulfill_k == 0 and n
                    and env.source_job >= 0 and env.source_stage < 0):
                continue
            dj = np.asarray(env.cm_dst_job)[np.asarray(ls.slot_order)[:n]]
            ejob = np.asarray(env.exec_job)[np.asarray(ls.exec_order)[:n]]
            leaver = (dj >= 0) & (ejob >= 0) & (ejob != dj)
            same = dj == int(env.source_job)
            if any(same[k] and leaver[:k].any() for k in range(n)):
                hits.append(ls)
    return jp, jb, tp, tb, hits


def test_bulk_fulfill_counts_earlier_leavers_from_a_job_pool(monkeypatch):
    jp, jb, tp, tb, hits = _job_pool_leaver_states()
    assert len(hits) >= 2
    jsamp, tsamp = _det_samplers(1.0)

    def jax_sampler(params, bank, u2, template, stage, num_local, *rest):
        return jsamp(params, bank, u2, template, stage, num_local, *rest) + (
            1000.0 * num_local.astype(jnp.float32))

    def port_sampler(params, bank, u2, template, stage, num_local, *rest):
        return tsamp(params, bank, u2, template, stage, num_local, *rest) + (
            1000.0 * num_local.to(torch.float32))

    monkeypatch.setattr(jcore, "sample_task_duration", jax_sampler)
    monkeypatch.setattr(core, "sample_task_duration", port_sampler)
    jls = _stack(hits)
    tls = port_from_jax(jls)
    jenv, jm = jax.vmap(lambda l: jcore._bulk_fulfill(
        jp, jb, l.env, l.num_idle, l.exec_order, l.slot_order))(jls)
    tenv, tm = core._bulk_fulfill(tp, tb, tls.env, tls.num_idle,
                                  tls.exec_order, tls.slot_order)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert bool((tm > 1).all())
    _assert_same(jls.replace(env=jenv), tls.replace(env=tenv), 1e-6,
                 "_bulk_fulfill (job-pool leavers)")
