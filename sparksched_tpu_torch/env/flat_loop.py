"""Flat micro-step engine, serving subset (counterpart of
`sparksched_tpu/env/flat_loop.py`).

The JAX package flattens the simulation into DECIDE / FULFILL / EVENT
micro-steps so that vmapped lanes advance in lockstep. This module ports
the pieces that the serving path runs: one precomputed decision applied
(`decide_micro_step`) and the lane drained to its next decision point
(`drain_to_decision`), joined in `apply_and_drain`. Every function takes
a lane batch (leading `[B]` axis). A `lax.while_loop` becomes a Python
loop that runs while any lane's condition holds and keeps the others
unchanged (the vmapped while's per-lane carry select); a `lax.switch`
over the mode becomes the branches applied in turn, each masked to its
own lanes, since each masked branch is an exact no-op elsewhere.

Only `auto_reset=False` is ported (serving freezes a finished lane), and
only the sequential engine (`event_bulk=False, fulfill_bulk=False`).
`micro_step`, `run_flat` and the trajectory ring wait for the training
slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import EnvParams
from ..workload.bank import WorkloadBank
from . import core
from .core import (
    RQ_NONE,
    _add_commitment,
    _apply_action,
    _commit_remaining,
    _compute_jobtime,
    _full,
    _fulfill_commitment_phase_a,
    _g,
    _handle_executor_ready,
    _handle_job_arrival,
    _handle_task_finished,
    _has_pending_event,
    _move_idle_from_pool,
    _next_event,
    _onehot2,
    _rank_order,
    _resolve_action,
    _w,
    find_schedulable,
)
from .state import (
    BIG_SEQ,
    EV_EXECUTOR_READY,
    EV_JOB_ARRIVAL,
    EV_TASK_FINISHED,
    EnvState,
)

_i32 = torch.int32

M_DECIDE, M_FULFILL, M_EVENT = 0, 1, 2


@dataclasses.dataclass
class LoopState:
    env: EnvState
    mode: torch.Tensor  # i32[B]
    fulfill_k: torch.Tensor  # i32[B]
    num_idle: torch.Tensor  # i32[B]
    exec_order: torch.Tensor  # i32[B,N]
    slot_order: torch.Tensor  # i32[B,N]
    decisions: torch.Tensor  # i32[B]
    episodes: torch.Tensor  # i32[B]
    bulked: torch.Tensor  # i32[B]

    def replace(self, **kw) -> "LoopState":
        return dataclasses.replace(self, **kw)


def aux_action_fields(aux: dict, stage_idx, num_exec, max_stages: int):
    """(lgprob, job_idx, num_exec_k) from a policy's aux dict, derived
    from the flat padded node index where the policy omits a key."""
    lgprob = aux.get("lgprob", torch.zeros(stage_idx.shape,
                                           device=stage_idx.device))
    job = aux.get("job_idx", torch.where(
        stage_idx >= 0,
        torch.div(stage_idx, max_stages, rounding_mode="floor"), 0))
    k = aux.get("num_exec_k", num_exec - 1)
    return lgprob, job, k


def leaves(ls: LoopState) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf: the env fields first, then the loop
    fields — the JAX pytree's leaf order."""
    out = [(f.name, getattr(ls.env, f.name))
           for f in dataclasses.fields(ls.env)]
    out += [(f.name, getattr(ls, f.name)) for f in dataclasses.fields(ls)
            if f.name != "env"]
    return out


def tree_map(fn, *lss: LoopState) -> LoopState:
    """Apply `fn` leaf-wise over LoopStates of the same structure."""
    env = EnvState(**{
        f.name: fn(*(getattr(x.env, f.name) for x in lss))
        for f in dataclasses.fields(EnvState)
    })
    rest = {
        f.name: fn(*(getattr(x, f.name) for x in lss))
        for f in dataclasses.fields(LoopState) if f.name != "env"
    }
    return LoopState(env=env, **rest)


def select(m: torch.Tensor, a: LoopState, b: LoopState) -> LoopState:
    """Per-lane `where(m, a, b)` over every leaf; `a` when all of m."""
    if bool(m.all()):
        return a
    return tree_map(lambda x, y: _w(m, x, y), a, b)


def select_env(m: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    if bool(m.all()):
        return a
    return EnvState(**{
        f.name: _w(m, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(EnvState)
    })


def take_slot(store: LoopState, idx: torch.Tensor) -> LoopState:
    """Sessions `idx` ([K] slot indices) gathered from a [C]-stacked
    store (a copy)."""
    i = idx.long()
    return tree_map(lambda a: a[i], store)


def write_slot(store: LoopState, idx: torch.Tensor, ls: LoopState) -> None:
    """`take_slot`'s partner: write K sessions back into the store IN
    PLACE — the counterpart of the JAX package's donated store, which
    XLA updates in place."""
    i = idx.long()
    for (_, dst), (_, src) in zip(leaves(store), leaves(ls)):
        dst[i] = src


def init_loop_state(state: EnvState) -> LoopState:
    b, n = state.exec_job.shape
    dev = state.exec_job.device

    def z(*shape):
        return torch.zeros((b,) + shape, dtype=_i32, device=dev)

    return LoopState(
        env=state, mode=z(), fulfill_k=z(), num_idle=z(),
        exec_order=z(n), slot_order=z(n), decisions=z(), episodes=z(),
        bulked=z(),
    )


def _lane_done(env: EnvState) -> torch.Tensor:
    """Episode over: all jobs complete or the time limit was crossed."""
    return env.all_jobs_complete | (env.wall_time >= env.time_limit)


def _clear_round(st: EnvState, en: torch.Tensor) -> EnvState:
    return st.replace(
        source_valid=st.source_valid & ~en,
        source_job=_w(en, -1, st.source_job),
        source_stage=_w(en, -1, st.source_stage),
        stage_selected=st.stage_selected & ~en[:, None, None],
        round_ready=st.round_ready & ~en,
        schedulable=st.schedulable & ~en[:, None, None],
    )


def _pop_event(params: EnvParams, st: EnvState, enabled: torch.Tensor):
    """Pop + handle one event on the lanes in `enabled` that have one.
    Returns (state, req_kind, rj, rs, event_arg, quirk, popped, kind)."""
    has, t, kind, arg = _next_event(params, st)
    popped = enabled & has
    st = st.replace(wall_time=torch.where(popped, t, st.wall_time))
    quirk = torch.where(popped, st.source_job_id(), -1)
    rk = _full(arg, RQ_NONE)
    rj = _full(arg, -1)
    rs = _full(arg, -1)
    for k, handler in (
        (EV_JOB_ARRIVAL, _handle_job_arrival),
        (EV_TASK_FINISHED, _handle_task_finished),
        (EV_EXECUTOR_READY, _handle_executor_ready),
    ):
        on = popped & (kind == k)
        if not bool(on.any()):
            continue
        st, rk_k, rj_k, rs_k = handler(st, arg, on)
        rk = torch.where(on, rk_k, rk)
        rj = torch.where(on, rj_k, rj)
        rs = torch.where(on, rs_k, rs)
    return st, rk, rj, rs, arg, quirk.to(_i32), popped, kind


def _apply_decision(params: EnvParams, ls: LoopState, stage_idx, num_exec
                    ) -> LoopState:
    """core.step's front half for one precomputed decision per lane:
    commit (or round finish), fulfillment-phase setup, mode bookkeeping."""
    st = ls.env
    s_cap = params.max_stages
    j = torch.div(stage_idx, s_cap, rounding_mode="floor").to(_i32)
    s = torch.remainder(stage_idx, s_cap).to(_i32)
    valid = (
        (stage_idx >= 0)
        & (stage_idx < params.num_nodes)
        & _g(st.schedulable, j, s)
    )

    # do_commit on valid lanes, _commit_remaining on the others
    committable = st.num_committable()
    nn = torch.minimum(torch.clamp_min(num_exec, 1), committable)
    nn = torch.minimum(nn, _g(st.exec_demand, j, s)).to(_i32)
    st = _add_commitment(st, nn, j, s, valid)
    j_cap, s_cap2 = st.stage_selected.shape[1:]
    sel = _onehot2(j_cap, s_cap2, j, s) & valid[:, None, None]
    st = st.replace(stage_selected=st.stage_selected | sel)
    st = st.replace(schedulable=torch.where(
        valid[:, None, None],
        find_schedulable(params, st, st.source_job_id()), st.schedulable,
    ))
    st = _commit_remaining(st, ~valid)

    round_continues = (st.num_committable() > 0) & st.schedulable.any((1, 2))
    fin = ~round_continues
    # finish: commit the rest, order the idle executors and the slots
    st = _commit_remaining(st, fin)
    n = st.exec_job.shape[1]
    idle = st.source_pool_mask() & ~st.exec_executing
    num_idle = idle.sum(1).to(_i32)
    pos = torch.arange(n, dtype=_i32, device=idle.device)
    exec_order = _rank_order(torch.where(idle, pos, BIG_SEQ))
    match = (
        st.cm_valid
        & (st.cm_src_job == st.source_job[:, None])
        & (st.cm_src_stage == st.source_stage[:, None])
    )
    slot_order = _rank_order(torch.where(match, st.cm_seq, BIG_SEQ))
    complete = fin & (num_idle <= 0)
    st = _clear_round(st, complete)
    mode = torch.where(
        round_continues, M_DECIDE,
        torch.where(complete, M_EVENT, M_FULFILL),
    ).to(_i32)
    c = round_continues[:, None]
    return ls.replace(
        env=st,
        mode=mode,
        fulfill_k=torch.zeros_like(ls.fulfill_k),
        num_idle=torch.where(round_continues, 0, num_idle).to(_i32),
        exec_order=torch.where(c, ls.exec_order, exec_order),
        slot_order=torch.where(c, ls.slot_order, slot_order),
        decisions=ls.decisions + 1,
    )


def _fulfill_branch(ls: LoopState, en: torch.Tensor):
    """One commitment fulfillment on the lanes in `en` (FULFILL mode).
    Returns (ls, rk, rj, rs, e, quirk)."""
    st = ls.env
    k = ls.fulfill_k
    e = _g(ls.exec_order, k)
    quirk = st.source_job_id()
    do = en & (k < ls.num_idle)
    st, rk, rj, rs = _fulfill_commitment_phase_a(
        st, e, _g(ls.slot_order, k), do
    )
    rk = torch.where(do, rk, RQ_NONE).to(_i32)
    rj = torch.where(do, rj, -1).to(_i32)
    rs = torch.where(do, rs, -1).to(_i32)
    last = k + 1 >= ls.num_idle
    mode = torch.where(
        en, torch.where(last, M_EVENT, M_FULFILL), ls.mode
    ).to(_i32)
    ls = ls.replace(env=st, mode=mode,
                    fulfill_k=torch.where(en, k + 1, k).to(_i32))
    return ls, rk, rj, rs, e, quirk


def _event_branch(params: EnvParams, ls: LoopState, en: torch.Tensor):
    """One event pop + handling on the lanes in `en` (EVENT mode).
    Returns (ls, rk, rj, rs, e, quirk)."""
    st, rk, rj, rs, arg, quirk, _, _ = _pop_event(params, ls.env, en)
    return ls.replace(env=st), rk, rj, rs, arg, quirk


def _finish_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                       ls2: LoopState, rk, rj, rs, e, quirk, t_ref):
    """Shared micro-step tail: move resolution/application, round
    clearing and readiness, the frozen-lane rollback of `auto_reset=False`.
    `ls` is the pre-step state, `ls2` the state after the mode branch.
    Returns (ls, (reward, dt, reset)) — the JAX `record=True` form."""
    st = ls2.env
    ak, tj, ts = _resolve_action(params, st, rk, e, rj, rs, quirk)
    st = _apply_action(params, bank, st, ak, e, tj, ts)

    fulfill_done = (ls.mode == M_FULFILL) & (ls2.fulfill_k >= ls2.num_idle)
    st = _clear_round(st, fulfill_done)

    is_event = ls.mode == M_EVENT
    committable = st.num_committable()
    sched = find_schedulable(params, st, st.source_job_id())
    ready = is_event & (committable > 0) & sched.any((1, 2))
    st = st.replace(
        round_ready=st.round_ready | ready,
        schedulable=torch.where(ready[:, None, None], sched, st.schedulable),
    )
    mc = ~ready & is_event & (committable > 0)
    idle = st.source_pool_mask() & ~st.exec_executing
    st = _move_idle_from_pool(
        st, st.source_job, st.source_stage, idle & mc[:, None]
    )
    st = st.replace(
        source_valid=st.source_valid & ~mc,
        source_job=_w(mc, -1, st.source_job),
        source_stage=_w(mc, -1, st.source_stage),
    )
    mode = torch.where(ready, M_DECIDE, ls2.mode).to(_i32)

    done = _lane_done(st)
    was_done = _lane_done(ls.env)
    t_old = ls.env.wall_time
    jt = _compute_jobtime(params, st, t_old, ls.env.job_active, t_ref)
    rec = (
        torch.where(was_done, 0.0, -jt),
        torch.where(was_done, 0.0, st.wall_time - t_old),
        done & ~was_done,
    )
    # auto_reset=False: lanes whose episode was over at entry freeze
    st = select_env(~was_done, st, ls.env)
    out = ls2.replace(
        env=st,
        mode=mode,
        decisions=torch.where(was_done, ls.decisions, ls2.decisions),
        bulked=torch.where(was_done, ls.bulked, ls2.bulked),
        episodes=ls2.episodes + (done & ~was_done).to(_i32),
    )
    return out, rec


def decide_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                      stage_idx, num_exec, t_ref):
    """One DECIDE micro-step driven by a precomputed decision per lane;
    lanes not in DECIDE mode are left exactly as they were. Returns
    `(ls, (decided, reward, dt, reset))`."""
    is_dec = ls.mode == M_DECIDE
    ls0 = ls.replace(mode=torch.zeros_like(ls.mode))
    ls2 = _apply_decision(params, ls0, stage_idx, num_exec)
    zero = torch.zeros_like(ls.mode)
    out_ls, (rw, dt, rs_) = _finish_micro_step(
        params, bank, ls0, ls2, zero + RQ_NONE, zero - 1, zero - 1, zero,
        ls2.env.source_job_id(), t_ref,
    )
    was_done = _lane_done(ls.env)
    decided = is_dec & ~was_done
    final = select(is_dec, out_ls, ls)
    rec = (
        decided,
        torch.where(is_dec, rw, 0.0),
        torch.where(is_dec, dt, 0.0),
        is_dec & rs_,
    )
    return final, rec


def drain_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                     t_ref):
    """One non-policy micro-step: FULFILL and EVENT lanes advance, DECIDE
    lanes take the no-op branch (the caller's loop select discards their
    result, as the JAX `masked=False` form relies on). Returns
    `(ls, (reward, dt, reset))`."""
    is_ful = ls.mode == M_FULFILL
    is_ev = ls.mode == M_EVENT
    quirk = ls.env.source_job_id()
    ls2, rk, rj, rs, e, quirk_f = _fulfill_branch(ls, is_ful)
    quirk = torch.where(is_ful, quirk_f, quirk)
    ls2, rk_e, rj_e, rs_e, arg, quirk_e = _event_branch(params, ls2, is_ev)
    rk = torch.where(is_ev, rk_e, rk)
    rj = torch.where(is_ev, rj_e, rj)
    rs = torch.where(is_ev, rs_e, rs)
    e = torch.where(is_ev, arg, torch.where(is_ful, e, 0)).to(_i32)
    quirk = torch.where(is_ev, quirk_e, quirk)
    return _finish_micro_step(params, bank, ls, ls2, rk, rj, rs, e, quirk,
                              t_ref)


def drain_to_decision(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                      t_ref):
    """Drain each lane's non-decision work — FULFILL leftovers and the
    event run — until it can DECIDE again, its episode is over or its
    queue is drained, accumulating the span's reward/dt/reset. Returns
    `(ls, (reward, dt, reset))`."""
    zero = torch.zeros_like(ls.env.wall_time)
    rw, dt = zero, zero.clone()
    rs = torch.zeros_like(ls.env.round_ready)
    while True:
        has = _has_pending_event(ls.env)
        stuck = (ls.mode == M_EVENT) & ~has & ~ls.env.round_ready
        cond = (ls.mode != M_DECIDE) & ~_lane_done(ls.env) & ~stuck
        if not bool(cond.any()):
            break
        nxt, (r, d, re) = drain_micro_step(params, bank, ls, t_ref)
        ls = select(cond, nxt, ls)
        rw = torch.where(cond, rw + r, rw)
        dt = torch.where(cond, dt + d, dt)
        rs = torch.where(cond, rs | re, rs)
    return ls, (rw, dt, rs)


def apply_and_drain(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                    stage_idx, num_exec, **knobs):
    """One precomputed decision per lane applied and drained to the next
    decision point: `decide_micro_step` then `drain_to_decision`, with the
    discount reference at each lane's wall time on entry. `knobs` are the
    JAX package's engine knobs; the bulk ones must be off (see
    `core.check_knobs`). Returns `(ls, (decided, reward, dt, reset))`."""
    core.check_knobs(knobs)
    t_ref = ls.env.wall_time
    ls2, (decided, rw1, dt1, rs1) = decide_micro_step(
        params, bank, ls, stage_idx, num_exec, t_ref
    )
    ls3, (rw2, dt2, rs2) = drain_to_decision(params, bank, ls2, t_ref)
    return ls3, (decided, rw1 + rw2, dt1 + dt2, rs1 | rs2)
