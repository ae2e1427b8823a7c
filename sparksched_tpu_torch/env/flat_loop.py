"""Flat micro-step engine (counterpart of
`sparksched_tpu/env/flat_loop.py`).

The JAX package flattens the simulation into DECIDE / FULFILL / EVENT
micro-steps so that vmapped lanes advance in lockstep: `micro_step` (a
policy-bearing step of any mode), `event_micro_step` (EVENT lanes only),
`decide_micro_step` (one precomputed decision) and `drain_micro_step` /
`drain_to_decision` (everything up to the next decision), with
`apply_and_drain` for serving and `run_flat` for whole episodes. The
engine knobs (`event_bulk`, `bulk_events`, `fulfill_bulk`,
`bulk_cycles`, `bulk_fused`) select the bulk passes of `core` as in the
JAX package, with its defaults per function.

Every function takes a lane batch (leading `[B]` axis) and one key per
lane (`[B,2]`) where the JAX package takes one per vmapped lane. A
`lax.while_loop` becomes a Python loop that runs while any lane's
condition holds and keeps the others unchanged (the vmapped while's
per-lane carry select); a `lax.switch` over the mode becomes the
branches applied in turn, each masked to its own lanes; a `lax.scan`
over groups becomes a Python loop. Each function takes the optional
`telemetry` counters (`obs.telemetry.Telemetry`) and then returns them
as a trailing element, advanced as the JAX package advances them; the
default None counts nothing and runs nothing extra. `TrajRing` and
`ring_append` are the serving store's device trajectory ring. The
micro-step trajectory records (`record=True`) and `reset_fn` are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import prng
from ..config import EnvParams
from ..obs.telemetry import add as _tm_add
from ..workload.bank import WorkloadBank
from . import core
from .core import (
    RQ_NONE,
    _apply_action,
    _bulk_events_fused,
    _bulk_fulfill,
    _bulk_ready,
    _bulk_relaunch,
    _clear_round,
    _commit_decision,
    _commit_remaining,
    _compute_jobtime,
    _fulfill_commitment_phase_a,
    _full,
    _g,
    _has_pending_event,
    _pop_event,
    _rank_order,
    _resolve_action,
    _round_tail,
    _w,
    select_env,
)
from .observe import observe
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


@dataclasses.dataclass
class TrajRing:
    """Device-resident trajectory ring: an [R]-record tree plus a
    monotone append cursor, kept beside the session store and updated
    in place by the ring-recording serve programs.

    `cursor` (i32 []) counts the records EVER appended, not the wrapped
    position: the host drains the span `[drained, cursor)` and recovers
    the positions itself (`i % R`), so an overrun (more than R appends
    between drains) shows as `cursor - drained > R` instead of silently
    aliasing. `rec` is any tree (dataclasses, dicts, tensors) whose
    leaves carry R + 1 rows: row R is a sink that masked-off lanes of an
    append write to, where the JAX package's scatter drops them (an
    out-of-range index is a device-side assert on the card). The
    append below is schema-agnostic."""

    cursor: torch.Tensor  # i32 []; total records appended since init
    rec: Any  # [R + 1, ...] record tree; row R is the sink

    @property
    def size(self) -> int:
        """R, the ring's depth in records."""
        return rec_leaves(self.rec)[0].shape[0] - 1


def rec_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a record tree (dataclass fields in order, dict
    keys sorted; None fields skipped)."""
    if dataclasses.is_dataclass(tree):
        out: list[torch.Tensor] = []
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if v is not None:
                out += rec_leaves(v)
        return out
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in rec_leaves(tree[k])]
    return [tree]


def rec_map(fn, *trees):
    """`fn` leaf-wise over record trees of one structure."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            f.name: (None if getattr(t0, f.name) is None else
                     rec_map(fn, *(getattr(t, f.name) for t in trees)))
            for f in dataclasses.fields(t0)
        })
    if isinstance(t0, dict):
        return {k: rec_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def make_ring(R: int, rec) -> TrajRing:
    """A zero-filled ring of depth `R` for records shaped like `rec`
    (one record, no leading axis), on `rec`'s device."""
    if R < 1:
        raise ValueError(f"ring depth {R} must be >= 1")
    ring_rec = rec_map(
        lambda a: torch.zeros((R + 1,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), rec)
    dev = rec_leaves(rec)[0].device
    return TrajRing(cursor=torch.zeros((), dtype=_i32, device=dev),
                    rec=ring_rec)


def ring_append(ring: TrajRing, recs, mask: torch.Tensor) -> TrajRing:
    """Masked append into the ring, IN PLACE (the JAX package's donated
    ring): a scalar `mask` appends one record, a [K] `mask` the masked
    subset of [K]-stacked records in lane order (exclusive-cumsum
    compaction). Masked-off lanes write to the sink row R, so the
    indices are built on the device and the append never syncs the
    host. The wrap (`% R`) happens here; the cursor advances by the
    number of records actually appended. Returns the ring."""
    R = ring.size
    if mask.dim() == 0:
        n = mask.to(_i32)
        idx = torch.where(mask, ring.cursor % R, R).reshape(1)
        recs = rec_map(lambda v: v.unsqueeze(0), recs)
    else:
        mi = mask.to(_i32)
        n = mi.sum().to(_i32)
        offs = torch.cumsum(mi, 0) - mi  # exclusive cumsum: append order
        idx = torch.where(mask, (ring.cursor + offs) % R, R)
    idx = idx.long()
    for dst, src in zip(rec_leaves(ring.rec), rec_leaves(recs)):
        dst[idx] = src.to(dst.dtype)
    ring.cursor.add_(n)
    return ring


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


def _reset_key(rng: torch.Tensor, auto_reset: bool):
    """The reset key of a micro-step's `split(rng)`; only an auto-reset
    reads it, so without one the split is skipped (nothing observes
    it)."""
    return prng.split(rng)[:, 1] if auto_reset else None


def _bulk_cycle_chain(params: EnvParams, bank: WorkloadBank, env: EnvState,
                      is_event: torch.Tensor, bulk_events: int,
                      bulk_cycles: int, bulk_fused: bool = True,
                      split: bool = False):
    """`bulk_cycles` chained bulk passes on the lanes in `is_event`: each
    cycle one `_bulk_events_fused` pass, or without `bulk_fused` the
    relaunch cascade and the arrival burst. A cycle after the first runs
    only where the between-event tail it skips would be a no-op
    (`num_committable() == 0`, wall clock inside the episode limit).
    A pass that no lane runs is skipped: it would change nothing.
    Returns (env, events consumed[B]), with `split` (the telemetry's
    need) also the relaunch and the ready events among them."""
    nb = _full(env.wall_time, 0)
    nb_rel, nb_rdy = nb, nb
    for i in range(bulk_cycles):
        on = is_event if i == 0 else (
            is_event
            & (env.num_committable() == 0)
            & (env.wall_time < env.time_limit)
        )
        if not bool(on.any()):
            continue
        if bulk_fused:
            env, nb1, nb2 = _bulk_events_fused(
                params, bank, env, on, stop_at_limit=True,
                max_events=bulk_events,
            )
        else:
            env, nb1 = _bulk_relaunch(
                params, bank, env, on, stop_at_limit=True,
                max_events=bulk_events,
            )
            # never past an episode-limit crossing the cascade committed
            env, nb2 = _bulk_ready(
                params, bank, env, on & (env.wall_time < env.time_limit),
                stop_at_limit=True,
            )
        nb = nb + nb1 + nb2
        if split:
            nb_rel, nb_rdy = nb_rel + nb1, nb_rdy + nb2
    return (env, nb, nb_rel, nb_rdy) if split else (env, nb)


def _bulk_phase(params, bank, ls: "LoopState", is_ev, event_bulk: bool,
                bulk_events: int, bulk_cycles: int, bulk_fused: bool,
                split: bool, nb=None):
    """The bulk passes of a micro-step on the EVENT lanes `is_ev`:
    (ls, nb, nb_rel, nb_rdy), the split only with `split` (else None).
    Without `event_bulk` nothing runs and the counts are the given
    `nb`."""
    if not event_bulk:
        return ls, nb, nb, nb
    out = _bulk_cycle_chain(params, bank, ls.env, is_ev, bulk_events,
                            bulk_cycles, bulk_fused, split)
    env_b, nb = out[0], out[1]
    rel, rdy = (out[2], out[3]) if split else (None, None)
    return ls.replace(env=env_b, bulked=ls.bulked + nb), nb, rel, rdy


def _event_counts(nb, nb_rel, nb_rdy, popped, kind) -> dict:
    """The event counters of a micro-step: events consumed, the bulk
    passes' share by kind, and the single pop by kind."""
    return dict(
        loop_iters=nb + popped,
        bulk_relaunch_events=nb_rel,
        bulk_ready_events=nb_rdy,
        bulk_passes=nb > 0,
        ev_job_arrival=popped & (kind == EV_JOB_ARRIVAL),
        ev_task_finished=popped & (kind == EV_TASK_FINISHED),
        ev_exec_ready=popped & (kind == EV_EXECUTOR_READY),
    )


def _fused_pop_gate(env: EnvState, nb: torch.Tensor) -> torch.Tensor:
    """May a micro-step still pop the run-cutting event after its bulk
    passes consumed `nb` events? Always when nothing was bulked; after a
    bulk only when the skipped between-event tail is a no-op."""
    return (nb == 0) | (
        (env.num_committable() == 0) & (env.wall_time < env.time_limit)
    )


def _apply_decision(params: EnvParams, ls: LoopState, stage_idx, num_exec,
                    fulfill_bulk: bool) -> LoopState:
    """core.step's front half for one precomputed decision per lane:
    commit (or round finish), fulfillment-phase setup, mode bookkeeping.
    With `fulfill_bulk` a finished round always enters FULFILL: the
    shared tail runs the bulk fulfillment and clears it."""
    st = _commit_decision(params, ls.env, stage_idx, num_exec)
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
    if fulfill_bulk:
        complete = torch.zeros_like(fin)
    else:
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


def _event_branch(params: EnvParams, ls: LoopState, en: torch.Tensor,
                  nb: torch.Tensor):
    """One event pop + handling on the lanes in `en` (EVENT mode), gated
    by `_fused_pop_gate` over the `nb` events the bulk passes consumed.
    Returns (ls, rk, rj, rs, e, quirk, popped, kind)."""
    st, rk, rj, rs, arg, quirk, popped, kind = _pop_event(
        params, ls.env, en & _fused_pop_gate(ls.env, nb)
    )
    return ls.replace(env=st), rk, rj, rs, arg, quirk, popped, kind


def _work_branches(params: EnvParams, ls: LoopState, is_ful, is_ev, nb,
                   quirk):
    """The FULFILL and EVENT branches, each masked to its own lanes, and
    the move request of every lane's branch: (ls, (rk, rj, rs, e,
    quirk), popped, kind). A lane in neither mode keeps `quirk` and
    requests nothing; only EVENT lanes pop."""
    ls, rk, rj, rs, e, quirk_f = _fulfill_branch(ls, is_ful)
    quirk = torch.where(is_ful, quirk_f, quirk)
    ls, rk_e, rj_e, rs_e, arg, quirk_e, popped, kind = _event_branch(
        params, ls, is_ev, nb)
    rk = torch.where(is_ev, rk_e, rk)
    rj = torch.where(is_ev, rj_e, rj)
    rs = torch.where(is_ev, rs_e, rs)
    e = torch.where(is_ev, arg, torch.where(is_ful, e, 0)).to(_i32)
    quirk = torch.where(is_ev, quirk_e, quirk)
    return ls, (rk, rj, rs, e, quirk), popped, kind


def _finish_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                       ls2: LoopState, rk, rj, rs, e, quirk, t_ref,
                       k_reset=None, auto_reset: bool = False,
                       fulfill_bulk: bool = False, telemetry=None):
    """Shared micro-step tail: the bulk fulfillment of a round that just
    finished (`fulfill_bulk`), move resolution/application, round
    clearing and readiness, episode end. `ls` is the pre-step state
    (pre-bulk: a lane frozen by `auto_reset=False` goes back to exactly
    it), `ls2` the state after the mode branch. With `auto_reset`, a
    lane whose episode ended restarts from `core.reset` on its key of
    `k_reset`. Returns (ls, (reward, dt, reset)) — the JAX `record=True`
    form, measured on the pre-reset state — and with `telemetry` the
    counters, the bulk fulfillment's hits added on lanes live at entry."""
    st = ls2.env
    if fulfill_bulk:
        want = (ls.mode == M_DECIDE) & (ls2.mode == M_FULFILL)
        if bool(want.any()):  # else the pass would change nothing
            ni = torch.where(want, ls2.num_idle, 0)
            st, k0 = _bulk_fulfill(params, bank, st, ni, ls2.exec_order,
                                   ls2.slot_order)
            if telemetry is not None:
                telemetry = _tm_add(telemetry, ~_lane_done(ls.env),
                                    bulk_fulfill_hits=k0)
            complete = want & (k0 >= ls2.num_idle)
            st = _clear_round(st, complete)
            ls2 = ls2.replace(
                fulfill_k=torch.where(want, k0, ls2.fulfill_k).to(_i32),
                mode=torch.where(complete, M_EVENT, ls2.mode).to(_i32),
            )

    ak, tj, ts = _resolve_action(params, st, rk, e, rj, rs, quirk)
    st = _apply_action(params, bank, st, ak, e, tj, ts)

    fulfill_done = (ls.mode == M_FULFILL) & (ls2.fulfill_k >= ls2.num_idle)
    st = _clear_round(st, fulfill_done)
    st, ready = _round_tail(params, st, ls.mode == M_EVENT)
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
    if auto_reset:
        if bool(done.any()):
            st = select_env(done, core.reset(params, bank, k_reset), st)
        mode = torch.where(done, M_DECIDE, mode).to(_i32)
    else:
        # lanes whose episode was over at entry freeze
        st = select_env(~was_done, st, ls.env)
        ls2 = ls2.replace(
            decisions=torch.where(was_done, ls.decisions, ls2.decisions),
            bulked=torch.where(was_done, ls.bulked, ls2.bulked),
        )
    out = ls2.replace(
        env=st,
        mode=mode,
        episodes=ls2.episodes + (done & ~was_done).to(_i32),
    )
    return (out, rec, telemetry) if telemetry is not None else (out, rec)


def micro_step(params: EnvParams, bank: WorkloadBank, policy_fn,
               ls: LoopState, rng: torch.Tensor, auto_reset: bool = True,
               compute_levels: bool = True, event_bulk: bool = True,
               bulk_events: int = 8, fulfill_bulk: bool = False,
               bulk_cycles: int = 1, bulk_fused: bool = True,
               telemetry=None):
    """One unit of work per lane: EVENT lanes first run the bulk passes
    (`event_bulk`), then every lane runs its mode's branch — DECIDE asks
    `policy_fn(keys, obs)` for `(stage_idx, num_exec, aux)` and commits,
    FULFILL fulfils one commitment, EVENT pops one event (fused pop) —
    and the shared tail. `rng` holds one key per lane. Returns the new
    LoopState, and with `telemetry` `(ls, telemetry)`: every live lane
    counts its micro-step by entry mode, its events and a finished
    round."""
    track = telemetry is not None
    keys = prng.split(rng)
    k_pol, k_reset = keys[:, 0], keys[:, 1]
    ls0 = ls  # pre-bulk state: the freeze path must restore exactly this
    is_ev = ls.mode == M_EVENT
    ls, nb, nb_rel, nb_rdy = _bulk_phase(params, bank, ls, is_ev, event_bulk,
                                         bulk_events, bulk_cycles, bulk_fused,
                                         track, _full(ls.mode, 0))
    is_dec = ls.mode == M_DECIDE
    is_ful = ls.mode == M_FULFILL

    # DECIDE: one commitment from the policy (core.step's front half)
    ls2 = ls
    quirk = ls.env.source_job_id()
    if bool(is_dec.any()):
        obs = observe(params, ls.env, compute_levels)
        stage_idx, num_exec, _ = policy_fn(k_pol, obs)
        ls_d = _apply_decision(params, ls, stage_idx.to(_i32),
                               num_exec.to(_i32), fulfill_bulk)
        ls2 = select(is_dec, ls_d, ls)
        quirk = torch.where(is_dec, ls_d.env.source_job_id(), quirk)
    ls2, req, popped, kind = _work_branches(params, ls2, is_ful, is_ev, nb,
                                            quirk)
    out = _finish_micro_step(params, bank, ls0, ls2, *req, None, k_reset,
                             auto_reset, fulfill_bulk, telemetry)
    if not track:
        return out[0]
    is_dec0 = ls0.mode == M_DECIDE
    telemetry = _tm_add(
        out[2], ~_lane_done(ls0.env),
        decide_steps=is_dec0, fulfill_steps=ls0.mode == M_FULFILL,
        event_steps=is_ev, commit_rounds=is_dec0 & (ls2.mode != M_DECIDE),
        **_event_counts(nb, nb_rel, nb_rdy, popped, kind),
    )
    return out[0], telemetry


def event_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                     rng: torch.Tensor, auto_reset: bool = True,
                     event_bulk: bool = True, bulk_events: int = 8,
                     bulk_cycles: int = 1, bulk_fused: bool = True,
                     telemetry=None):
    """One EVENT-only micro-step: lanes in EVENT mode run the bulk
    passes, pop one event and the shared tail; every other lane is left
    exactly as it was (rng and counters included). With `telemetry`
    returns `(ls, telemetry)`, live EVENT lanes counted."""
    track = telemetry is not None
    is_event = ls.mode == M_EVENT
    if not bool(is_event.any()):
        return (ls, telemetry) if track else ls
    k_reset = _reset_key(rng, auto_reset)
    ls0 = ls.replace(mode=torch.full_like(ls.mode, M_EVENT))
    if event_bulk:
        ls, nb, nb_rel, nb_rdy = _bulk_phase(params, bank, ls, is_event,
                                             True, bulk_events, bulk_cycles,
                                             bulk_fused, track)
        pop_on = is_event & _fused_pop_gate(ls.env, nb)
    else:
        nb = nb_rel = nb_rdy = _full(ls.mode, 0) if track else None
        pop_on = is_event
    st, rk, rj, rs, arg, quirk, popped, kind = _pop_event(params, ls.env,
                                                          pop_on)
    ls_ev = ls.replace(mode=torch.full_like(ls.mode, M_EVENT), env=st)
    out, _ = _finish_micro_step(params, bank, ls0, ls_ev, rk, rj, rs, arg,
                                quirk, None, k_reset, auto_reset)
    final = select(is_event, out, ls)
    if not track:
        return final
    telemetry = _tm_add(
        telemetry, is_event & ~_lane_done(ls0.env), event_steps=is_event,
        **_event_counts(nb, nb_rel, nb_rdy, popped, kind),
    )
    return final, telemetry


def decide_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                      stage_idx, num_exec, rng: torch.Tensor,
                      auto_reset: bool = True, fulfill_bulk: bool = False,
                      t_ref=None, telemetry=None):
    """One DECIDE micro-step driven by a precomputed decision per lane;
    lanes not in DECIDE mode are left exactly as they were. Returns
    `(ls, (decided, reward, dt, reset))`, and with `telemetry` the
    counters as a third element: the decisions, the rounds they finish
    and the bulk fulfillment's hits (the tail runs on every live lane, as
    in the JAX package)."""
    is_dec = ls.mode == M_DECIDE
    k_reset = _reset_key(rng, auto_reset)
    ls0 = ls.replace(mode=torch.zeros_like(ls.mode))
    ls2 = _apply_decision(params, ls0, stage_idx, num_exec, fulfill_bulk)
    zero = torch.zeros_like(ls.mode)
    out = _finish_micro_step(
        params, bank, ls0, ls2, zero + RQ_NONE, zero - 1, zero - 1, zero,
        ls2.env.source_job_id(), t_ref, k_reset, auto_reset, fulfill_bulk,
        telemetry,
    )
    out_ls, (rw, dt, rs_) = out[0], out[1]
    was_done = _lane_done(ls.env)
    decided = is_dec & ~was_done
    final = select(is_dec, out_ls, ls)
    rec = (
        decided,
        torch.where(is_dec, rw, 0.0),
        torch.where(is_dec, dt, 0.0),
        is_dec & rs_,
    )
    if telemetry is None:
        return final, rec
    telemetry = _tm_add(out[2], decided, decide_steps=decided,
                        commit_rounds=ls2.mode != M_DECIDE)
    return final, rec, telemetry


def drain_micro_step(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                     rng: torch.Tensor, auto_reset: bool = True,
                     event_bulk: bool = True, bulk_events: int = 8,
                     bulk_cycles: int = 1, t_ref=None,
                     bulk_fused: bool = True, masked: bool = True,
                     telemetry=None, count_on: torch.Tensor | None = None):
    """One non-policy micro-step: FULFILL and EVENT lanes advance as in
    `micro_step` (bulk passes and fused pop included); DECIDE lanes are
    rolled back unless `masked=False` (legal only where the caller
    discards their result, as `drain_to_decision` does). Returns
    `(ls, (reward, dt, reset))`, and with `telemetry` the counters as a
    third element: live FULFILL / EVENT lanes counted, only those in
    `count_on` when it is given (the drain loop's lanes, which then also
    count a drain iteration)."""
    track = telemetry is not None
    active = ls.mode != M_DECIDE
    k_reset = _reset_key(rng, auto_reset)
    ls0 = ls
    is_ev = ls.mode == M_EVENT
    is_ful = ls.mode == M_FULFILL
    ls, nb, nb_rel, nb_rdy = _bulk_phase(params, bank, ls, is_ev, event_bulk,
                                         bulk_events, bulk_cycles, bulk_fused,
                                         track, _full(ls.mode, 0))
    ls2, req, popped, kind = _work_branches(params, ls, is_ful, is_ev, nb,
                                            ls.env.source_job_id())
    out, (rw, dt, rs_) = _finish_micro_step(params, bank, ls0, ls2, *req,
                                            t_ref, k_reset, auto_reset)
    if track:
        on = active & ~_lane_done(ls0.env)
        extra = {}
        if count_on is not None:
            on = on & count_on
            extra["drain_iters"] = on
        telemetry = _tm_add(
            telemetry, on, fulfill_steps=is_ful, event_steps=is_ev,
            **_event_counts(nb, nb_rel, nb_rdy, popped, kind), **extra,
        )
    if masked:
        out = select(active, out, ls0)
        rw, dt, rs_ = (torch.where(active, rw, 0.0),
                       torch.where(active, dt, 0.0), active & rs_)
    return (out, (rw, dt, rs_), telemetry) if track else (out, (rw, dt, rs_))


def drain_to_decision(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                      rng: torch.Tensor, auto_reset: bool = True,
                      event_bulk: bool = True, bulk_events: int = 8,
                      bulk_cycles: int = 1, t_ref=None,
                      bulk_fused: bool = True, telemetry=None):
    """Drain each lane's non-decision work — FULFILL leftovers and the
    event run — until it can DECIDE again, its episode is over or its
    queue is drained, accumulating the span's reward/dt/reset. With
    `auto_reset` each iteration splits the lane's key (a lane whose
    loop has ended keeps its key). Returns `(ls, (reward, dt,
    reset))`, and with `telemetry` the counters as a third element
    (each lane counts its own iterations in `drain_iters`)."""
    track = telemetry is not None
    zero = torch.zeros_like(ls.env.wall_time)
    rw, dt = zero, zero.clone()
    rs = torch.zeros_like(ls.env.round_ready)
    k = rng
    while True:
        has = _has_pending_event(ls.env)
        stuck = (ls.mode == M_EVENT) & ~has & ~ls.env.round_ready
        cond = (ls.mode != M_DECIDE) & ~_lane_done(ls.env) & ~stuck
        if not bool(cond.any()):
            break
        sub = k
        if auto_reset:  # the key chain only feeds auto-reset draws
            keys = prng.split(k)
            k, sub = _w(cond, keys[:, 0], k), keys[:, 1]
        out = drain_micro_step(
            params, bank, ls, sub, auto_reset, event_bulk, bulk_events,
            bulk_cycles, t_ref, bulk_fused, masked=False,
            telemetry=telemetry, count_on=cond if track else None,
        )
        nxt, (r, d, re) = out[0], out[1]
        if track:
            telemetry = out[2]
        ls = select(cond, nxt, ls)
        rw = torch.where(cond, rw + r, rw)
        dt = torch.where(cond, dt + d, dt)
        rs = torch.where(cond, rs | re, rs)
    return (ls, (rw, dt, rs), telemetry) if track else (ls, (rw, dt, rs))


def apply_and_drain(params: EnvParams, bank: WorkloadBank, ls: LoopState,
                    stage_idx, num_exec, rng: torch.Tensor,
                    auto_reset: bool = False, event_bulk: bool = True,
                    bulk_events: int = 8, fulfill_bulk: bool = True,
                    bulk_cycles: int = 1, bulk_fused: bool = True,
                    telemetry=None, **unknown):
    """One precomputed decision per lane applied and drained to the next
    decision point: `decide_micro_step` then `drain_to_decision`, with
    the discount reference at each lane's wall time on entry and the
    lane's key split between them. The engine knobs default as in the
    JAX package; any other keyword is refused (`core.check_knobs`).
    Returns `(ls, (decided, reward, dt, reset))`, and with `telemetry`
    the counters as a third element."""
    core.check_knobs(unknown)
    track = telemetry is not None
    keys = prng.split(rng)
    t_ref = ls.env.wall_time
    out = decide_micro_step(
        params, bank, ls, stage_idx, num_exec, keys[:, 0], auto_reset,
        fulfill_bulk, t_ref, telemetry,
    )
    ls2, (decided, rw1, dt1, rs1) = out[0], out[1]
    out = drain_to_decision(
        params, bank, ls2, keys[:, 1], auto_reset, event_bulk, bulk_events,
        bulk_cycles, t_ref, bulk_fused, out[2] if track else None,
    )
    ls3, (rw2, dt2, rs2) = out[0], out[1]
    rec = (decided, rw1 + rw2, dt1 + dt2, rs1 | rs2)
    return (ls3, rec, out[2]) if track else (ls3, rec)


def run_flat(params: EnvParams, bank: WorkloadBank, policy_fn,
             rng: torch.Tensor, num_groups: int,
             state: EnvState | None = None, auto_reset: bool = True,
             compute_levels: bool = True, event_burst: int = 1,
             event_bulk: bool = True, bulk_events: int = 8,
             fulfill_bulk: bool = False, bulk_cycles: int = 1,
             loop_state: LoopState | None = None,
             bulk_fused: bool = True, telemetry=None):
    """`num_groups` micro-step groups per lane, each one `micro_step`
    plus `event_burst - 1` `event_micro_step`s, from a freshly reset
    `state` or, to continue an earlier run, from `loop_state`. `rng`
    holds one key per lane; each micro-step splits it. Returns the
    LoopState, and with `telemetry` `(ls, telemetry)`."""
    track = telemetry is not None
    ls = init_loop_state(state) if loop_state is None else loop_state
    k = rng
    for _ in range(num_groups):
        keys = prng.split(k)
        k = keys[:, 0]
        out = micro_step(params, bank, policy_fn, ls, keys[:, 1], auto_reset,
                         compute_levels, event_bulk, bulk_events,
                         fulfill_bulk, bulk_cycles, bulk_fused, telemetry)
        ls, telemetry = out if track else (out, None)
        for _ in range(event_burst - 1):
            keys = prng.split(k)
            k = keys[:, 0]
            out = event_micro_step(params, bank, ls, keys[:, 1], auto_reset,
                                   event_bulk, bulk_events, bulk_cycles,
                                   bulk_fused, telemetry)
            ls, telemetry = out if track else (out, None)
    return (ls, telemetry) if track else ls
