"""The Spark scheduling simulator's engine (counterpart of
`sparksched_tpu/env/core.py`, its sequential, non-bulk part).

The JAX package writes each function for ONE lane and vmaps it; a
`lax.cond` over a lane-dependent predicate then computes both branches
and selects. Here every function takes the whole lane batch (leading
axis `[B]`): a per-lane scalar is a `[B]` tensor, and a branch becomes a
masked update that is an exact no-op on the lanes whose mask is off (the
`en` arguments). Gathers clamp their indices, so a masked-off lane may
read garbage but never out of bounds; wherever the JAX package's value
matters its indices are in range, so the clamp changes nothing there.

Action encoding, clamping of invalid actions and the reference
semantics are the JAX package's (see its module docstring). The bulk
passes (`_bulk_fulfill`, `_bulk_relaunch`, `_bulk_ready`,
`_bulk_events_fused`) are not ported yet: the sequential engine below
is what the JAX package runs with `event_bulk=False, fulfill_bulk=False`.
"""

from __future__ import annotations

import torch

from .. import prng
from ..config import EnvParams
from ..workload.bank import WorkloadBank
from ..workload.sampling import sample_job_sequence, sample_task_duration
from .state import (
    BIG_SEQ,
    FIELDS,
    EV_EXECUTOR_READY,
    EV_JOB_ARRIVAL,
    EV_TASK_FINISHED,
    INF,
    EnvState,
    empty_state,
    topo_levels,
)

_i32 = torch.int32

# move-request kinds produced by event phase-A handlers
RQ_NONE, RQ_START, RQ_MOVE = 0, 1, 2
# resolved action kinds consumed by _apply_action
A_NONE, A_START, A_SEND, A_IDLE, A_PARK = 0, 1, 2, 3, 4


# --------------------------------------------------------------------------
# batched helpers
# --------------------------------------------------------------------------


def _lane(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View a per-lane `[B]` (or `[B,...]`) mask so it broadcasts
    against `like`."""
    return m.reshape(m.shape + (1,) * (like.dim() - m.dim()))


def _w(m: torch.Tensor, a, b: torch.Tensor) -> torch.Tensor:
    """`where(m, a, b)` with a lane mask broadcast over `b`'s dims,
    keeping `b`'s dtype."""
    return torch.where(_lane(m, b), a, b).to(b.dtype)


def _g(x: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather `x[b, i0[b], i1[b], ...]`, indices clamped."""
    b = torch.arange(x.shape[0], device=x.device)
    ii = tuple(
        i.long().clamp(0, x.shape[d + 1] - 1) for d, i in enumerate(idx)
    )
    return x[(b,) + ii]


def _onehot(n: int, e: torch.Tensor) -> torch.Tensor:
    """bool[B,n]; all-false where e is out of range (e.g. -1)."""
    return torch.arange(n, device=e.device) == e[:, None]


def _onehot2(j_cap: int, s_cap: int, j: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    return _onehot(j_cap, j)[:, :, None] & _onehot(s_cap, s)[:, None, :]


def _full(like: torch.Tensor, v: int) -> torch.Tensor:
    return torch.full(like.shape[:1], v, dtype=_i32, device=like.device)


def _i(x: torch.Tensor) -> torch.Tensor:
    return x.to(_i32)


# --------------------------------------------------------------------------
# schedulable-stage computation
# --------------------------------------------------------------------------


def find_schedulable(params: EnvParams, state: EnvState,
                     source_job_id: torch.Tensor) -> torch.Tensor:
    """bool[B,J,S]: job passes the saturation filter (source job exempt),
    stage ready (unsaturated, all parents saturated), not yet selected."""
    j_idx = torch.arange(params.max_jobs, device=source_job_id.device)
    job_ok = state.job_active & (
        (j_idx[None, :] == source_job_id[:, None])
        | (state.job_supply < params.num_executors)
    )
    ready = state.stage_exists & ~state.stage_sat & (
        state.unsat_parent_count == 0
    )
    return job_ok[:, :, None] & ready & ~state.stage_selected


def _refresh_sat(state: EnvState, j, s, enable) -> EnvState:
    """Recompute saturation of stage (j,s) after a demand mutation and
    propagate the flip to its children's unsaturated-parent counts."""
    demand = (
        _g(state.stage_remaining, j, s)
        - _g(state.moving_count, j, s)
        - _g(state.commit_count, j, s)
    )
    new = demand <= 0
    old = _g(state.stage_sat, j, s)
    delta = torch.where(
        enable & _g(state.stage_exists, j, s), _i(new) - _i(old), 0
    )
    j_cap, s_cap = state.stage_sat.shape[1:]
    oj = _onehot(j_cap, j)
    m2 = oj[:, :, None] & _onehot(s_cap, s)[:, None, :]
    adj_row = _g(state.adj, j, s)  # [B,S]
    return state.replace(
        stage_sat=torch.where(
            m2 & _lane(enable, m2), _lane(new, m2), state.stage_sat
        ),
        unsat_parent_count=state.unsat_parent_count
        - _i(delta[:, None, None] * (oj[:, :, None] & adj_row[:, None, :])),
    )


# --------------------------------------------------------------------------
# executor pool moves
# --------------------------------------------------------------------------


def _move_idle_from_pool(state: EnvState, pj, ps, mask) -> EnvState:
    """_move_idle_executors (reference :745-782) for the executors in
    `mask` ([B,N]; callers fold their lane enables into it)."""
    sat = _g(state.job_saturated, torch.clamp_min(pj, 0))
    noop = (pj < 0) | ((ps < 0) & ~sat)
    m = mask & ~noop[:, None]
    to_common = m & sat[:, None]
    return state.replace(
        exec_at_common=state.exec_at_common | to_common,
        exec_job=torch.where(to_common, -1, state.exec_job),
        exec_stage=torch.where(m, -1, state.exec_stage),
        exec_task_valid=state.exec_task_valid & ~to_common,
    )


def _exec_location(state: EnvState, e):
    """Pool key of executor e: (-1,-1) for common; (job, stage|-1)."""
    common = _g(state.exec_at_common, e)
    pj = torch.where(common, -1, _g(state.exec_job, e))
    ps = torch.where(common, -1, _g(state.exec_stage, e))
    return pj, ps


# --------------------------------------------------------------------------
# backup scheduling and move resolution
# --------------------------------------------------------------------------


def _find_backup_stage(params: EnvParams, state: EnvState, e, quirk_src):
    """Local-then-global search for a stage to absorb executor e,
    including the reference's `if not source_job_id` quirk."""
    own = _g(state.exec_job, e)
    eff_src = torch.where(own == 0, quirk_src, own)
    sched = find_schedulable(params, state, eff_src)
    b, j_cap, s_cap = sched.shape
    flat = sched.reshape(b, -1)
    job_of = torch.arange(j_cap * s_cap, device=flat.device) // s_cap
    local = flat & (job_of[None, :] == own[:, None])
    other = flat & (job_of[None, :] != own[:, None])
    local_any = local.any(1)
    local_idx = torch.argmax(local.to(torch.uint8), 1)
    other_any = other.any(1)
    other_idx = torch.argmax(other.to(torch.uint8), 1)
    found = local_any | other_any
    idx = torch.where(local_any, local_idx, other_idx)
    return found, _i(idx // s_cap), _i(idx % s_cap)


def _resolve_action(params: EnvParams, state: EnvState, req_kind, e, rj,
                    rs, quirk_src):
    """Resolve a phase-A move request into a concrete action."""
    j = torch.clamp_min(rj, 0)
    s = torch.clamp_min(rs, 0)
    saturated = _g(state.stage_remaining, j, s) == 0
    found, bj, bs = _find_backup_stage(params, state, e, quirk_src)
    use_backup = saturated & found
    tj = torch.where(use_backup, bj, j)
    ts = torch.where(use_backup, bs, s)
    dead = saturated & ~found
    send = _g(state.exec_job, e) != tj
    start = _g(state.frontier, tj, ts)
    ak_move = torch.where(
        dead, A_IDLE,
        torch.where(send, A_SEND, torch.where(start, A_START, A_PARK)),
    )
    ak = torch.where(
        req_kind == RQ_MOVE, ak_move,
        torch.where(req_kind == RQ_START, A_START, A_NONE),
    )
    tj = torch.where(req_kind == RQ_MOVE, tj, j)
    ts = torch.where(req_kind == RQ_MOVE, ts, s)
    return _i(ak), _i(tj), _i(ts)


def _apply_action(params: EnvParams, bank: WorkloadBank, state: EnvState,
                  ak, e, tj, ts) -> EnvState:
    """Apply a resolved action on every lane (A_NONE changes nothing but
    the rng, which advances once per call whatever the kind)."""
    keys = prng.split(state.rng)
    rng, sub = keys[:, 0], keys[:, 1]
    n = state.exec_job.shape[1]
    e = e.clamp(0, n - 1)
    tpl = _g(state.job_template, tj)
    num_local = _i((state.exec_job == tj[:, None]).sum(1))
    dur = sample_task_duration(
        params, bank, prng.uniform(sub, (2,)), tpl, ts, num_local,
        _g(state.exec_task_valid, e), _g(state.exec_task_stage, e) == ts,
    )

    j_cap, s_cap = state.stage_remaining.shape[1:]
    one_e = _onehot(n, e)
    oj = _onehot(j_cap, tj)
    m2 = _onehot2(j_cap, s_cap, tj, ts)

    is_start = ak == A_START
    is_send = ak == A_SEND
    is_idle = ak == A_IDLE
    is_park = ak == A_PARK

    pj, ps = _exec_location(state, e)
    pool_sat = _g(state.job_saturated, torch.clamp_min(pj, 0))
    idle_eff = is_idle & ~((pj < 0) | ((ps < 0) & ~pool_sat))
    idle_common = idle_eff & pool_sat

    seq = state.seq_counter
    old_job = _g(state.exec_job, e)
    newly_saturated = is_start & (_g(state.stage_remaining, tj, ts) == 1)

    c = lambda m: m[:, None]  # noqa: E731  lane scalar -> [B,1]
    m2_start = m2 & is_start[:, None, None]
    e_send = one_e & c(is_send)
    e_start = one_e & c(is_start)

    state = state.replace(
        rng=rng,
        seq_counter=seq + _i(is_start | is_send),
        exec_stage=torch.where(
            one_e & c(is_start | is_send | idle_eff | is_park),
            torch.where(c(is_start), c(ts), -1),
            state.exec_stage,
        ).to(_i32),
        exec_task_valid=torch.where(
            one_e & c(is_start | is_send | idle_common | is_park),
            c(is_start), state.exec_task_valid,
        ),
        exec_at_common=torch.where(
            one_e & c(is_send | idle_common), c(idle_common),
            state.exec_at_common,
        ),
        exec_job=torch.where(
            one_e & c(is_send | idle_common), -1, state.exec_job
        ),
        exec_moving=state.exec_moving | e_send,
        exec_dst_job=torch.where(e_send, c(tj), state.exec_dst_job),
        exec_dst_stage=torch.where(e_send, c(ts), state.exec_dst_stage),
        exec_arrive_time=torch.where(
            e_send, c(state.wall_time + params.moving_delay),
            state.exec_arrive_time,
        ),
        exec_arrive_seq=torch.where(e_send, c(seq), state.exec_arrive_seq),
        exec_executing=state.exec_executing | e_start,
        exec_task_stage=torch.where(e_start, c(ts), state.exec_task_stage),
        exec_finish_time=torch.where(
            e_start, c(state.wall_time + dur), state.exec_finish_time
        ),
        exec_finish_seq=torch.where(e_start, c(seq), state.exec_finish_seq),
        job_supply=state.job_supply
        + _i(oj & c(is_send))
        - _i(_onehot(j_cap, old_job) & c(is_send & (old_job >= 0))),
        job_saturated_stages=state.job_saturated_stages
        + _i(oj & c(newly_saturated)),
        stage_remaining=state.stage_remaining - _i(m2_start),
        stage_executing=state.stage_executing + _i(m2_start),
        stage_duration=torch.where(
            m2_start, dur[:, None, None], state.stage_duration
        ),
        moving_count=state.moving_count + _i(m2 & is_send[:, None, None]),
    )
    return _refresh_sat(state, tj, ts, is_start | is_send)


# --------------------------------------------------------------------------
# commitments
# --------------------------------------------------------------------------


def _add_commitment(state: EnvState, n, dj, ds, enable) -> EnvState:
    """Create n commitment slots from the current source pool to (dj, ds)
    on the lanes in `enable`; slots of an existing (src, dst) pair
    inherit its sequence number (dict-insertion order)."""
    src_j, src_s = state.source_job, state.source_stage
    match = (
        state.cm_valid
        & (state.cm_src_job == src_j[:, None])
        & (state.cm_src_stage == src_s[:, None])
        & (state.cm_dst_job == dj[:, None])
        & (state.cm_dst_stage == ds[:, None])
    )
    has_match = match.any(1)
    inherited = torch.where(match, state.cm_seq, BIG_SEQ).amin(1)
    seq = torch.where(has_match, inherited, state.seq_counter)
    n = torch.where(enable, n, 0)

    free = ~state.cm_valid
    take = free & (torch.cumsum(_i(free), 1) <= n[:, None])

    j_cap, s_cap = state.commit_count.shape[1:]
    oj = _onehot(j_cap, dj)
    supply = state.job_supply + _i(n[:, None] * (oj & (dj != src_j)[:, None]))
    cc = state.commit_count + _i(
        n[:, None, None] * _onehot2(j_cap, s_cap, dj, ds)
    )
    c = lambda v: v[:, None]  # noqa: E731
    state = state.replace(
        seq_counter=state.seq_counter + _i(enable & ~has_match),
        job_supply=supply,
        commit_count=cc,
        cm_valid=state.cm_valid | take,
        cm_src_job=torch.where(take, c(src_j), state.cm_src_job),
        cm_src_stage=torch.where(take, c(src_s), state.cm_src_stage),
        cm_dst_job=torch.where(take, c(dj), state.cm_dst_job),
        cm_dst_stage=torch.where(take, c(ds), state.cm_dst_stage),
        cm_seq=torch.where(take, c(seq), state.cm_seq),
    )
    return _refresh_sat(
        state, torch.clamp_min(dj, 0), torch.clamp_min(ds, 0),
        enable & (dj >= 0),
    )


def _commit_remaining(state: EnvState, enable) -> EnvState:
    """Commit the source's uncommitted executors to the common pool."""
    n = state.num_committable()
    m1 = _full(n, -1)
    return _add_commitment(state, n, m1, m1, enable & (n > 0))


def _peek_commitment(state: EnvState, pj, ps):
    """First outgoing commitment from pool (pj, ps) in insertion order.
    Returns (exists[B], slot[B])."""
    match = (
        state.cm_valid
        & (state.cm_src_job == pj[:, None])
        & (state.cm_src_stage == ps[:, None])
    )
    key = torch.where(match, state.cm_seq, BIG_SEQ)
    return match.any(1), _i(torch.argmin(key, 1))


def _fulfill_commitment_phase_a(state: EnvState, e, slot, enable):
    """Consume one commitment slot with executor e on the lanes in
    `enable`. Returns (state, req_kind, rj, rs)."""
    dj = _g(state.cm_dst_job, slot)
    ds = _g(state.cm_dst_stage, slot)
    sj = _g(state.cm_src_job, slot)
    n = state.cm_valid.shape[1]
    j_cap, s_cap = state.commit_count.shape[1:]
    oj = _onehot(j_cap, dj)
    m2 = _onehot2(j_cap, s_cap, dj, ds)
    en = enable[:, None]
    state = state.replace(
        cm_valid=state.cm_valid & ~(_onehot(n, slot) & en),
        job_supply=state.job_supply - _i(oj & (dj != sj)[:, None] & en),
        commit_count=state.commit_count - _i(m2 & en[:, :, None]),
    )
    state = _refresh_sat(
        state, torch.clamp_min(dj, 0), torch.clamp_min(ds, 0),
        enable & (dj >= 0),
    )
    to_common = dj < 0
    pj, ps = _exec_location(state, e)
    state = _move_idle_from_pool(
        state, pj, ps, _onehot(n, e) & (enable & to_common)[:, None]
    )
    rk = _i(torch.where(to_common, RQ_NONE, RQ_MOVE))
    rj = _i(torch.where(to_common, -1, dj))
    rs = _i(torch.where(to_common, -1, ds))
    return state, rk, rj, rs


def _fulfill_from_source(params: EnvParams, bank: WorkloadBank,
                         state: EnvState, active, bulk: bool = False
                         ) -> EnvState:
    """Match the source pool's idle executors against its outstanding
    commitments in insertion order, one candidate at a time, on the lanes
    in `active` (`core.step`'s fulfillment phase; the flat engine runs
    the same body one FULFILL micro-step at a time). Only `bulk=False`
    is ported."""
    if bulk:
        check_knobs({"fulfill_bulk": True})
    n = state.exec_job.shape[1]
    idle = state.source_pool_mask() & ~state.exec_executing
    num_idle = torch.where(active, idle.sum(1), 0)
    pos = torch.arange(n, dtype=_i32, device=idle.device)
    exec_order = _rank_order(torch.where(idle, pos, BIG_SEQ))
    match = (
        state.cm_valid
        & (state.cm_src_job == state.source_job[:, None])
        & (state.cm_src_stage == state.source_stage[:, None])
    )
    slot_order = _rank_order(torch.where(match, state.cm_seq, BIG_SEQ))
    k = torch.zeros_like(num_idle)
    while True:
        on = k < num_idle
        if not bool(on.any()):
            return state
        e = _g(exec_order, k)
        quirk = state.source_job_id()
        st, rk, rj, rs = _fulfill_commitment_phase_a(
            state, e, _g(slot_order, k), on
        )
        ak, tj, ts = _resolve_action(params, st, rk, e, rj, rs, quirk)
        st = _apply_action(params, bank, st, ak, e, tj, ts)
        # lanes past their count keep their state (rng included)
        state = EnvState(**{
            f: _w(on, getattr(st, f), getattr(state, f)) for f in FIELDS
        })
        k = k + on.to(k.dtype)


# --------------------------------------------------------------------------
# node levels
# --------------------------------------------------------------------------


def _job_topo_levels(active_s, adj_s):
    """i32[B,S] topological generation of one job's active nodes per lane
    (single-job form of `topo_levels`)."""
    return topo_levels(active_s, adj_s)


def compute_node_levels(params: EnvParams, state: EnvState) -> torch.Tensor:
    """Golden active-subgraph generations over all jobs (the incremental
    `state.node_level` cache must equal this on the observation's
    node mask)."""
    active = (
        state.job_active[:, :, None]
        & state.stage_exists
        & ~state.stage_completed
    )
    adj_act = state.adj & active[..., :, None] & active[..., None, :]
    return topo_levels(active, adj_act)


# --------------------------------------------------------------------------
# event handlers; each is an exact no-op on lanes with `en` off
# --------------------------------------------------------------------------


def _handle_job_arrival(state: EnvState, j, en):
    state = state.replace(
        job_arrived=state.job_arrived
        | (_onehot(state.job_arrived.shape[1], j) & en[:, None])
    )
    upd = en & state.exec_at_common.any(1)
    state = state.replace(
        source_valid=state.source_valid | upd,
        source_job=_w(upd, -1, state.source_job),
        source_stage=_w(upd, -1, state.source_stage),
    )
    m1 = _full(j, -1)
    return state, _full(j, RQ_NONE), m1, m1


def _handle_executor_ready(state: EnvState, e, en):
    j = _g(state.exec_dst_job, e)
    s = _g(state.exec_dst_stage, e)
    n = state.exec_job.shape[1]
    j_cap, s_cap = state.moving_count.shape[1:]
    one_e = _onehot(n, e) & en[:, None]
    m2 = _onehot2(j_cap, s_cap, j, s) & en[:, None, None]
    state = state.replace(
        moving_count=state.moving_count - _i(m2),
        exec_moving=state.exec_moving & ~one_e,
        exec_arrive_time=torch.where(one_e, INF, state.exec_arrive_time),
        exec_at_common=state.exec_at_common & ~one_e,
        exec_job=torch.where(one_e, j[:, None], state.exec_job),
        exec_stage=torch.where(one_e, -1, state.exec_stage),
    )
    state = _refresh_sat(state, j, s, en)
    return state, _full(j, RQ_MOVE), j, s


def _handle_task_finished(state: EnvState, e, en):
    j = _g(state.exec_job, e)
    s = _g(state.exec_task_stage, e)
    n = state.exec_job.shape[1]
    j_cap, s_cap = state.stage_executing.shape[1:]
    one_e = _onehot(n, e) & en[:, None]
    oj = _onehot(j_cap, j)
    m2 = oj[:, :, None] & _onehot(s_cap, s)[:, None, :]
    m2e = m2 & en[:, None, None]
    frontier_before = _g(state.frontier, j)  # [B,S]

    state = state.replace(
        stage_executing=state.stage_executing - _i(m2e),
        stage_completed_tasks=state.stage_completed_tasks + _i(m2e),
        exec_executing=state.exec_executing & ~one_e,
        exec_finish_time=torch.where(one_e, INF, state.exec_finish_time),
    )
    more = _g(state.stage_remaining, j, s) > 0
    rel = en & ~more
    st = state

    # --- released: the executor leaves its finished stage ---
    stage_done = _g(st.stage_completed, j, s)
    done = rel & stage_done
    st = st.replace(
        incomplete_parent_count=st.incomplete_parent_count
        - _i(done[:, None, None] & oj[:, :, None]
             & _g(st.adj, j, s)[:, None, :])
    )
    # node-level cache: recompute job j's row on lanes that completed a
    # stage (skipped when none did — the masked update is then a no-op)
    if bool(done.any()):
        act_row = _g(st.stage_exists, j) & ~_g(st.stage_completed, j)
        adj_row = _g(st.adj, j) & act_row[:, :, None] & act_row[:, None, :]
        lvl_row = _job_topo_levels(act_row, adj_row)
        st = st.replace(
            node_level=torch.where(
                (done[:, None] & oj)[:, :, None], lvl_row[:, None, :],
                st.node_level,
            )
        )
    new_frontier = _g(st.frontier, j) & ~frontier_before
    did_change = stage_done & new_frontier.any(1)
    job_done = _g(st.job_completed, j)

    cj = rel & job_done & torch.isinf(_g(st.job_t_completed, j))
    pool = st.pool_member_mask(j, _full(j, -1)) & ~st.exec_executing
    st = _move_idle_from_pool(st, j, _full(j, -1), pool & cj[:, None])
    st = st.replace(
        job_t_completed=torch.where(
            oj & cj[:, None], st.wall_time[:, None], st.job_t_completed
        )
    )

    has_cm, slot = _peek_commitment(st, j, s)
    st, rk_f, rj_f, rs_f = _fulfill_commitment_phase_a(
        st, e, slot, rel & has_cm
    )
    no_cm = rel & ~has_cm
    st = st.replace(exec_task_valid=st.exec_task_valid & ~(one_e & no_cm[:, None]))
    st = _move_idle_from_pool(
        st, j, s, one_e & (no_cm & did_change)[:, None]
    )
    rk_r = torch.where(has_cm, rk_f, RQ_NONE)
    rj_r = torch.where(has_cm, rj_f, -1)
    rs_r = torch.where(has_cm, rs_f, -1)

    # _update_executor_source (reference :662-674)
    set_job_pool = rel & did_change
    set_stage_pool = rel & ~did_change & ~has_cm
    any_set = set_job_pool | set_stage_pool
    st = st.replace(
        source_valid=st.source_valid | any_set,
        source_job=torch.where(any_set, j, st.source_job),
        source_stage=torch.where(
            set_job_pool, -1, torch.where(set_stage_pool, s, st.source_stage)
        ).to(_i32),
    )
    rk = _i(torch.where(more, RQ_START, rk_r))
    rj = _i(torch.where(more, j, rj_r))
    rs = _i(torch.where(more, s, rs_r))
    return st, rk, rj, rs


# --------------------------------------------------------------------------
# event selection
# --------------------------------------------------------------------------


def _next_event(params: EnvParams, state: EnvState):
    """Lexicographic (time, seq) argmin over all pending events.
    Returns (has[B], t[B], kind[B], arg[B])."""
    t_job = torch.where(state.job_arrived, INF, state.job_arrival_time)
    times = torch.cat(
        [t_job, state.exec_finish_time, state.exec_arrive_time], 1
    )
    seqs = torch.cat(
        [state.job_arrival_seq, state.exec_finish_seq,
         state.exec_arrive_seq], 1
    )
    tmin = times.amin(1)
    has = torch.isfinite(tmin)
    cand = times == tmin[:, None]
    idx = _i(torch.argmin(torch.where(cand, seqs, BIG_SEQ), 1))
    j_cap = params.max_jobs
    n = params.num_executors
    kind = torch.where(
        idx < j_cap, EV_JOB_ARRIVAL,
        torch.where(idx < j_cap + n, EV_TASK_FINISHED, EV_EXECUTOR_READY),
    )
    arg = torch.where(
        idx < j_cap, idx,
        torch.where(idx < j_cap + n, idx - j_cap, idx - j_cap - n),
    )
    return has, tmin, _i(kind), _i(arg)


def _has_pending_event(state: EnvState) -> torch.Tensor:
    t = torch.minimum(
        torch.where(state.job_arrived, INF, state.job_arrival_time).amin(1),
        torch.minimum(
            state.exec_finish_time.amin(1), state.exec_arrive_time.amin(1)
        ),
    )
    return torch.isfinite(t)


def _rank_order(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending order of `key` along the last axis (ties break by
    index) — the JAX package's pairwise-rank form computes the same."""
    return _i(torch.argsort(key, dim=-1, stable=True))


# --------------------------------------------------------------------------
# reward
# --------------------------------------------------------------------------


def _compute_jobtime(params: EnvParams, state: EnvState, t_old, active_old,
                     t_ref=None) -> torch.Tensor:
    """Total (optionally beta-discounted) job-time over [t_old, wall]."""
    t_new = state.wall_time
    m = active_old | state.job_active
    start = torch.maximum(state.job_arrival_time, t_old[:, None])
    end = torch.minimum(state.job_t_completed, t_new[:, None])
    if params.beta == 0.0:
        per = end - start
    else:
        ref = (t_old if t_ref is None else t_ref)[:, None]
        b = params.beta * 1e-3
        per = torch.exp(-b * (start - ref)) - torch.exp(-b * (end - ref))
    total = torch.where(m, per, 0.0).sum(1)
    if params.beta > 0.0:
        total = total / params.beta
    return torch.where(t_new == t_old, 0.0, total)


# --------------------------------------------------------------------------
# public API: reset
# --------------------------------------------------------------------------


def reset(params: EnvParams, bank: WorkloadBank, rng: torch.Tensor
          ) -> EnvState:
    """Sample a fresh episode per key of `rng` ([B,2])."""
    return reset_pair(params, bank, rng, prng.fold_in(rng, 1))


def reset_pair(params: EnvParams, bank: WorkloadBank, seq_rng, lane_rng
               ) -> EnvState:
    """Reset with separate keys for the job sequence / time limit and the
    per-lane stochastic stream."""
    keys = prng.split(seq_rng)
    k_limit, k_seq = keys[:, 0], keys[:, 1]
    b = seq_rng.shape[0]
    if params.mean_time_limit is None:
        time_limit = torch.full((b,), INF, device=seq_rng.device)
    else:
        time_limit = prng.exponential(k_limit) * params.mean_time_limit
    arrivals, templates, num_jobs, mask = sample_job_sequence(
        params, bank, k_seq, time_limit
    )
    return reset_from_sequence(
        params, bank, lane_rng, time_limit, arrivals, templates, num_jobs,
        mask,
    )


def reset_from_sequence(params: EnvParams, bank: WorkloadBank, rng,
                        time_limit, arrivals, templates, num_jobs, mask
                        ) -> EnvState:
    """Reset with an explicitly provided job sequence per lane."""
    state = empty_state(params, rng)
    s_cap = params.max_stages
    t = templates.long()
    ns = torch.where(mask, bank.num_stages[t], 0).to(_i32)
    exists = torch.arange(s_cap, device=rng.device)[None, None, :] < \
        ns[:, :, None]
    ntasks = torch.where(exists, bank.num_tasks[t], 0).to(_i32)
    rough = torch.where(exists, bank.rough_duration[t], 0.0)
    adj = bank.adj[t] & exists[..., :, None] & exists[..., None, :]
    sat0 = ntasks <= 0
    unsat0 = _i((adj & (~sat0 & exists)[..., :, None]).sum(-2))
    ipc0 = _i(adj.sum(-2))
    b = rng.shape[0]
    state = state.replace(
        stage_sat=sat0,
        unsat_parent_count=unsat0,
        incomplete_parent_count=ipc0,
        node_level=topo_levels(exists, adj),
        time_limit=time_limit.to(torch.float32),
        seq_counter=num_jobs.to(_i32),
        job_template=templates.to(_i32),
        job_arrival_time=arrivals.to(torch.float32),
        job_arrival_seq=torch.arange(
            params.max_jobs, dtype=_i32, device=rng.device
        ).expand(b, -1).clone(),
        job_num_stages=ns,
        num_jobs=num_jobs.to(_i32),
        stage_exists=exists,
        stage_num_tasks=ntasks,
        stage_remaining=ntasks.clone(),
        stage_duration=rough,
        adj=adj,
    )
    t0 = mask & (arrivals == 0.0)
    state = state.replace(
        job_arrived=t0,
        source_valid=torch.ones_like(state.source_valid),
        source_job=torch.full_like(state.source_job, -1),
        source_stage=torch.full_like(state.source_stage, -1),
    )
    sched = find_schedulable(params, state, state.source_job_id())
    return state.replace(
        schedulable=sched, round_ready=torch.ones_like(state.round_ready)
    )


def check_knobs(knobs: dict) -> None:
    """The port runs the sequential engine only: of the JAX package's
    engine knobs it takes `event_bulk` and `fulfill_bulk`, both off; the
    bulk passes are a later slice. Any other key is refused."""
    unknown = set(knobs) - {"event_bulk", "fulfill_bulk"}
    if unknown:
        raise ValueError(
            f"unknown engine knobs {sorted(unknown)}: the port takes "
            "event_bulk and fulfill_bulk only"
        )
    for k in ("event_bulk", "fulfill_bulk"):
        if knobs.get(k, False):
            raise NotImplementedError(
                f"{k}=True needs the bulk event passes, which are not "
                "ported yet (ROADMAP queue B1, slice 2: _bulk_fulfill / "
                "_bulk_relaunch / _bulk_ready / _bulk_events_fused); pass "
                "event_bulk=False, fulfill_bulk=False"
            )
