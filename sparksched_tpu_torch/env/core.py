"""The Spark scheduling simulator's engine (counterpart of
`sparksched_tpu/env/core.py`).

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
`_bulk_events_fused`) consume whole runs of simple events in one pass;
their docstrings in the JAX package give the conditions under which
they equal the sequential engine. A `lax.scan` over a pass's uniform
table becomes a loop of masked steps over all lanes, left early once no
lane is live (every later step would be a no-op), and a pass's
`[candidate, executor]` scatters stay one-hot selects (`_exec_scatter`):
an `index_put_` with repeated indices has no defined order on the card.
On a card state `_bulk_events_fused` is one launch of a hand-written
kernel (`kernels/bulk_events.py`); that loop is its plain version,
`_bulk_events_fused_ref`, which CPU states run.
"""

from __future__ import annotations

import torch

from .. import prng
from ..config import EnvParams
from ..kernels.bulk_events import bulk_events_fused
from ..obs.telemetry import add as _tm_add
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


def select_env(m: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-lane `where(m, a, b)` over every field; `a` when all of m."""
    if bool(m.all()):
        return a
    return EnvState(**{f: _w(m, getattr(a, f), getattr(b, f))
                       for f in FIELDS})


def _full(like: torch.Tensor, v: int) -> torch.Tensor:
    return torch.full(like.shape[:1], v, dtype=_i32, device=like.device)


def _i(x: torch.Tensor) -> torch.Tensor:
    return x.to(_i32)


def _gk(x: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather of K entries `x[b, i0[b,k], i1[b,k], ...]`
    (`[B,K,...]`), indices clamped."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    ii = tuple(
        i.long().clamp(0, x.shape[d + 1] - 1) for d, i in enumerate(idx)
    )
    return x[(b,) + ii]


def _f(m: torch.Tensor) -> torch.Tensor:
    return m.to(torch.float32)


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
    rng, us = prng.split_uniform(state.rng, (2,))
    n = state.exec_job.shape[1]
    e = e.clamp(0, n - 1)
    tpl = _g(state.job_template, tj)
    num_local = _i((state.exec_job == tj[:, None]).sum(1))
    dur = sample_task_duration(
        params, bank, us, tpl, ts, num_local,
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


def _exec_scatter(sel: torch.Tensor):
    """Masked per-executor scatter helpers over a `[B, candidate,
    executor]` selection in which every executor is selected at most
    once (shared by the bulk passes)."""

    def exset(base, cond, payload):
        msel = sel & cond[:, :, None]
        val = torch.where(msel, payload[:, :, None], 0).sum(1)
        return torch.where(msel.any(1), val.to(base.dtype), base)

    def exflag(base, cond, value):
        return torch.where((sel & cond[:, :, None]).any(1), value, base)

    return exset, exflag


def _bulk_fulfill(params: EnvParams, bank: WorkloadBank, state: EnvState,
                  num_idle, exec_order, slot_order):
    """Consume the maximal *simple* prefix of the fulfillment phase in one
    vectorized pass; returns (state, m[B]): candidates 0..m-1 of the
    (exec_order, slot_order) pairing are processed, the caller finishes
    the rest one at a time. A lane with `num_idle` 0 is left exactly as
    it was (rng included). See the JAX package's docstring for when a
    candidate is simple."""
    b, n = state.exec_job.shape
    j_cap, s_cap = state.stage_remaining.shape[1:]
    dev = state.exec_job.device
    pos = torch.arange(n, dtype=_i32, device=dev)

    e = exec_order
    slot = slot_order
    dj = _gk(state.cm_dst_job, slot)
    ds0 = _gk(state.cm_dst_stage, slot)
    sjs = _gk(state.cm_src_job, slot)
    ejob = _gk(state.exec_job, e)
    djc = dj.clamp(0, j_cap - 1)
    dsc = ds0.clamp(0, s_cap - 1)

    valid = pos[None, :] < num_idle[:, None]
    common_dst = dj < 0
    send0 = ~common_dst & (ejob != dj)
    frontier_k = _gk(state.frontier, djc, dsc)
    start0 = ~common_dst & ~send0 & frontier_k
    park0 = ~common_dst & ~send0 & ~frontier_k

    flat = djc * s_cap + dsc
    stage_pair = (
        (flat[:, None, :] == flat[:, :, None])
        & ~common_dst[:, None, :]
        & ~common_dst[:, :, None]
    )
    earlier = (pos[None, :] < pos[:, None])[None]
    cum_starts = (earlier & stage_pair & start0[:, None, :]).sum(-1)
    rem0 = _gk(state.stage_remaining, djc, dsc)
    saturated = ~common_dst & (rem0 - cum_starts == 0)
    ok = valid & ~saturated
    prefix = (torch.cumsum(_i(~ok), 1) == 0) & valid
    m = _i(prefix.sum(1))

    send = send0 & prefix
    start = start0 & prefix
    park = park0 & prefix
    common_k = common_dst & prefix

    # source-pool saturation at each candidate's turn (see JAX)
    src_j = state.source_job
    src_s = state.source_stage
    newly_exh = start & (rem0 - cum_starts == 1)
    exh_src_before = (
        earlier & (newly_exh & (dj == src_j[:, None]))[:, None, :]
    ).sum(-1)
    src_jc = src_j.clamp_min(0)
    src_sat_k = (
        _g(state.job_saturated_stages, src_jc)[:, None] + exh_src_before
    ) >= _g(state.job_num_stages, src_jc)[:, None]
    noop_move = (src_j < 0)[:, None] | ((src_s < 0)[:, None] & ~src_sat_k)
    to_common = common_k & ~noop_move & src_sat_k
    moved_any = common_k & ~noop_move

    # executor-on-destination-job count at each candidate's turn
    leaver = (send | to_common) & (ejob >= 0)
    leavers_before = (earlier & leaver[:, None, :]).sum(-1)
    base_nl = (state.exec_job[:, None, :] == dj[:, :, None]).sum(-1)
    nl = base_nl - torch.where(dj == src_j[:, None], leavers_before, 0)

    rng_next, us = prng.split_uniform(state.rng, (n, 2))
    tpl = _gk(state.job_template, djc)
    tv = _gk(state.exec_task_valid, e)
    ss_same = _gk(state.exec_task_stage, e) == ds0
    durs = sample_task_duration(params, bank, us, tpl, dsc, nl, tv, ss_same)

    inc = _i(start | send)
    seq_k = state.seq_counter[:, None] + (
        earlier & (inc[:, None, :] > 0)).sum(-1)
    n_inc = inc.sum(1)

    fin_k = state.wall_time[:, None] + durs
    arr_k = (state.wall_time + params.moving_delay)[:, None].expand(b, n)

    # ---- per-executor scatters (each candidate's executor is unique)
    sel = prefix[:, :, None] & (e[:, :, None] == pos[None, None, :])
    exset, exflag = _exec_scatter(sel)

    minus1 = torch.full((b, n), -1, dtype=_i32, device=dev)
    exec_stage = exset(
        state.exec_stage, start | send | park | moved_any,
        torch.where(start, ds0, minus1),
    )
    exec_task_valid = exflag(
        exflag(state.exec_task_valid, send | park | to_common, False),
        start, True,
    )
    exec_at_common = exflag(
        exflag(state.exec_at_common, send, False), to_common, True
    )
    exec_job = exset(state.exec_job, send | to_common, minus1)
    exec_moving = exflag(state.exec_moving, send, True)
    exec_dst_job = exset(state.exec_dst_job, send, dj)
    exec_dst_stage = exset(state.exec_dst_stage, send, ds0)
    exec_arrive_time = exset(state.exec_arrive_time, send, arr_k)
    exec_arrive_seq = exset(state.exec_arrive_seq, send, seq_k)
    exec_executing = exflag(state.exec_executing, start, True)
    exec_task_stage = exset(state.exec_task_stage, start, ds0)
    exec_finish_time = exset(state.exec_finish_time, start, fin_k)
    exec_finish_seq = exset(state.exec_finish_seq, start, seq_k)

    # ---- commitment slots (every prefix candidate consumes one)
    consumed = (
        prefix[:, :, None] & (slot[:, :, None] == pos[None, None, :])
    ).any(1)
    cm_valid = state.cm_valid & ~consumed

    # ---- per-stage counters (destination stages)
    oh_j = (
        (dj[:, :, None] == torch.arange(j_cap, dtype=_i32, device=dev))
        & prefix[:, :, None]
        & ~common_dst[:, :, None]
    )  # [B, cand, J]
    oh_s = ds0[:, :, None] == torch.arange(s_cap, dtype=_i32, device=dev)
    m3 = oh_j[:, :, :, None] & oh_s[:, :, None, :]  # [B, cand, J, S]
    cnt_start = _i((m3 & start[:, :, None, None]).sum(1))
    cnt_send = _i((m3 & send[:, :, None, None]).sum(1))
    cnt_slot = _i(m3.sum(1))
    stage_remaining = state.stage_remaining - cnt_start
    stage_executing = state.stage_executing + cnt_start
    moving_count = state.moving_count + cnt_send
    commit_count = state.commit_count - cnt_slot

    later = (pos[None, :] > pos[:, None])[None]
    is_last_start = start & ~(later & stage_pair & start[:, None, :]).any(-1)
    dur_js = (
        _f(m3 & is_last_start[:, :, None, None]) * durs[:, :, None, None]
    ).sum(1)
    stage_duration = torch.where(cnt_start > 0, dur_js, state.stage_duration)

    # ---- per-job counters
    job_supply = _i(
        state.job_supply
        - (oh_j & (dj != sjs)[:, :, None]).sum(1)  # slot consumption
        + (oh_j & send[:, :, None]).sum(1)  # arrivals in transit
        - _i(_onehot(j_cap, src_jc))
        * torch.where(src_j >= 0, (send & (ejob >= 0)).sum(1), 0)[:, None]
    )
    job_saturated_stages = state.job_saturated_stages + _i(
        (oh_j & newly_exh[:, :, None]).sum(1)
    )

    # ---- saturation-cache refresh for every touched destination stage
    aff = cnt_slot > 0
    demand = stage_remaining - moving_count - commit_count
    sat_new = demand <= 0
    is_rep = prefix & ~common_dst & ~(earlier & stage_pair).any(-1)
    delta_k = torch.where(
        is_rep & _gk(state.stage_exists, djc, dsc),
        _i(_gk(sat_new, djc, dsc)) - _i(_gk(state.stage_sat, djc, dsc)),
        0,
    )
    adj_row = _gk(state.adj, djc, dsc)  # [B, cand, S]
    unsat = _i(state.unsat_parent_count - (
        _i(oh_j)[:, :, :, None]
        * (delta_k[:, :, None] * _i(adj_row))[:, :, None, :]
    ).sum(1))

    bulked = m > 0
    state = state.replace(
        rng=_w(bulked, rng_next, state.rng),
        seq_counter=_i(state.seq_counter + n_inc),
        exec_stage=exec_stage,
        exec_task_valid=exec_task_valid,
        exec_at_common=exec_at_common,
        exec_job=exec_job,
        exec_moving=exec_moving,
        exec_dst_job=exec_dst_job,
        exec_dst_stage=exec_dst_stage,
        exec_arrive_time=exec_arrive_time,
        exec_arrive_seq=exec_arrive_seq,
        exec_executing=exec_executing,
        exec_task_stage=exec_task_stage,
        exec_finish_time=exec_finish_time,
        exec_finish_seq=exec_finish_seq,
        cm_valid=cm_valid,
        stage_remaining=stage_remaining,
        stage_executing=stage_executing,
        moving_count=moving_count,
        commit_count=commit_count,
        stage_duration=stage_duration,
        job_supply=job_supply,
        job_saturated_stages=job_saturated_stages,
        stage_sat=torch.where(aff, sat_new, state.stage_sat),
        unsat_parent_count=unsat,
    )
    return state, m


def _fulfill_from_source(params: EnvParams, bank: WorkloadBank,
                         state: EnvState, active, bulk: bool = True,
                         telemetry=None):
    """Match the source pool's idle executors against its outstanding
    commitments in insertion order, on the lanes in `active`
    (`core.step`'s fulfillment phase). With `bulk`, the simple prefix is
    consumed in one `_bulk_fulfill` pass and only the backup-scheduling
    tail runs one candidate at a time. Returns the state, and with
    `telemetry` `(state, telemetry)`: the bulk hits and each one-at-a-time
    fulfillment counted."""
    track = telemetry is not None
    n = state.exec_job.shape[1]
    idle = state.source_pool_mask() & ~state.exec_executing
    num_idle = _i(torch.where(active, idle.sum(1), 0))
    pos = torch.arange(n, dtype=_i32, device=idle.device)
    exec_order = _rank_order(torch.where(idle, pos, BIG_SEQ))
    match = (
        state.cm_valid
        & (state.cm_src_job == state.source_job[:, None])
        & (state.cm_src_stage == state.source_stage[:, None])
    )
    slot_order = _rank_order(torch.where(match, state.cm_seq, BIG_SEQ))
    if bulk:
        state, k = _bulk_fulfill(params, bank, state, num_idle, exec_order,
                                 slot_order)
        telemetry = _tm_add(telemetry, bulk_fulfill_hits=k)
    else:
        k = torch.zeros_like(num_idle)
    while True:
        on = k < num_idle
        if not bool(on.any()):
            return (state, telemetry) if track else state
        telemetry = _tm_add(telemetry, fulfill_steps=on)
        e = _g(exec_order, k)
        quirk = state.source_job_id()
        st, rk, rj, rs = _fulfill_commitment_phase_a(
            state, e, _g(slot_order, k), on
        )
        ak, tj, ts = _resolve_action(params, st, rk, e, rj, rs, quirk)
        st = _apply_action(params, bank, st, ak, e, tj, ts)
        # lanes past their count keep their state (rng included)
        state = select_env(on, st, state)
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
# bulk event passes and the event loop
# --------------------------------------------------------------------------


def _pop_event(params: EnvParams, st: EnvState, enabled: torch.Tensor):
    """Pop + handle one event on the lanes in `enabled` that have one
    (the JAX `flat_loop._pop_event`, shared with `_resume_simulation`).
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
    return st, rk, rj, rs, arg, _i(quirk), popped, kind


def _bulk_relaunch(params: EnvParams, bank: WorkloadBank, state: EnvState,
                   enabled: torch.Tensor, stop_at_limit: bool = False,
                   max_events: int = 8):
    """Pop up to `max_events` consecutive *task relaunch* events per lane
    in one pass, in exact sequential order; returns (state, k[B]) with k
    the events consumed (0 where the next event is no relaunch, the
    queue is drained or `enabled` is off). See the JAX package's
    docstring for the conditions and `stop_at_limit`."""
    b, n = state.exec_finish_time.shape
    j_cap, s_cap = state.stage_remaining.shape[1:]
    dev = state.exec_job.device
    pos = torch.arange(n, dtype=_i32, device=dev)

    # earliest non-finish competitor, lexicographic (time, seq)
    t_job = torch.where(state.job_arrived, INF, state.job_arrival_time)
    jt = t_job.amin(1)
    jseq = torch.where(t_job == jt[:, None], state.job_arrival_seq,
                       BIG_SEQ).amin(1)
    at = state.exec_arrive_time.amin(1)
    aseq = torch.where(state.exec_arrive_time == at[:, None],
                       state.exec_arrive_seq, BIG_SEQ).amin(1)
    t_star = torch.minimum(jt, at)
    seq_star = torch.minimum(
        torch.where(jt == t_star, jseq, BIG_SEQ),
        torch.where(at == t_star, aseq, BIG_SEQ),
    )

    # static per-executor facts for the whole cascade
    je = state.exec_job
    se = state.exec_task_stage
    executing = torch.isfinite(state.exec_finish_time)
    jc = je.clamp(0, j_cap - 1)
    sc = se.clamp(0, s_cap - 1)
    same = (
        (je[:, :, None] == je[:, None, :])
        & (se[:, :, None] == se[:, None, :])
        & executing[:, :, None]
        & executing[:, None, :]
    )
    num_local = (je[:, None, :] == je[:, :, None]).sum(-1)
    tpl = _gk(state.job_template, jc)

    # pre-sampled durations: dur_table[:, i, e] is the draw consumed if
    # the i-th processed event belongs to executor e
    rng_next, us = prng.split_uniform(state.rng, (max_events * n, 2))
    us = us.reshape(b, max_events, n, 2)
    yes = torch.ones((b, 1, n), dtype=torch.bool, device=dev)
    dur_table = sample_task_duration(
        params, bank, us, tpl[:, None, :], sc[:, None, :],
        num_local[:, None, :], yes, yes,
    )

    t_e = state.exec_finish_time
    sq_e = state.exec_finish_seq
    rem_e = _gk(state.stage_remaining, jc, sc)
    k_e = torch.zeros((b, n), dtype=_i32, device=dev)
    ldur_e = torch.zeros((b, n), dtype=torch.float32, device=dev)
    counter = state.seq_counter
    wall = state.wall_time
    active = enabled.clone()
    crossed = torch.zeros_like(active)
    for i in range(max_events):
        if not bool(active.any()):
            break  # every later step is a no-op on every lane
        dur_row = dur_table[:, i]
        tmin = t_e.amin(1)
        has = torch.isfinite(tmin)
        cand = t_e == tmin[:, None]
        smin = torch.where(cand, sq_e, BIG_SEQ).amin(1)
        e_oh = cand & (sq_e == smin[:, None])
        before = (tmin < t_star) | ((tmin == t_star) & (smin < seq_star))
        rem_i = torch.where(e_oh, rem_e, 0).sum(1)
        ok = active & has & before & (rem_i > 0)
        if stop_at_limit:
            ok = ok & ~crossed
            crossed = crossed | (ok & (tmin >= state.time_limit))
        srow = (e_oh[:, :, None] & same).any(1)
        dur_i = torch.where(e_oh, dur_row, 0.0).sum(1)
        oke = ok[:, None] & e_oh
        oks = ok[:, None] & srow
        t_e = torch.where(oke, (tmin + dur_i)[:, None], t_e)
        sq_e = torch.where(oke, counter[:, None], sq_e)
        rem_e = rem_e - _i(oks)
        k_e = k_e + _i(oke)
        ldur_e = torch.where(oks, dur_i[:, None], ldur_e)
        counter = counter + _i(ok)
        wall = torch.where(ok, tmin, wall)
        active = active & ok
    k = _i(k_e.sum(1))
    bulked = k > 0
    touched = k_e > 0

    # one representative executor per touched stage
    first_touched = torch.where(same & touched[:, None, :], pos, n).amin(-1)
    rep = touched & (pos == first_touched)

    cnt_i = ((same & touched[:, None, :]) * k_e[:, None, :]).sum(-1)
    exhausted_i = rep & (rem_e == 0)
    demand_i = (
        rem_e - _gk(state.moving_count, jc, sc)
        - _gk(state.commit_count, jc, sc)
    )
    sat_new_i = demand_i <= 0
    delta_i = torch.where(
        rep & _gk(state.stage_exists, jc, sc),
        _i(sat_new_i) - _i(_gk(state.stage_sat, jc, sc)),
        0,
    )
    adj_row = _gk(state.adj, jc, sc)  # [B, N, S]

    oh_j = je[:, :, None] == torch.arange(j_cap, dtype=_i32, device=dev)
    oh_s = se[:, :, None] == torch.arange(s_cap, dtype=_i32, device=dev)
    m = oh_j[:, :, :, None] & oh_s[:, :, None, :] & rep[:, :, None, None]
    cnt = _i((m * cnt_i[:, :, None, None]).sum(1))
    aff = cnt > 0
    dur_js = (_f(m) * ldur_e[:, :, None, None]).sum(1)
    sat_js = (m & sat_new_i[:, :, None, None]).any(1)
    unsat = _i(state.unsat_parent_count - (
        _i(oh_j)[:, :, :, None]
        * (delta_i[:, :, None] * _i(adj_row))[:, :, None, :]
    ).sum(1))

    return state.replace(
        rng=_w(bulked, rng_next, state.rng),
        wall_time=wall,
        seq_counter=_i(counter),
        exec_finish_time=torch.where(touched, t_e, state.exec_finish_time),
        exec_finish_seq=torch.where(touched, sq_e, state.exec_finish_seq),
        stage_remaining=state.stage_remaining - cnt,
        stage_completed_tasks=state.stage_completed_tasks + cnt,
        stage_duration=torch.where(aff, dur_js, state.stage_duration),
        job_saturated_stages=state.job_saturated_stages
        + _i((oh_j & exhausted_i[:, :, None]).sum(1)),
        stage_sat=torch.where(aff, sat_js, state.stage_sat),
        unsat_parent_count=unsat,
    ), k


def _bulk_ready(params: EnvParams, bank: WorkloadBank, state: EnvState,
                enabled: torch.Tensor, stop_at_limit: bool = False):
    """Consume the maximal run of consecutive EXECUTOR_READY events per
    lane in one pass; returns (state, k[B]) (0 where the single-event
    path must run). See the JAX package's docstring for where the prefix
    stops."""
    b, n = state.exec_job.shape
    j_cap, s_cap = state.stage_remaining.shape[1:]
    dev = state.exec_job.device
    pos = torch.arange(n, dtype=_i32, device=dev)

    # earliest non-ready competitor, lexicographic (time, seq)
    t_job = torch.where(state.job_arrived, INF, state.job_arrival_time)
    jt = t_job.amin(1)
    jseq = torch.where(t_job == jt[:, None], state.job_arrival_seq,
                       BIG_SEQ).amin(1)
    ft = state.exec_finish_time.amin(1)
    fseq = torch.where(state.exec_finish_time == ft[:, None],
                       state.exec_finish_seq, BIG_SEQ).amin(1)
    t_star = torch.minimum(jt, ft)
    seq_star = torch.minimum(
        torch.where(jt == t_star, jseq, BIG_SEQ),
        torch.where(ft == t_star, fseq, BIG_SEQ),
    )

    # arrivals in processing order: perm[p, i] — executor i is p-th
    at, aq = state.exec_arrive_time, state.exec_arrive_seq
    gt = (at[:, :, None] > at[:, None, :]) | (
        (at[:, :, None] == at[:, None, :]) & (aq[:, :, None] > aq[:, None, :])
    )
    rank = gt.sum(-1)
    perm = rank[:, None, :] == pos[None, :, None]

    def by_pos(x):
        return _i(torch.where(perm, x[:, None, :], 0).sum(-1))

    to = torch.where(perm, at[:, None, :], INF).amin(-1)
    so = by_pos(aq)
    e = by_pos(pos.expand(b, n))
    dj = by_pos(state.exec_dst_job)
    ds0 = by_pos(state.exec_dst_stage)
    djc = dj.clamp(0, j_cap - 1)
    dsc = ds0.clamp(0, s_cap - 1)

    frontier_k = _gk(state.frontier, djc, dsc)
    flat = djc * s_cap + dsc
    earlier = (pos[None, :] < pos[:, None])[None]
    stage_pair = flat[:, None, :] == flat[:, :, None]
    start0 = frontier_k
    cum_starts = (earlier & stage_pair & start0[:, None, :]).sum(-1)
    rem0 = _gk(state.stage_remaining, djc, dsc)
    saturated = rem0 - cum_starts == 0

    same_job = dj[:, None, :] == dj[:, :, None]
    base_nl = (state.exec_job[:, None, :] == dj[:, :, None]).sum(-1)
    nl = base_nl + (earlier & same_job).sum(-1) + 1

    rng_next, us = prng.split_uniform(state.rng, (n, 2))
    tpl = _gk(state.job_template, djc)
    ec = e.clamp(0, n - 1)
    tv = _gk(state.exec_task_valid, ec)
    ss_same = _gk(state.exec_task_stage, ec) == ds0
    durs = sample_task_duration(params, bank, us, tpl, dsc, nl, tv, ss_same)
    fin_k = to + durs

    before_star = (to < t_star[:, None]) | (
        (to == t_star[:, None]) & (so < seq_star[:, None])
    )
    gen = torch.where(start0, fin_k, INF)
    inf1 = torch.full((b, 1), INF, device=dev)
    gen_before = torch.cat([inf1, torch.cummin(gen, 1).values[:, :-1]], 1)
    joins_source = (
        state.source_valid[:, None]
        & (dj == state.source_job[:, None])
        & torch.where(start0, ds0 == state.source_stage[:, None],
                      (state.source_stage == -1)[:, None])
    )
    no1 = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    joined_before = torch.cumsum(
        _i(torch.cat([no1, joins_source[:, :-1]], 1)), 1) > 0
    ok = (
        torch.isfinite(to)
        & before_star
        & ~saturated
        & (to <= gen_before)
        & ~joined_before
    )
    if stop_at_limit:
        past = to >= state.time_limit[:, None]
        crossed_before = torch.cumsum(
            _i(torch.cat([no1, past[:, :-1]], 1)), 1) > 0
        ok = ok & ~crossed_before
    prefix = (torch.cumsum(_i(~ok), 1) == 0) & enabled[:, None]
    k = _i(prefix.sum(1))

    start = start0 & prefix
    park = ~start0 & prefix
    newly_exh = start & (rem0 - cum_starts == 1)

    inc = _i(start)
    seq_k = state.seq_counter[:, None] + (earlier & start0[:, None, :]).sum(-1)

    # ---- per-executor scatters
    sel = prefix[:, :, None] & perm
    exset, exflag = _exec_scatter(sel)

    minus1 = torch.full((b, n), -1, dtype=_i32, device=dev)
    arrived = prefix
    exec_moving = exflag(state.exec_moving, arrived, False)
    exec_arrive_time = exset(
        state.exec_arrive_time, arrived,
        torch.full((b, n), INF, dtype=torch.float32, device=dev),
    )
    exec_at_common = exflag(state.exec_at_common, arrived, False)
    exec_job = exset(state.exec_job, arrived, dj)
    exec_stage = exset(
        state.exec_stage, arrived, torch.where(start, ds0, minus1)
    )
    exec_task_valid = exflag(
        exflag(state.exec_task_valid, park, False), start, True
    )
    exec_executing = exflag(state.exec_executing, start, True)
    exec_task_stage = exset(state.exec_task_stage, start, ds0)
    exec_finish_time = exset(state.exec_finish_time, start, fin_k)
    exec_finish_seq = exset(state.exec_finish_seq, start, seq_k)

    # ---- per-stage counters (every prefix arrival was counted moving)
    oh_j = (dj[:, :, None] == torch.arange(j_cap, dtype=_i32, device=dev)) \
        & prefix[:, :, None]
    oh_s = ds0[:, :, None] == torch.arange(s_cap, dtype=_i32, device=dev)
    m3 = oh_j[:, :, :, None] & oh_s[:, :, None, :]
    cnt_arr = _i(m3.sum(1))
    cnt_start = _i((m3 & start[:, :, None, None]).sum(1))
    moving_count = state.moving_count - cnt_arr
    stage_remaining = state.stage_remaining - cnt_start
    stage_executing = state.stage_executing + cnt_start

    later = (pos[None, :] > pos[:, None])[None]
    is_last_start = start & ~(later & stage_pair & start[:, None, :]).any(-1)
    dur_js = (
        _f(m3 & is_last_start[:, :, None, None]) * durs[:, :, None, None]
    ).sum(1)
    stage_duration = torch.where(cnt_start > 0, dur_js, state.stage_duration)
    job_saturated_stages = state.job_saturated_stages + _i(
        (oh_j & newly_exh[:, :, None]).sum(1)
    )

    # ---- saturation-cache refresh for touched destination stages
    aff = cnt_arr > 0
    demand = stage_remaining - moving_count - state.commit_count
    sat_new = demand <= 0
    is_rep = prefix & ~(earlier & stage_pair).any(-1)
    delta_k = torch.where(
        is_rep & _gk(state.stage_exists, djc, dsc),
        _i(_gk(sat_new, djc, dsc)) - _i(_gk(state.stage_sat, djc, dsc)),
        0,
    )
    adj_row = _gk(state.adj, djc, dsc)
    unsat = _i(state.unsat_parent_count - (
        _i(oh_j)[:, :, :, None]
        * (delta_k[:, :, None] * _i(adj_row))[:, :, None, :]
    ).sum(1))

    bulked = k > 0
    wall = torch.where(
        bulked, torch.where(prefix, to, -INF).amax(1), state.wall_time
    )
    state = state.replace(
        rng=_w(bulked, rng_next, state.rng),
        wall_time=wall,
        seq_counter=_i(state.seq_counter + inc.sum(1)),
        exec_moving=exec_moving,
        exec_arrive_time=exec_arrive_time,
        exec_at_common=exec_at_common,
        exec_job=exec_job,
        exec_stage=exec_stage,
        exec_task_valid=exec_task_valid,
        exec_executing=exec_executing,
        exec_task_stage=exec_task_stage,
        exec_finish_time=exec_finish_time,
        exec_finish_seq=exec_finish_seq,
        moving_count=moving_count,
        stage_remaining=stage_remaining,
        stage_executing=stage_executing,
        stage_duration=stage_duration,
        job_saturated_stages=job_saturated_stages,
        stage_sat=torch.where(aff, sat_new, state.stage_sat),
        unsat_parent_count=unsat,
    )
    return state, k


def _bulk_events_fused(params: EnvParams, bank: WorkloadBank,
                       state: EnvState, enabled: torch.Tensor,
                       stop_at_limit: bool = False, max_events: int = 8):
    """Consume one maximal run of *simple* events per lane — task
    relaunches and executor arrivals interleaved in exact (time, seq)
    order — in a single bounded scan of `max_events + N` steps. Returns
    (state, k_rel[B], k_rdy[B]), the events consumed by kind. See the
    JAX package's docstring for when an event is simple and where the
    run stops. On a CUDA state one launch of `csrc/bulk_events.cu`, on a
    CPU state the plain version `_bulk_events_fused_ref`
    (`kernels/bulk_events.py`)."""
    return bulk_events_fused(params, bank, state, enabled,
                             stop_at_limit=stop_at_limit,
                             max_events=max_events)


def _bulk_events_fused_ref(params: EnvParams, bank: WorkloadBank,
                           state: EnvState, enabled: torch.Tensor,
                           stop_at_limit: bool = False, max_events: int = 8):
    """The plain version of `_bulk_events_fused`: the split-then-draw of
    a `[B, L, N, 2]` uniform table, then a host loop of masked steps
    over all lanes, left once no lane is live, and one merged state
    write."""
    b, n = state.exec_job.shape
    j_cap, s_cap = state.stage_remaining.shape[1:]
    dev = state.exec_job.device
    length = max_events + n
    jr = torch.arange(j_cap, dtype=_i32, device=dev)

    # job arrivals: the only competitor kind (never consumed here)
    t_job = torch.where(state.job_arrived, INF, state.job_arrival_time)
    jt = t_job.amin(1)
    jseq = torch.where(t_job == jt[:, None], state.job_arrival_seq,
                       BIG_SEQ).amin(1)

    # static per-executor arrival facts
    dj = state.exec_dst_job
    ds0 = state.exec_dst_stage
    djc = dj.clamp(0, j_cap - 1)
    dsc = ds0.clamp(0, s_cap - 1)
    frontier_a = _gk(state.frontier, djc, dsc)
    tv_a = state.exec_task_valid
    ss_a = state.exec_task_stage == ds0
    sq_a = state.exec_arrive_seq
    joins_a = (
        state.source_valid[:, None]
        & (dj == state.source_job[:, None])
        & torch.where(frontier_a, ds0 == state.source_stage[:, None],
                      (state.source_stage == -1)[:, None])
    )

    # us[:, i, e] is consumed iff the i-th processed event is e's
    rng_next, us = prng.split_uniform(state.rng, (length, n, 2))

    jcnt0 = _i((state.exec_job[:, None, :] == jr[None, :, None]).sum(-1))

    def pick_i(oh, x):
        return torch.where(oh, x, 0).sum(1).to(x.dtype)

    t_f = state.exec_finish_time
    sq_f = state.exec_finish_seq
    t_a = state.exec_arrive_time
    fj = state.exec_job.clamp(0, j_cap - 1)
    fs = state.exec_task_stage.clamp(0, s_cap - 1)
    rem = state.stage_remaining
    jcnt = jcnt0
    launch_t = torch.zeros((b, j_cap, s_cap), dtype=torch.bool, device=dev)
    dur_js = torch.zeros((b, j_cap, s_cap), dtype=torch.float32, device=dev)
    relc = torch.zeros((b, j_cap, s_cap), dtype=_i32, device=dev)
    arr_done = torch.zeros((b, n), dtype=torch.bool, device=dev)
    started = torch.zeros_like(arr_done)
    counter = state.seq_counter
    wall = state.wall_time
    active = enabled.clone()
    crossed = torch.zeros_like(active)
    for i in range(length):
        if not bool(active.any()):
            break  # every later step is a no-op on every lane
        u_row = us[:, i]
        # lexicographic (time, seq) minimum over finishes and arrivals
        ftmin = t_f.amin(1)
        fcand = t_f == ftmin[:, None]
        fsmin = torch.where(fcand, sq_f, BIG_SEQ).amin(1)
        atmin = t_a.amin(1)
        acand = t_a == atmin[:, None]
        asmin = torch.where(acand, sq_a, BIG_SEQ).amin(1)
        is_fin = (ftmin < atmin) | ((ftmin == atmin) & (fsmin < asmin))
        tmin = torch.minimum(ftmin, atmin)
        smin = torch.where(is_fin, fsmin, asmin)
        has = torch.isfinite(tmin)
        before_job = (tmin < jt) | ((tmin == jt) & (smin < jseq))
        e_oh = torch.where(
            is_fin[:, None], fcand & (sq_f == fsmin[:, None]),
            acand & (sq_a == asmin[:, None]),
        )

        # the winner's target stage on the live views
        tj = torch.where(is_fin, pick_i(e_oh, fj), pick_i(e_oh, djc))
        ts = torch.where(is_fin, pick_i(e_oh, fs), pick_i(e_oh, dsc))
        rem_t = _g(rem, tj, ts)
        ok = active & has & before_job & (rem_t > 0)
        if stop_at_limit:
            ok = ok & ~crossed
            crossed = crossed | (ok & (tmin >= state.time_limit))
        start_a = (e_oh & frontier_a).any(1)
        is_rel = ok & is_fin
        is_arr = ok & ~is_fin
        launch = is_rel | (is_arr & start_a)
        joins = is_arr & (e_oh & joins_a).any(1)

        u2 = torch.where(e_oh[:, :, None], u_row, 0.0).sum(1)
        nl = _g(jcnt, tj) + _i(is_arr)
        tv = torch.where(is_fin, True, (e_oh & tv_a).any(1))
        ss = torch.where(is_fin, True, (e_oh & ss_a).any(1))
        dur = sample_task_duration(
            params, bank, u2, _g(state.job_template, tj), ts, nl, tv, ss
        )

        oh2 = _onehot2(j_cap, s_cap, tj, ts)
        le = launch[:, None] & e_oh
        ase = (is_arr & start_a)[:, None] & e_oh
        l2 = launch[:, None, None] & oh2
        t_f = torch.where(le, (tmin + dur)[:, None], t_f)
        sq_f = torch.where(le, counter[:, None], sq_f)
        t_a = torch.where(is_arr[:, None] & e_oh, INF, t_a)
        fj = torch.where(ase, tj[:, None], fj)
        fs = torch.where(ase, ts[:, None], fs)
        rem = rem - _i(l2)
        jcnt = jcnt + _i(is_arr[:, None] & _onehot(j_cap, tj))
        launch_t = launch_t | l2
        dur_js = torch.where(l2, dur[:, None, None], dur_js)
        relc = relc + _i(is_rel[:, None, None] & oh2)
        arr_done = arr_done | (is_arr[:, None] & e_oh)
        started = started | ase
        counter = counter + _i(launch)
        wall = torch.where(ok, tmin, wall)
        active = active & ok & ~joins

    k_rel = _i(relc.sum((1, 2)))
    k_rdy = _i(arr_done.sum(1))
    bulked = (k_rel + k_rdy) > 0

    # [J,S] scatters for the consumed arrivals (static destinations)
    oh_j = (dj[:, :, None] == jr) & arr_done[:, :, None]
    oh_s = ds0[:, :, None] == torch.arange(s_cap, dtype=_i32, device=dev)
    m3 = oh_j[:, :, :, None] & oh_s[:, :, None, :]
    cnt_arr = _i(m3.sum(1))
    cnt_start = _i((m3 & started[:, :, None, None]).sum(1))
    moving_count = state.moving_count - cnt_arr
    stage_executing = state.stage_executing + cnt_start

    # stages that launched down to zero became fully launched
    newly_exh = launch_t & (rem == 0)
    job_saturated_stages = state.job_saturated_stages + _i(newly_exh.sum(-1))

    # saturation-cache refresh over every touched stage
    touched = launch_t | (cnt_arr > 0)
    demand = rem - moving_count - state.commit_count
    sat_new = demand <= 0
    delta = torch.where(
        touched & state.stage_exists, _i(sat_new) - _i(state.stage_sat), 0
    )
    # einsum("jp,jpc->jc") as a masked sum: integer matmuls do not run
    # on the card
    unsat = _i(state.unsat_parent_count
               - (delta[..., None] * _i(state.adj)).sum(-2))

    state = state.replace(
        rng=_w(bulked, rng_next, state.rng),
        wall_time=wall,
        seq_counter=_i(counter),
        exec_finish_time=t_f,
        exec_finish_seq=sq_f,
        exec_arrive_time=t_a,
        exec_moving=state.exec_moving & ~arr_done,
        exec_at_common=state.exec_at_common & ~arr_done,
        exec_job=torch.where(arr_done, dj, state.exec_job),
        exec_stage=torch.where(
            arr_done, torch.where(started, ds0, -1), state.exec_stage
        ).to(_i32),
        exec_task_valid=torch.where(arr_done, started,
                                    state.exec_task_valid),
        exec_executing=state.exec_executing | started,
        exec_task_stage=torch.where(started, ds0, state.exec_task_stage),
        stage_remaining=rem,
        stage_completed_tasks=state.stage_completed_tasks + relc,
        stage_executing=stage_executing,
        moving_count=moving_count,
        stage_duration=torch.where(launch_t, dur_js, state.stage_duration),
        job_saturated_stages=job_saturated_stages,
        stage_sat=torch.where(touched, sat_new, state.stage_sat),
        unsat_parent_count=unsat,
    )
    return state, k_rel, k_rdy


def _round_tail(params: EnvParams, st: EnvState, on: torch.Tensor
                ) -> tuple[EnvState, torch.Tensor]:
    """The post-event round check on the lanes in `on`: a round is ready
    when the source has committable executors and a stage is
    schedulable; otherwise committable executors go back up the pool
    hierarchy and the source is cleared. Returns (state, ready)."""
    committable = st.num_committable()
    sched = find_schedulable(params, st, st.source_job_id())
    ready = on & (committable > 0) & sched.any((1, 2))
    st = st.replace(
        round_ready=st.round_ready | ready,
        schedulable=torch.where(ready[:, None, None], sched, st.schedulable),
    )
    mc = ~ready & on & (committable > 0)
    idle = st.source_pool_mask() & ~st.exec_executing
    st = _move_idle_from_pool(
        st, st.source_job, st.source_stage, idle & mc[:, None]
    )
    st = st.replace(
        source_valid=st.source_valid & ~mc,
        source_job=_w(mc, -1, st.source_job),
        source_stage=_w(mc, -1, st.source_stage),
    )
    return st, ready


def _resume_simulation(params: EnvParams, bank: WorkloadBank,
                       state: EnvState, active: torch.Tensor,
                       bulk: bool = True, bulk_events: int = 8,
                       telemetry=None):
    """Pop events on the lanes in `active` until a new round is ready or
    the queue drains. With `bulk`, each iteration first runs the
    relaunch cascade and the arrival burst, then still pops the
    run-cutting event when the skipped between-event tail is a no-op
    (`num_committable() == 0`). A lane whose loop has ended keeps its
    state, as under the JAX package's vmapped while loop. Returns the
    state, and with `telemetry` `(state, telemetry)`: each lane's own
    iterations (`loop_iters`, `drain_iters`), its pops by kind and the
    bulk passes' events."""
    track = telemetry is not None
    while True:
        cond = active & _has_pending_event(state) & ~state.round_ready
        if not bool(cond.any()):
            return (state, telemetry) if track else state
        st = state
        bulk_counts = {}
        if bulk:
            st, nb1 = _bulk_relaunch(params, bank, st, cond,
                                     max_events=bulk_events)
            st, nb2 = _bulk_ready(params, bank, st, cond)
            single = ((nb1 + nb2) == 0) | (st.num_committable() == 0)
            if track:
                bulk_counts = dict(bulk_relaunch_events=nb1,
                                   bulk_ready_events=nb2,
                                   bulk_passes=(nb1 + nb2) > 0)
        else:
            single = torch.ones_like(cond)
        st, rk, rj, rs, arg, quirk, popped, kind = _pop_event(
            params, st, cond & single)
        if track:
            telemetry = _tm_add(
                telemetry, cond, loop_iters=cond, drain_iters=cond,
                event_steps=popped,
                ev_job_arrival=popped & (kind == EV_JOB_ARRIVAL),
                ev_task_finished=popped & (kind == EV_TASK_FINISHED),
                ev_exec_ready=popped & (kind == EV_EXECUTOR_READY),
                **bulk_counts,
            )
        ak, tj, ts = _resolve_action(params, st, rk, arg, rj, rs, quirk)
        st = _apply_action(params, bank, st, ak, arg, tj, ts)
        st, _ = _round_tail(params, st, torch.ones_like(cond))
        state = select_env(cond, st, state)


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


def _commit_decision(params: EnvParams, st: EnvState, stage_idx, num_exec
                     ) -> EnvState:
    """`core.step`'s commit: on lanes whose `stage_idx` names a
    schedulable stage, commit up to `num_exec` source executors to it
    (`do_commit`); on the others commit the rest to the common pool."""
    s_cap = params.max_stages
    j = torch.div(stage_idx, s_cap, rounding_mode="floor").to(_i32)
    s = torch.remainder(stage_idx, s_cap).to(_i32)
    valid = (
        (stage_idx >= 0)
        & (stage_idx < params.num_nodes)
        & _g(st.schedulable, j, s)
    )
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
    return _commit_remaining(st, ~valid)


def _clear_round(st: EnvState, en: torch.Tensor) -> EnvState:
    """End the commitment round on the lanes in `en`."""
    return st.replace(
        source_valid=st.source_valid & ~en,
        source_job=_w(en, -1, st.source_job),
        source_stage=_w(en, -1, st.source_stage),
        stage_selected=st.stage_selected & ~en[:, None, None],
        round_ready=st.round_ready & ~en,
        schedulable=st.schedulable & ~en[:, None, None],
    )


def step(params: EnvParams, bank: WorkloadBank, state: EnvState,
         stage_idx: torch.Tensor, num_exec: torch.Tensor, *,
         bulk: bool = True, bulk_events: int = 8, telemetry=None):
    """One decision step per lane: commit, and when the round is over
    fulfil the commitments and run the event loop to the next round.
    Returns (state, reward, terminated, truncated), and with `telemetry`
    the counters as a fifth element (decisions and finished rounds on
    live lanes, fulfillments, event-loop iterations and events).
    `bulk=False` runs the fulfillment phase and the event loop one
    candidate / event at a time; the two modes' rng streams differ."""
    track = telemetry is not None
    live = ~(state.terminated | state.truncated) if track else None
    state = _commit_decision(params, state, stage_idx, num_exec)
    round_continues = (
        (state.num_committable() > 0) & state.schedulable.any((1, 2))
    )
    active = ~round_continues
    state = _commit_remaining(state, active)
    if track:
        telemetry = _tm_add(telemetry, live, decide_steps=live,
                            commit_rounds=active)
        state, telemetry = _fulfill_from_source(params, bank, state, active,
                                                bulk, telemetry)
    else:
        state = _fulfill_from_source(params, bank, state, active, bulk=bulk)
    state = _clear_round(state, active)
    t_old = state.wall_time
    active_old = state.job_active
    out = _resume_simulation(params, bank, state, active, bulk=bulk,
                             bulk_events=bulk_events, telemetry=telemetry)
    state, telemetry = out if track else (out, None)
    reward = torch.where(
        active, -_compute_jobtime(params, state, t_old, active_old), 0.0
    )
    terminated = state.all_jobs_complete
    truncated = state.wall_time >= state.time_limit
    state = state.replace(terminated=terminated, truncated=truncated)
    if track:
        return state, reward, terminated, truncated, telemetry
    return state, reward, terminated, truncated


# the JAX package's engine knobs (`SERVE_KNOBS`' keys)
KNOBS = ("event_bulk", "bulk_events", "fulfill_bulk", "bulk_cycles",
         "bulk_fused")


def check_knobs(knobs: dict) -> None:
    """The engine takes the JAX package's five knobs (`KNOBS`); any
    other key is refused."""
    unknown = set(knobs) - set(KNOBS)
    if unknown:
        raise ValueError(
            f"unknown engine knobs {sorted(unknown)}: the engine takes "
            f"{', '.join(KNOBS)}"
        )
