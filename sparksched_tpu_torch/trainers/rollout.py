"""Rollout collection (counterpart of `sparksched_tpu/trainers/rollout.py`:
`StoredObs`, `store_obs`, `stored_to_observation`, `Rollout`, the
`core.step` collectors `collect_sync` / `collect_async`,
the per-lane flat collectors `collect_flat_sync` / `collect_flat_async`
over `micro_step(record=True)`, and the single-eval flat collectors
`collect_flat_sync_batch` / `collect_flat_async_batch`).

Every collector takes the whole lane batch (`[B]` leading states) where
the JAX package vmaps a per-lane function (so the JAX package's
`vmap_collect` has no counterpart here), and runs its scan as a Python
loop over rows (a decision row, or a flat micro-step group) that masks
frozen lanes. A per-lane collector takes one key per lane (`[B, W]`,
the JAX package's vmapped keys); a single-eval one takes one key.

- `core.step` collectors: per row each lane splits its key (k's
  successor and the policy key, or with `split_policy_keys` its two
  halves, one `prng.derive` launch for the row), the policy acts on the
  observation and `core.step` runs on every lane; done (sync) or
  budget-exhausted (async) lanes are rolled back and record nothing
  valid. Asynchronous lanes that end an episode restart from the
  group-shared reset ordinal `fold_in(seq_base, reset_count)`
  (`group_reset`).
- Single-eval flat collectors: one `observe`, ONE batched policy
  evaluation (`batch_policy_fn(key, obs)`), `decide_micro_step` acting
  on it, then `drain_to_decision` up to every lane's next decision. The
  key chain per row is the JAX package's (`split(k, 4)`, then one key
  per lane of the policy, decide and drain keys, and each lane's policy
  key split in two), all derived from the row's key in one launch
  (`row_paths`).
- Per-lane flat collectors: `micro_groups` groups of one
  `micro_step(record=True)` and `event_burst - 1` `event_micro_step`s.

The flat collectors write each lane's decisions in place into fixed
`[B, T]` buffers allocated once on the device (`_DecisionBuf`); row T of
each buffer is scratch, where writes past T (JAX's dropped scatters)
land. A span's reward goes to the slot of the lane's latest decision.

The JAX scans run their full length. These loops leave as soon as no
lane can change the result again: every later row would change no leaf
of the `Rollout` (a frozen lane is rolled back, a done lane of a sync
flat collector freezes, a stuck lane's queue is empty, its rewards are
0 and its health bits repeat), at the price of one host sync per row.
Without telemetry a single-eval loop also leaves once no lane can
decide again; with it, only once every lane is done or frozen (the
decide step runs its bulk fulfillment on every live lane, and a stuck
lane's later rows may count its hits). The rows a `core.step` collector
skips hold what the JAX rows hold on frozen lanes (the frozen state's
observation and wall time, no action, no reward) except `job_idx` and
`num_exec_k`, the JAX package's policy sample on the frozen state,
which no consumer reads (they are 0 here).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import prng
from ..config import EnvParams
from ..env import core
from ..env.flat_loop import (
    M_DECIDE,
    LoopState,
    _lane_done,
    aux_action_fields,
    decide_micro_step,
    drain_to_decision,
    event_micro_step,
    init_loop_state,
    micro_step,
    select,
)
from ..env.health import reward_health, state_health
from ..env.observe import Observation, observe
from ..env.state import EnvState, topo_levels
from ..kernels.threefry import PATH_END
from ..obs.telemetry import Telemetry
from ..obs.telemetry import orr as _tm_orr
from ..workload.bank import WorkloadBank

_i32 = torch.int32


@dataclasses.dataclass
class StoredObs:
    """The per-step record an `Observation` is rebuilt from; leading axes
    as stored (`[B,T]` in a `Rollout`). The adjacency is not stored: it
    comes from the job's template."""

    remaining: torch.Tensor  # i32[...,J,S]
    duration: torch.Tensor  # f32[...,J,S] (the observation's dtype)
    schedulable: torch.Tensor  # bool[...,J,S]
    node_mask: torch.Tensor  # bool[...,J,S]
    job_mask: torch.Tensor  # bool[...,J]
    job_template: torch.Tensor  # i32[...,J]
    exec_supplies: torch.Tensor  # i32[...,J]
    num_committable: torch.Tensor  # i32[...]
    source_job: torch.Tensor  # i32[...]

    def map(self, fn) -> "StoredObs":
        return StoredObs(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def store_obs(obs: Observation, state: EnvState) -> StoredObs:
    """The record of `obs` ([B] lanes), taken from `state`."""
    return StoredObs(
        remaining=torch.where(obs.node_mask, state.stage_remaining, 0).to(
            _i32),
        duration=obs.nodes[..., 1],
        schedulable=obs.schedulable,
        node_mask=obs.node_mask,
        job_mask=obs.job_mask,
        job_template=state.job_template.to(_i32),
        exec_supplies=obs.exec_supplies.to(_i32),
        num_committable=obs.num_committable.to(_i32),
        source_job=obs.source_job.to(_i32),
    )


def stored_to_observation(bank: WorkloadBank, so: StoredObs) -> Observation:
    """The padded Observation a stored step ([N] leading) was taken from:
    `adj` from the bank's template adjacency masked to the active nodes,
    `node_level` recomputed from it."""
    nm = so.node_mask
    adj = bank.adj[so.job_template.long()] & nm[..., :, None] & nm[..., None, :]
    nodes = torch.stack([
        so.remaining.to(torch.float32),
        so.duration.to(torch.float32),
        so.schedulable.to(torch.float32),
    ], dim=-1)
    return Observation(
        nodes=nodes,
        node_mask=nm,
        job_mask=so.job_mask,
        schedulable=so.schedulable,
        frontier=torch.zeros_like(so.schedulable),
        adj=adj,
        node_level=topo_levels(nm, adj),
        exec_supplies=so.exec_supplies,
        num_committable=so.num_committable,
        source_job=so.source_job,
        wall_time=torch.zeros(nm.shape[0], device=nm.device),
    )


@dataclasses.dataclass
class Rollout:
    """Each lane's fixed-length rollout, `[B,T]` per-step fields."""

    obs: StoredObs  # [B,T,...]
    stage_idx: torch.Tensor  # i32[B,T] flat padded node index (-1 = none)
    job_idx: torch.Tensor  # i32[B,T]
    num_exec_k: torch.Tensor  # i32[B,T] 0-based exec choice
    lgprob: torch.Tensor  # f32[B,T]
    reward: torch.Tensor  # f32[B,T]
    # wall_times[:, k] = time of obs k; wall_times[:, T] = final time
    wall_times: torch.Tensor  # f32[B,T+1]
    valid: torch.Tensor  # bool[B,T]
    resets: torch.Tensor  # bool[B,T]
    final_state: EnvState  # [B]
    final_reset_count: torch.Tensor  # i32[B]

    @property
    def num_steps(self) -> torch.Tensor:
        return self.valid.sum(-1)


def zero_stored(params: EnvParams, lead: tuple[int, ...],
                device) -> StoredObs:
    """Zeroed records with leading axes `lead`: the collector's buffers,
    zero in every field as the JAX collector's (its `_zero_stored` gives
    only the shapes and dtypes). `duration` takes the observation's dtype
    (bf16 under `obs_dtype: bfloat16`)."""
    j, s = params.max_jobs, params.max_stages

    def z(*shape, dtype=_i32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return StoredObs(
        remaining=z(j, s),
        duration=z(j, s, dtype=torch.bfloat16 if params.obs_dtype
                   == "bfloat16" else torch.float32),
        schedulable=z(j, s, dtype=torch.bool),
        node_mask=z(j, s, dtype=torch.bool), job_mask=z(j, dtype=torch.bool),
        job_template=z(j), exec_supplies=z(j), num_committable=z(),
        source_job=z(),
    )


def _returns(ro: Rollout, ls, hm, tm, health: bool):
    """A collector's return: the Rollout, the LoopState carry where the
    collector has one (`ls` not None), with `health` the per-lane health
    mask, with telemetry the counters (the health mask ORed in)."""
    ret = (ro,) if ls is None else (ro, ls)
    if health:
        ret += (hm,)
    if tm is not None:
        ret += (_tm_orr(tm, health_mask=hm) if health else tm,)
    return ret[0] if len(ret) == 1 else ret


def _tm_keep(frozen: torch.Tensor, old, new):
    """The counters `new`, rolled back to `old` on the `frozen` lanes."""
    if new is None:
        return None
    return Telemetry(torch.where(frozen[:, None], old.t, new.t))


def group_reset(params: EnvParams, bank: WorkloadBank, seq_bases: torch.Tensor,
                lane_salts: torch.Tensor, ordinals: torch.Tensor) -> EnvState:
    """Each lane's fresh episode at its reset ordinal: `core.reset_pair(
    seq, fold_in(seq, lane_salt))` with `seq = fold_in(seq_base,
    ordinal)`, so the lanes of a sequence group (one `seq_base`) replay
    one job sequence at equal ordinals while their stochastic streams
    differ. The reset runs on the whole batch (`[B]` bases, salts and
    ordinals). Both keys of every lane come from one launch: each lane's
    two paths are counters computed on the device, so every base goes
    through every lane's paths and the diagonal is kept (B^2 x 2 hashes,
    nothing for a lane batch)."""
    o = ordinals.to(torch.int64) & 0xFFFFFFFF
    table = torch.stack([
        torch.stack([o, torch.full_like(o, PATH_END)], -1),
        torch.stack([o, lane_salts.to(torch.int64) & 0xFFFFFFFF], -1),
    ], 1)  # [B, 2 keys, 2 hops]
    b = torch.arange(seq_bases.shape[0], device=seq_bases.device)
    keys = prng.derive(seq_bases, table)[b, b]
    return core.reset_pair(params, bank, keys[:, 0], keys[:, 1])


def _lanes(x, B: int, dtype, device) -> torch.Tensor:
    """A per-lane value ([B], or one value for every lane) on `device`."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device),
                              (B,)).clone()


# ---------------------------------------------------------------------------
# core.step collection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def core_row_paths(split_policy_keys: bool,
                   device: torch.device) -> torch.Tensor:
    """The paths from a lane's row key k of the keys its row needs, as
    `split(k)` makes them: k's successor (0), then the policy key (1)
    or, with `split_policy_keys`, its split (1, 0) and (1, 1)."""
    rows = [(0,), (1, 0), (1, 1)] if split_policy_keys else [(0,), (1,)]
    return prng.path_table(rows, device)


def _collect_core(params: EnvParams, bank: WorkloadBank, policy_fn,
                  rngs: torch.Tensor, num_steps: int, state: EnvState,
                  rollout_duration, seq_bases, lane_salts, reset_counts,
                  telemetry, health: bool, counts: dict | None,
                  split_policy_keys: bool):
    """The shared `core.step` scan of `collect_sync` (`rollout_duration`
    None: a lane freezes when its episode ends) and `collect_async` (a
    lane freezes once `rollout_duration` of simulated time elapsed, and
    restarts a finished episode from `group_reset`). Returns (Rollout,
    health mask, telemetry)."""
    T = int(num_steps)
    asyn = rollout_duration is not None
    B = state.wall_time.shape[0]
    dev = state.wall_time.device
    s_cap = params.max_stages
    obs_buf = zero_stored(params, (B, T), dev)
    obs_fields = [f.name for f in dataclasses.fields(StoredObs)]

    def zeros(dtype):
        return torch.zeros((B, T), dtype=dtype, device=dev)

    b_stage, b_job, b_k = zeros(_i32), zeros(_i32), zeros(_i32)
    b_lgprob, b_reward, b_walls = (zeros(torch.float32) for _ in range(3))
    b_valid, b_resets = zeros(torch.bool), zeros(torch.bool)
    hm = torch.zeros(B, dtype=_i32, device=dev)
    elapsed = torch.zeros(B, dtype=torch.float32, device=dev)
    rc = reset_counts
    tm = telemetry
    st = state
    k = rngs
    paths = core_row_paths(split_policy_keys, k.device)

    def frozen_of(st, elapsed):
        return (elapsed >= rollout_duration) if asyn else (
            st.terminated | st.truncated)

    frozen = frozen_of(st, elapsed)
    t = 0
    while t < T and not bool(frozen.all()):
        keys = prng.derive(k, paths)
        k, k_pol = keys[:, 0], (keys[:, 1:] if split_policy_keys
                                else keys[:, 1])
        obs = observe(params, st)
        stage_idx, num_exec, aux = policy_fn(k_pol, obs)
        stage_idx, num_exec = stage_idx.to(_i32), num_exec.to(_i32)
        out = core.step(params, bank, st, stage_idx, num_exec, telemetry=tm)
        nxt, reward, term, trunc = out[:4]
        tm = _tm_keep(frozen, tm, out[4] if tm is not None else None)
        if health:  # on the post-step state, before a reset
            hm = hm | torch.where(
                frozen, 0, state_health(nxt, st) | reward_health(reward))
        if asyn:
            new_elapsed = torch.where(
                frozen, elapsed, elapsed + (nxt.wall_time - st.wall_time))
            did_reset = (term | trunc) & ~frozen
            if bool(did_reset.any()):  # the whole batch draws
                nxt = core.select_env(
                    did_reset,
                    group_reset(params, bank, seq_bases, lane_salts, rc), nxt)
            rc = rc + did_reset.to(_i32)
            b_walls[:, t] = elapsed
            b_resets[:, t] = did_reset
            elapsed = new_elapsed
        else:
            b_walls[:, t] = st.wall_time
        lgprob, job, kk = aux_action_fields(aux, stage_idx, num_exec, s_cap)
        stored = store_obs(obs, st)
        for name in obs_fields:
            getattr(obs_buf, name)[:, t] = getattr(stored, name)
        b_stage[:, t] = torch.where(frozen, -1, stage_idx)
        b_job[:, t] = job.to(_i32)
        b_k[:, t] = kk.to(_i32)
        b_lgprob[:, t] = torch.where(frozen, 0.0, torch.as_tensor(
            lgprob, dtype=torch.float32, device=dev))
        b_reward[:, t] = torch.where(frozen, 0.0, reward)
        b_valid[:, t] = ~frozen
        st = core.select_env(frozen, st, nxt)
        frozen = frozen_of(st, elapsed)
        t += 1
    if counts is not None:
        counts["rows"] = t
    if t < T:  # the rows left: every lane frozen from here on
        stored = store_obs(observe(params, st), st)
        for name in obs_fields:
            getattr(obs_buf, name)[:, t:] = getattr(stored, name)[:, None]
        b_stage[:, t:] = -1
        b_walls[:, t:] = (elapsed if asyn else st.wall_time)[:, None]
    final_t = elapsed if asyn else st.wall_time
    ro = Rollout(
        obs=obs_buf, stage_idx=b_stage, job_idx=b_job, num_exec_k=b_k,
        lgprob=b_lgprob, reward=b_reward,
        wall_times=torch.cat([b_walls, final_t[:, None]], 1),
        valid=b_valid, resets=b_resets, final_state=st,
        final_reset_count=rc if asyn else torch.zeros(B, dtype=_i32,
                                                      device=dev),
    )
    return ro, hm, tm


def collect_sync(params: EnvParams, bank: WorkloadBank, policy_fn,
                 rngs: torch.Tensor, num_steps: int, state: EnvState,
                 telemetry=None, health: bool = False, *,
                 counts: dict | None = None,
                 split_policy_keys: bool = False):
    """One episode per lane from the freshly reset `state` ([B]), one
    `core.step` per decision, padded to `num_steps` (T) decisions; a lane
    whose episode ended is frozen (`valid` False). `policy_fn(keys,
    obs)` acts on every lane with its key of `rngs` ([B, W]; each row
    splits it), or with `split_policy_keys` on that key already split
    ([B, 2, W]). Returns the `Rollout`; with `health` also the per-lane
    i32 health mask (`state_health` of each live step against its start,
    OR `reward_health`); with `telemetry` (the lanes' counters) the
    counters advanced on live lanes, the health mask ORed in, last.
    `counts`, when given, receives the rows run (`rows`)."""
    ro, hm, tm = _collect_core(params, bank, policy_fn, rngs, num_steps,
                               state, None, None, None, None, telemetry,
                               health, counts, split_policy_keys)
    return _returns(ro, None, hm, tm, health)


def collect_async(params: EnvParams, bank: WorkloadBank, policy_fn,
                  rngs: torch.Tensor, num_steps: int, state: EnvState,
                  rollout_duration=math.inf, seq_bases=None, lane_salts=0,
                  reset_counts=0, telemetry=None, health: bool = False, *,
                  counts: dict | None = None,
                  split_policy_keys: bool = False):
    """A fixed budget of simulated time per lane from the persistent
    `state` ([B]): `core.step` per decision, a lane frozen once
    `rollout_duration` elapsed (checked before each decision), an
    episode that ends replaced at once by the lane's next one,
    `group_reset(seq_bases, lane_salts, reset_counts + resets so far)`
    (`seq_bases` None: the lanes' `rngs` stand in). `wall_times` are the
    elapsed times within the call, across resets; `resets` marks the
    decisions after which the lane restarted; `final_reset_count` is
    each lane's next reset ordinal. Returns as `collect_sync`."""
    B = state.wall_time.shape[0]
    dev = state.wall_time.device
    ro, hm, tm = _collect_core(
        params, bank, policy_fn, rngs, num_steps, state,
        float(rollout_duration), rngs if seq_bases is None else seq_bases,
        _lanes(lane_salts, B, _i32, dev), _lanes(reset_counts, B, _i32, dev),
        telemetry, health, counts, split_policy_keys)
    return _returns(ro, None, hm, tm, health)


# ---------------------------------------------------------------------------
# flat collection: the decision buffers
# ---------------------------------------------------------------------------


class _DecisionBuf:
    """The flat collectors' per-decision buffers, `[B, T + 1]` on the
    device (row T the scratch row), written in place: a decision's record
    into its lane's slot `ndec`, each span's reward and reset into the
    slot of the lane's latest decision (`_FlatBuf` and its scatters in
    the JAX package)."""

    def __init__(self, params: EnvParams, B: int, T: int, device) -> None:
        self.T = T
        self.rows = torch.arange(B, device=device)
        self.obs = zero_stored(params, (B, T + 1), device)
        self.fields = [f.name for f in dataclasses.fields(StoredObs)]

        def zeros(dtype):
            return torch.zeros((B, T + 1), dtype=dtype, device=device)

        self.stage, self.job, self.k = zeros(_i32), zeros(_i32), zeros(_i32)
        self.lgprob, self.reward, self.walls = (
            zeros(torch.float32) for _ in range(3))
        self.resets = zeros(_i32)
        self.ndec = torch.zeros(B, dtype=_i32, device=device)

    def record(self, dec: torch.Tensor, stored: StoredObs, stage_idx, job,
               kk, lgprob, wall, reward, reset) -> None:
        """The lanes' records where `dec` (a decision), then the span's
        reward and reset into each lane's latest decision's slot (spans
        before a lane's first decision are dropped)."""
        T, rows = self.T, self.rows
        slot = torch.where(dec & (self.ndec < T), self.ndec, T).long()
        for name in self.fields:
            getattr(self.obs, name)[rows, slot] = getattr(stored, name)
        self.stage[rows, slot] = stage_idx.to(_i32)
        self.job[rows, slot] = job.to(_i32)
        self.k[rows, slot] = kk.to(_i32)
        self.lgprob[rows, slot] = lgprob
        self.walls[rows, slot] = wall
        self.ndec = self.ndec + dec.to(_i32)
        rslot = torch.where((self.ndec > 0) & (self.ndec <= T),
                            self.ndec - 1, T).long()
        self.reward[rows, rslot] += reward
        self.resets[rows, rslot] = torch.maximum(self.resets[rows, rslot],
                                                 reset.to(_i32))

    def rollout(self, final_t: torch.Tensor, final_state: EnvState,
                final_reset_count: torch.Tensor) -> Rollout:
        T = self.T
        valid = torch.arange(T, device=final_t.device)[None, :] < \
            torch.clamp_max(self.ndec, T)[:, None]
        walls = torch.where(valid, self.walls[:, :T], final_t[:, None])
        return Rollout(
            obs=self.obs.map(lambda a: a[:, :T]),
            stage_idx=torch.where(valid, self.stage[:, :T], -1),
            job_idx=self.job[:, :T],
            num_exec_k=self.k[:, :T],
            lgprob=self.lgprob[:, :T],
            reward=self.reward[:, :T],
            wall_times=torch.cat([walls, final_t[:, None]], 1),
            valid=valid,
            resets=self.resets[:, :T] > 0,
            final_state=final_state,
            final_reset_count=final_reset_count,
        )


def _flat_reset_fn(params: EnvParams, bank: WorkloadBank, seq_bases,
                   lane_salts, reset_counts):
    """The asynchronous flat collectors' `reset_fn`: a lane's fresh
    episode at ordinal `reset_counts + episodes` (`group_reset`)."""
    def reset_fn(key, episodes):
        return group_reset(params, bank, seq_bases, lane_salts,
                           reset_counts + episodes)
    return reset_fn


# ---------------------------------------------------------------------------
# per-lane flat collection (micro_step(record=True))
# ---------------------------------------------------------------------------


def flat_micro_group_budget(num_steps: int, micro_per_decision: float,
                            event_burst: int) -> int:
    """Scan length (micro-step groups) of the per-lane flat collectors:
    ceil(num_steps * micro_per_decision / event_burst), at least 1."""
    return max(1, math.ceil(num_steps * micro_per_decision / event_burst))


def _flat_collect(params: EnvParams, bank: WorkloadBank, policy_fn,
                  rngs: torch.Tensor, num_steps: int, ls: LoopState,
                  micro_groups: int, auto_reset: bool, event_burst: int,
                  event_bulk: bool, bulk_events: int, fulfill_bulk: bool,
                  bulk_cycles: int, reset_fn, rollout_duration,
                  use_elapsed: bool, telemetry, bulk_fused: bool,
                  health: bool, counts: dict | None):
    """The per-lane flat collection loop: at most `micro_groups` groups
    (one `micro_step(record=True)`, then `event_burst - 1`
    `event_micro_step`s), each group's DECIDE record into the lane's
    decision slot, its rewards and resets into the latest decision's
    slot. A lane freezes when its buffer is full and it is about to
    decide again, or once `rollout_duration` elapsed. Each group and
    sub-step splits the lane's key (`rngs`, [B, W]). Returns (Rollout,
    LoopState, health mask, telemetry)."""
    T = int(num_steps)
    B = ls.mode.shape[0]
    dev = ls.mode.device
    buf = _DecisionBuf(params, B, T, dev)
    hm = torch.zeros(B, dtype=_i32, device=dev)
    tm = telemetry
    k = rngs
    t_ref = ls.env.wall_time
    elapsed = torch.zeros(B, dtype=torch.float32, device=dev)
    timed = use_elapsed or rollout_duration is not None

    def frozen_of(ls, ndec, elapsed):
        over = (ls.mode == M_DECIDE) & (ndec >= T)
        return over if rollout_duration is None else (
            over | (elapsed >= rollout_duration))

    over = frozen_of(ls, buf.ndec, elapsed)
    g = 0
    while g < micro_groups:
        g += 1
        tm_frozen = tm
        env0 = ls.env
        wall0 = env0.wall_time
        keys = prng.split(k)
        k = keys[:, 0]
        out = micro_step(params, bank, policy_fn, ls, keys[:, 1], auto_reset,
                         True, event_bulk, bulk_events, fulfill_bulk,
                         bulk_cycles, bulk_fused, tm, record=True,
                         reset_fn=reset_fn, t_ref=t_ref)
        ls2, rec = out[0], out[1]
        tm = out[2] if tm is not None else None
        # the discount reference moves before the sub-steps: with
        # fulfill_bulk a round-finishing decision goes straight to EVENT
        t_ref = torch.where(rec.decide & ~over, wall0, t_ref)
        reward, dt, reset = rec.reward, rec.dt, rec.reset
        for _ in range(event_burst - 1):
            keys = prng.split(k)
            k = keys[:, 0]
            out = event_micro_step(params, bank, ls2, keys[:, 1], auto_reset,
                                   event_bulk, bulk_events, bulk_cycles,
                                   bulk_fused, tm, record=True,
                                   reset_fn=reset_fn, t_ref=t_ref)
            ls2, (rw, dd, rr) = out[0], out[1]
            tm = out[2] if tm is not None else None
            reward, reset = reward + rw, reset | rr
            if timed:
                dt = dt + dd
        if health:
            hm = hm | torch.where(over, 0, state_health(
                ls2.env, env0, reset) | reward_health(reward))
        # frozen lanes: state and counters untouched, nothing recorded
        ls = select(~over, ls2, ls)
        tm = _tm_keep(over, tm_frozen, tm)
        reward = torch.where(over, 0.0, reward)
        buf.record(rec.decide & ~over, store_obs(rec.obs, env0),
                   rec.stage_idx, rec.job_idx, rec.num_exec_k, rec.lgprob,
                   elapsed if use_elapsed else wall0, reward, reset & ~over)
        if timed:  # a sync collection reads no elapsed time
            elapsed = elapsed + torch.where(over, 0.0, dt)
        over = frozen_of(ls, buf.ndec, elapsed)
        done = _lane_done(ls.env) if not auto_reset else torch.zeros_like(
            over)
        if bool((over | done).all()):
            break  # every later group would change nothing
    if counts is not None:
        counts["rows"] = g
    final_t = elapsed if use_elapsed else ls.env.wall_time
    return buf.rollout(final_t, ls.env, ls.episodes), ls, hm, tm


def collect_flat_sync(params: EnvParams, bank: WorkloadBank, policy_fn,
                      rngs: torch.Tensor, num_steps: int, state: EnvState,
                      telemetry=None, *, micro_groups: int,
                      event_burst: int = 1, event_bulk: bool = True,
                      bulk_events: int = 8, fulfill_bulk: bool = False,
                      bulk_cycles: int = 1, bulk_fused: bool = True,
                      health: bool = False, counts: dict | None = None):
    """The flat engine's `collect_sync`: one episode per lane from the
    freshly reset `state` ([B]), micro-stepped (`micro_groups` groups at
    most; a too small budget cuts the episode like a too small
    `num_steps`), a lane frozen at its episode's end, padded to
    `num_steps` decisions. `policy_fn(keys, obs)` takes one key per lane
    (`rngs` [B, W], split per group). Returns as `collect_sync`."""
    ro, _, hm, tm = _flat_collect(
        params, bank, policy_fn, rngs, num_steps, init_loop_state(state),
        micro_groups, False, event_burst, event_bulk, bulk_events,
        fulfill_bulk, bulk_cycles, None, None, False, telemetry, bulk_fused,
        health, counts)
    return _returns(ro, None, hm, tm, health)


def collect_flat_async(params: EnvParams, bank: WorkloadBank, policy_fn,
                       rngs: torch.Tensor, num_steps: int,
                       loop_state: LoopState, rollout_duration=math.inf,
                       seq_bases=None, lane_salts=0, reset_counts=0,
                       telemetry=None, *, micro_groups: int,
                       event_burst: int = 1, event_bulk: bool = True,
                       bulk_events: int = 8, fulfill_bulk: bool = False,
                       bulk_cycles: int = 1, bulk_fused: bool = True,
                       health: bool = False, counts: dict | None = None):
    """The flat engine's `collect_async`: persistent lanes (the whole
    `LoopState`, [B], which a lane frozen mid-phase needs), a budget of
    simulated time checked per micro-step group, episodes restarted
    mid-loop from `group_reset` at ordinal `reset_counts + episodes
    completed in this call`. Rewards a resumed lane accrues before its
    first decision of the call are dropped. Returns `(Rollout,
    LoopState)`, then the health mask and the counters as
    `collect_sync`."""
    B = loop_state.mode.shape[0]
    dev = loop_state.mode.device
    rcs = _lanes(reset_counts, B, _i32, dev)
    reset_fn = _flat_reset_fn(params, bank,
                              rngs if seq_bases is None else seq_bases,
                              _lanes(lane_salts, B, _i32, dev), rcs)
    # episodes counts this call's resets: the ordinal offset from rcs
    ls0 = loop_state.replace(episodes=torch.zeros_like(loop_state.episodes))
    ro, ls, hm, tm = _flat_collect(
        params, bank, policy_fn, rngs, num_steps, ls0, micro_groups, True,
        event_burst, event_bulk, bulk_events, fulfill_bulk, bulk_cycles,
        reset_fn, float(rollout_duration), True, telemetry, bulk_fused,
        health, counts)
    ro.final_reset_count = rcs + ls.episodes
    return _returns(ro, ls, hm, tm, health)


# ---------------------------------------------------------------------------
# single-eval flat collection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def row_paths(lanes: int, split_policy_keys: bool,
              device: torch.device) -> torch.Tensor:
    """The paths from a row's key k of the keys that row needs, as
    `split(k, 4)` and the splits under it make them: k's successor (0),
    the policy key (1) or, with `split_policy_keys`, each lane's policy
    keys already split, (1, b, 0) and (1, b, 1), then each lane's decide
    key (2, b) and drain key (3, b); in that order."""
    pol = ([(1, b, h) for b in range(lanes) for h in (0, 1)]
           if split_policy_keys else [(1,)])
    rows = [(0,)] + pol + [(2, b) for b in range(lanes)]
    return prng.path_table(rows + [(3, b) for b in range(lanes)], device)


def _flat_collect_single_eval(params: EnvParams, bank: WorkloadBank,
                              batch_policy_fn, rng: torch.Tensor,
                              num_steps: int, ls: LoopState, auto_reset: bool,
                              event_bulk: bool, bulk_events: int,
                              fulfill_bulk: bool, bulk_cycles: int, reset_fn,
                              rollout_duration, use_elapsed: bool, telemetry,
                              bulk_fused: bool, health: bool,
                              counts: dict | None, split_policy_keys: bool):
    """The single-eval loop over the whole lane batch: at most
    `num_steps` rows, each one policy evaluation and at most one decision
    per lane. With `rollout_duration` a lane whose elapsed time reached
    it is frozen (its row changes nothing). Returns (Rollout, LoopState,
    health mask, telemetry)."""
    T = int(num_steps)
    env = ls.env
    B = env.wall_time.shape[0]
    dev = env.wall_time.device
    s_cap = params.max_stages
    buf = _DecisionBuf(params, B, T, dev)
    hm = torch.zeros(B, dtype=_i32, device=dev)
    tm = telemetry
    k = rng
    t_ref = env.wall_time
    elapsed = torch.zeros(B, dtype=torch.float32, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    n_rows = 0
    timed = use_elapsed or rollout_duration is not None
    paths = row_paths(B, split_policy_keys, k.device)
    n_pol = 2 * B if split_policy_keys else 1
    for _ in range(T):
        n_rows += 1
        keys = prng.derive(k, paths)
        k, k_pol = keys[0], keys[1:1 + n_pol]
        k_pol = k_pol.unflatten(0, (B, 2)) if split_policy_keys else k_pol[0]
        k_dec, k_drain = keys[1 + n_pol:1 + n_pol + B], keys[1 + n_pol + B:]
        tm_frozen = tm
        env0 = ls.env
        wall0 = env0.wall_time
        obs = observe(params, env0)
        stage_idx, num_exec, aux = batch_policy_fn(k_pol, obs)
        lgprob, job, kk = aux_action_fields(aux, stage_idx, num_exec, s_cap)
        lgprob = torch.broadcast_to(
            torch.as_tensor(lgprob, dtype=torch.float32, device=dev), (B,))
        out = decide_micro_step(
            params, bank, ls, stage_idx.to(_i32), num_exec.to(_i32),
            k_dec, auto_reset, fulfill_bulk, telemetry=tm, reset_fn=reset_fn,
        )
        ls2, (decided, rw1, dt1, rs1) = out[0], out[1]
        # the discount reference of the span this decision opens
        t_ref = torch.where(decided & ~over, wall0, t_ref)
        out = drain_to_decision(
            params, bank, ls2, k_drain, auto_reset, event_bulk,
            bulk_events, bulk_cycles, t_ref, bulk_fused,
            out[2] if tm is not None else None, reset_fn=reset_fn,
        )
        ls3, (rw2, dt2, rs2) = out[0], out[1]
        tm = out[2] if tm is not None else None
        reward = rw1 + rw2
        reset = rs1 | rs2
        if health:
            hm = hm | torch.where(over, 0, state_health(
                ls3.env, env0, reset) | reward_health(reward))
        if rollout_duration is not None:  # frozen lanes: nothing changes
            ls3 = select(~over, ls3, ls)
            tm = _tm_keep(over, tm_frozen, tm)
            reward = torch.where(over, 0.0, reward)
        buf.record(decided & ~over, store_obs(obs, env0), stage_idx, job, kk,
                   lgprob, elapsed if use_elapsed else wall0, reward,
                   reset & ~over)
        if timed:  # a sync collection reads no elapsed time
            elapsed = elapsed + torch.where(over, 0.0, dt1 + dt2)
        ls = ls3
        if rollout_duration is not None:
            over = elapsed >= rollout_duration
        live = ~over & ~_lane_done(ls.env)
        if tm is None:
            live = live & (ls.mode == M_DECIDE)
        if not bool(live.any()):
            break  # every later row would change nothing
    if counts is not None:
        counts["rows"] = n_rows
    final_t = elapsed if use_elapsed else ls.env.wall_time
    return buf.rollout(final_t, ls.env, ls.episodes), ls, hm, tm


def collect_flat_sync_batch(params: EnvParams, bank: WorkloadBank,
                            batch_policy_fn, rng: torch.Tensor,
                            num_steps: int, states: EnvState, *,
                            event_bulk: bool = True, bulk_events: int = 8,
                            fulfill_bulk: bool = True, bulk_cycles: int = 1,
                            bulk_fused: bool = True, health: bool = False,
                            counts: dict | None = None, telemetry=None,
                            split_policy_keys: bool = False):
    """One episode per lane from the freshly reset `states` ([B]), one
    policy evaluation per decision row, at most `num_steps` (T) decisions
    per lane recorded. `batch_policy_fn(key, obs)` returns per-lane
    `(stage_idx, num_exec_1based, aux)`; `rng` is one key. With
    `split_policy_keys` the policy is called with the lanes' keys in
    place of the one key: each lane's policy key already split ([B, 2,
    W]: `split(split(key, B)[b])`), which the row's one launch derives
    beside its other keys. Returns the `Rollout`, and with
    `health` also the per-lane i32 health mask
    (`state_health` over each row's drained state against the row's
    start, OR `reward_health` of the row's reward). `counts`, when
    given, receives the rows run (`rows`). With `telemetry` (the lanes'
    counters, `obs.telemetry.Telemetry`) the counters advanced over the
    collection are returned last, the health mask ORed into them."""
    ro, _, hm, tm = _flat_collect_single_eval(
        params, bank, batch_policy_fn, rng, num_steps,
        init_loop_state(states), False, event_bulk, bulk_events,
        fulfill_bulk, bulk_cycles, None, None, False, telemetry, bulk_fused,
        health, counts, split_policy_keys)
    return _returns(ro, None, hm, tm, health)


def collect_flat_async_batch(params: EnvParams, bank: WorkloadBank,
                             batch_policy_fn, rng: torch.Tensor,
                             num_steps: int, loop_states: LoopState,
                             rollout_duration=math.inf, seq_bases=None,
                             lane_salts=0, reset_counts=0, telemetry=None, *,
                             event_bulk: bool = True, bulk_events: int = 8,
                             fulfill_bulk: bool = True, bulk_cycles: int = 1,
                             bulk_fused: bool = True, health: bool = False,
                             counts: dict | None = None,
                             split_policy_keys: bool = False):
    """The asynchronous single-eval collector: persistent lanes
    (`loop_states`, [B]), a budget of simulated time checked per decision
    row, episodes restarted mid-loop from `group_reset` at ordinal
    `reset_counts + episodes completed in this call` (`seq_bases` None:
    `split(rng, B)`). `wall_times` are elapsed times within the call;
    `final_reset_count` is each lane's next reset ordinal. Returns
    `(Rollout, LoopState)`, then the health mask and the counters as
    `collect_flat_sync_batch`."""
    B = loop_states.mode.shape[0]
    dev = loop_states.mode.device
    rcs = _lanes(reset_counts, B, _i32, dev)
    reset_fn = _flat_reset_fn(
        params, bank, prng.split(rng, B) if seq_bases is None else seq_bases,
        _lanes(lane_salts, B, _i32, dev), rcs)
    ls0 = loop_states.replace(
        episodes=torch.zeros_like(loop_states.episodes))
    ro, ls, hm, tm = _flat_collect_single_eval(
        params, bank, batch_policy_fn, rng, num_steps, ls0, True, event_bulk,
        bulk_events, fulfill_bulk, bulk_cycles, reset_fn,
        float(rollout_duration), True, telemetry, bulk_fused, health, counts,
        split_policy_keys)
    ro.final_reset_count = rcs + ls.episodes
    return _returns(ro, ls, hm, tm, health)
