"""Rollout collection (counterpart of `sparksched_tpu/trainers/rollout.py`:
`StoredObs`, `store_obs`, `stored_to_observation`, `Rollout`,
`_zero_stored`, `_flat_collect_single_eval` in its sync form and
`collect_flat_sync_batch`).

The single-eval collector runs one decision row per iteration over the
whole lane batch: one `observe`, ONE batched policy evaluation
(`batch_policy_fn(key, obs)`), `decide_micro_step` acting on it, then
`drain_to_decision` up to every lane's next decision. The key chain per
row is the JAX package's (`split(k, 4)`, then one key per lane of the
policy, decide and drain keys, and each lane's policy key split in two),
all derived from the row's key in one launch (`row_paths`). Each lane's
decisions are written in place into fixed `[B, T]` buffers allocated
once on the device; row T of each buffer is scratch, where writes past T
(JAX's dropped scatters) land.
A span's reward goes to the slot of the lane's latest decision.

The JAX scan runs exactly T rows. This loop leaves as soon as no lane can
decide again (every lane done or stuck): each later row would change no
leaf of the `Rollout` — a done lane is frozen, a stuck lane's queue is
empty, its rewards are 0 and its health bits repeat — at the price of one
host sync per row. With the optional telemetry counters the loop leaves
early only once every lane is done: the JAX package's decide step runs
its bulk fulfillment on every live lane, and a stuck lane's later rows
may count its hits. The asynchronous form (`rollout_duration`,
`collect_flat_async_batch`) and the per-lane and `core.step` collectors
are not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import prng
from ..config import EnvParams
from ..env.flat_loop import (
    M_DECIDE,
    _lane_done,
    aux_action_fields,
    decide_micro_step,
    drain_to_decision,
    init_loop_state,
)
from ..env.health import reward_health, state_health
from ..env.observe import Observation, observe
from ..env.state import EnvState, topo_levels
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
    T = int(num_steps)
    ls = init_loop_state(states)
    env = ls.env
    B = env.wall_time.shape[0]
    dev = env.wall_time.device
    s_cap = params.max_stages
    rows = torch.arange(B, device=dev)
    # the buffers, once: T rows plus the scratch row T
    obs_buf = zero_stored(params, (B, T + 1), dev)
    obs_fields = [f.name for f in dataclasses.fields(StoredObs)]

    def zeros(dtype):
        return torch.zeros((B, T + 1), dtype=dtype, device=dev)

    b_stage, b_job, b_k = zeros(_i32), zeros(_i32), zeros(_i32)
    b_lgprob, b_reward, b_walls = (zeros(torch.float32) for _ in range(3))
    b_resets = zeros(_i32)
    hm = torch.zeros(B, dtype=_i32, device=dev)
    k = rng
    t_ref = env.wall_time
    ndec = torch.zeros(B, dtype=_i32, device=dev)
    n_rows = 0
    paths = row_paths(B, split_policy_keys, k.device)
    n_pol = 2 * B if split_policy_keys else 1
    for _ in range(T):
        n_rows += 1
        keys = prng.derive(k, paths)
        k, k_pol = keys[0], keys[1:1 + n_pol]
        k_pol = k_pol.unflatten(0, (B, 2)) if split_policy_keys else k_pol[0]
        k_dec, k_drain = keys[1 + n_pol:1 + n_pol + B], keys[1 + n_pol + B:]
        env0 = ls.env
        wall0 = env0.wall_time
        obs = observe(params, env0)
        stage_idx, num_exec, aux = batch_policy_fn(k_pol, obs)
        lgprob, job, kk = aux_action_fields(aux, stage_idx, num_exec, s_cap)
        lgprob = torch.broadcast_to(
            torch.as_tensor(lgprob, dtype=torch.float32, device=dev), (B,))
        out = decide_micro_step(
            params, bank, ls, stage_idx.to(_i32), num_exec.to(_i32),
            k_dec, False, fulfill_bulk, telemetry=telemetry,
        )
        ls2, (decided, rw1, dt1, rs1) = out[0], out[1]
        t_ref = torch.where(decided, wall0, t_ref)
        out = drain_to_decision(
            params, bank, ls2, k_drain, False, event_bulk,
            bulk_events, bulk_cycles, t_ref, bulk_fused,
            out[2] if telemetry is not None else None,
        )
        ls3, (rw2, dt2, rs2) = out[0], out[1]
        if telemetry is not None:
            telemetry = out[2]
        reward = rw1 + rw2
        reset = rs1 | rs2
        if health:
            hm = hm | state_health(ls3.env, env0, reset) | reward_health(
                reward)
        # the decision's record, in place; slot T is the scratch row
        slot = torch.where(decided & (ndec < T), ndec, T).long()
        stored = store_obs(obs, env0)
        for name in obs_fields:
            getattr(obs_buf, name)[rows, slot] = getattr(stored, name)
        b_stage[rows, slot] = stage_idx.to(_i32)
        b_job[rows, slot] = job.to(_i32)
        b_k[rows, slot] = kk.to(_i32)
        b_lgprob[rows, slot] = lgprob
        b_walls[rows, slot] = wall0
        ndec = ndec + decided.to(_i32)
        # the span's reward belongs to the latest decision's slot
        rslot = torch.where((ndec > 0) & (ndec <= T), ndec - 1, T).long()
        b_reward[rows, rslot] += reward
        b_resets[rows, rslot] = torch.maximum(b_resets[rows, rslot],
                                              reset.to(_i32))
        ls = ls3
        live = ~_lane_done(ls.env)
        if telemetry is None:
            live = live & (ls.mode == M_DECIDE)
        if not bool(live.any()):
            break  # every later row would change nothing
    if counts is not None:
        counts["rows"] = n_rows

    valid = torch.arange(T, device=dev)[None, :] < torch.clamp_max(ndec, T)[
        :, None]
    final_t = ls.env.wall_time
    walls = torch.where(valid, b_walls[:, :T], final_t[:, None])
    ro = Rollout(
        obs=obs_buf.map(lambda a: a[:, :T]),
        stage_idx=torch.where(valid, b_stage[:, :T], -1),
        job_idx=b_job[:, :T],
        num_exec_k=b_k[:, :T],
        lgprob=b_lgprob[:, :T],
        reward=b_reward[:, :T],
        wall_times=torch.cat([walls, final_t[:, None]], 1),
        valid=valid,
        resets=b_resets[:, :T] > 0,
        final_state=ls.env,
        final_reset_count=ls.episodes,
    )
    ret = (ro, hm) if health else (ro,)
    if telemetry is not None:
        ret += (_tm_orr(telemetry, health_mask=hm) if health else telemetry,)
    return ret[0] if len(ret) == 1 else ret
