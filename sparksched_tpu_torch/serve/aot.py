"""Serve programs: one session's decision, or up to K in one batched
policy evaluation (counterpart of `sparksched_tpu/serve/aot.py`).

The JAX package compiles these ahead of time over a donated [C]-stacked
store of `LoopState`s. PyTorch runs eagerly, so here they are plain
functions over the same kind of store, which they update IN PLACE (the
counterpart of the donated buffer). The module keeps its name so the
counterpart is easy to find; CUDA graphs for these programs are later
work.

A decision: gather the session(s), observe, run the policy (or take the
caller's forced action), `apply_and_drain` to the next decision point
with the engine knobs (`SERVE_KNOBS` by default), compute the health
sentinel over the post-drain state and the span reward, scatter back.
A program takes the store's root key and the call's count: the call's
key is `fold_in(root, call)`, which splits into (policy, engine) as the
JAX programs split it, and the batched program's lanes take the K-way
splits of each. Each such key is the root through a path of counters,
(call, 0, i) and (call, 1, i), so one launch derives all of them
(`prng.derive`, the count as the table's varying counter). Padding
slots of a batch carry index C: they are never computed or written, and
their outputs are masked (`valid` off), where the JAX package clamps
their gathers and drops their scatters.

With `record=True` a program's `ServeOut` also carries each decision's
`StoredObs` record (`trainers/rollout.py:store_obs`, taken from the
observation and state BEFORE the decision), the online learner's
payload. The ring programs (`serve_decide_ring_fn`,
`serve_decide_batch_ring_fn`) instead append the full `RingRec` of each
decided lane, stamped with the session id, its decision count and the
parameter version, to a device `TrajRing`, and return the record-off
payload; the host drains the ring in batches.

The programs sync with the host inside the drain, so a call returns
once its device work is issued and nearly done. What the pipelined
window defers is the copy of the outputs to the host (`HostCopy`:
pinned buffers, a non-blocking copy and an event), and the pager's
page-out (`ColdSlot`: `take_slot` into an independent device buffer,
then a non-blocking copy to pinned host memory).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .. import prng
from ..config import EnvParams
from ..env.flat_loop import (
    LoopState,
    TrajRing,
    _lane_done,
    apply_and_drain,
    aux_action_fields,
    make_ring,
    rec_map,
    ring_append,
    take_slot,
    tree_map,
    write_slot,
)
from ..env.health import reward_health, state_health
from ..env.observe import observe
from ..trainers.rollout import StoredObs, store_obs
from ..workload.bank import WorkloadBank

_i32 = torch.int32


@dataclasses.dataclass
class ServeOut:
    """Served decisions, one row per batch slot ([K])."""

    stage_idx: torch.Tensor  # i32; flat padded node index (-1 = none)
    job_idx: torch.Tensor  # i32
    num_exec: torch.Tensor  # i32; 1-based executor count
    lgprob: torch.Tensor  # f32
    decided: torch.Tensor  # bool; lane recorded a decision
    done: torch.Tensor  # bool; episode over after the drain
    reward: torch.Tensor  # f32; span reward
    dt: torch.Tensor  # f32; sim-time advance of the span
    wall_time: torch.Tensor  # f32
    health_mask: torch.Tensor  # i32; sentinel bitmask (0 = healthy)
    valid: torch.Tensor  # bool; real (non-padding) slot
    # record=True programs only: each decision's StoredObs record
    # (meaningful where `decided & valid`); None otherwise
    obs: StoredObs | None = None


@dataclasses.dataclass
class RingRec:
    """One trajectory record as the device ring stores it: everything
    `TrajectoryBuffer.add` reads off a `ServeResult`, plus the stamps the
    host reassembles per-session streams from: `sid` (the session id),
    `seq` (the lane's decision count after this decision) and
    `params_version` (the version that decided; a swap can land between
    two records of one drain)."""

    sid: torch.Tensor  # i32
    seq: torch.Tensor  # i32
    params_version: torch.Tensor  # i32
    stage_idx: torch.Tensor  # i32
    job_idx: torch.Tensor  # i32
    num_exec: torch.Tensor  # i32; 1-based
    lgprob: torch.Tensor  # f32
    reward: torch.Tensor  # f32
    dt: torch.Tensor  # f32
    wall_time: torch.Tensor  # f32
    done: torch.Tensor  # bool; episode over after the drain
    health_mask: torch.Tensor  # i32
    obs: StoredObs | None = None


def init_ring(R: int, params: EnvParams, state) -> TrajRing:
    """A zero-filled [R]-record ring of `RingRec`s shaped for `state`'s
    env (one lane of a [B] `EnvState`; only shapes and the device
    matter), as the session store allocates one per slot group."""
    dev = state.wall_time.device
    one = state.replace(**{
        f: getattr(state, f)[:1] for f in vars(state)})
    so = store_obs(observe(params, one), one).map(lambda a: a[0])

    def z(dtype):
        return torch.zeros((), dtype=dtype, device=dev)

    i, f = z(_i32), z(torch.float32)
    rec = RingRec(sid=i, seq=i, params_version=i, stage_idx=i, job_idx=i,
                  num_exec=i, lgprob=f, reward=f, dt=f, wall_time=f,
                  done=z(torch.bool), health_mask=i, obs=so)
    return make_ring(R, rec)


def _ring_rec(out: ServeOut, sid, seq, pver) -> RingRec:
    """The ring records of a program's output rows."""
    return RingRec(
        sid=sid, seq=seq, params_version=pver,
        stage_idx=out.stage_idx, job_idx=out.job_idx,
        num_exec=out.num_exec, lgprob=out.lgprob, reward=out.reward,
        dt=out.dt, wall_time=out.wall_time, done=out.done,
        health_mask=out.health_mask, obs=out.obs,
    )


# engine knobs of the serve drain, the JAX package's (its round-5
# calibration: bulk passes on, bulk_events 8, one fused cycle)
SERVE_KNOBS: dict[str, Any] = {
    "event_bulk": True,
    "bulk_events": 8,
    "fulfill_bulk": True,
    "bulk_cycles": 1,
    "bulk_fused": True,
}


def _decide(params: EnvParams, bank: WorkloadBank, policy_fn: Callable,
            ls: LoopState, k_pol, k_env, force_stage, force_nexec,
            use_force, knobs: dict[str, Any], record: bool = False):
    """Decisions for a batch of sessions (the JAX `_decide_one`, over a
    lane axis): observe -> policy with one key of `k_pol` per lane (or
    the forced action under `use_force`) -> apply_and_drain with one
    key of `k_env` per lane -> health. A greedy policy ignores its
    keys. With `record` the output carries each lane's `StoredObs` of
    the observation the decision was taken on."""
    env0 = ls.env
    was_done = _lane_done(env0)
    s_cap = params.max_stages
    obs = None
    if bool(use_force.all()):
        # every lane takes the caller's action: the policy's output would
        # be overridden, so it is not computed
        stage_idx = force_stage
        num_exec = force_nexec
        lgprob = torch.zeros(force_stage.shape, device=force_stage.device)
        job = torch.zeros_like(force_stage)
    else:
        obs = observe(params, env0)
        stage_idx, num_exec, aux = policy_fn(k_pol, obs)
        lgprob, job, _ = aux_action_fields(aux, stage_idx, num_exec, s_cap)
    rec_obs = None
    if record:
        # the engine is functional: env0 (a gathered copy) stays the
        # pre-decision state the record must describe
        rec_obs = store_obs(observe(params, env0) if obs is None else obs,
                            env0)
    stage_idx = torch.where(use_force, force_stage, stage_idx).to(_i32)
    num_exec = torch.where(use_force, force_nexec, num_exec).to(_i32)
    job = torch.where(
        use_force,
        torch.where(stage_idx >= 0,
                    torch.div(stage_idx, s_cap, rounding_mode="floor"), 0),
        job,
    ).to(_i32)
    lgprob = torch.where(use_force, 0.0, lgprob).to(torch.float32)
    ls2, (decided, reward, dt, reset) = apply_and_drain(
        params, bank, ls, stage_idx, num_exec, k_env, auto_reset=False,
        **knobs,
    )
    hm = state_health(ls2.env, prev=env0, resetting=reset) | \
        reward_health(reward)
    out = ServeOut(
        stage_idx=torch.where(decided, stage_idx, -1).to(_i32),
        job_idx=job,
        num_exec=num_exec,
        lgprob=lgprob,
        decided=decided,
        done=_lane_done(ls2.env),
        reward=reward,
        dt=dt,
        wall_time=ls2.env.wall_time,
        health_mask=torch.where(was_done, 0, hm).to(_i32),
        valid=torch.ones_like(decided),
        obs=rec_obs,
    )
    return ls2, out


@functools.lru_cache(maxsize=None)
def _call_paths(K: int, device: torch.device) -> torch.Tensor:
    """The paths from the store's root of a call's keys: the policy and
    engine keys (call, 0) and (call, 1) of a single call (K = 0, [2, 2]),
    or their K-way splits (call, 0, i) and (call, 1, i) of a batched one
    ([2, K, 3]); the call's count is the table's varying counter."""
    c = prng.PATH_VAR
    if not K:
        return prng.path_table([(c, 0), (c, 1)], device)
    rows = [(c, h, i) for h in (0, 1) for i in range(K)]
    return prng.path_table(rows, device, (2, K))


def _single_program(params: EnvParams, bank: WorkloadBank,
                    policy_fn: Callable, kn: dict[str, Any], record: bool):
    """One session's decision: `(store, slot, root, call, force_stage,
    force_nexec, use_force) -> (ServeOut of one row, decisions after)`."""

    def fn(store: LoopState, slot: int, root: torch.Tensor, call: int,
           force_stage: int, force_nexec: int, use_force: bool):
        dev = store.mode.device
        idx = torch.tensor([slot], device=dev)
        ls = take_slot(store, idx)

        def t(v, dtype):
            return torch.tensor([v], dtype=dtype, device=dev)

        k_pol, k_env = prng.derive(root, _call_paths(0, root.device),
                                   call)[:, None]
        ls2, out = _decide(
            params, bank, policy_fn, ls, k_pol, k_env, t(force_stage, _i32),
            t(force_nexec, _i32), t(use_force, torch.bool), kn,
            record=record,
        )
        write_slot(store, idx, ls2)
        return out, ls2.decisions

    return fn


def _batch_program(params: EnvParams, bank: WorkloadBank,
                   batch_policy_fn: Callable, K: int, kn: dict[str, Any],
                   record: bool):
    """Up to K sessions' decisions: `(store, slots [K], root, call) ->
    (ServeOut of [K], decisions after [K])`, padding rows filled."""

    def fn(store: LoopState, slots: torch.Tensor, root: torch.Tensor,
           call: int):
        if slots.shape != (K,):
            raise ValueError(f"slots must have shape ({K},)")
        C = store.mode.shape[0]
        valid = slots < C
        real = slots[valid]
        dev = real.device
        n = real.shape[0]
        if n == 0:
            raise ValueError("a batch needs at least one real slot")
        ls = take_slot(store, real)
        pos = valid.nonzero()[:, 0]
        k_pol, k_env = prng.derive(root, _call_paths(K, root.device),
                                   call)[:, pos]
        no = torch.zeros(n, dtype=_i32, device=dev)
        ls2, out = _decide(
            params, bank, batch_policy_fn, ls, k_pol, k_env, no, no,
            torch.zeros(n, dtype=torch.bool, device=dev), kn, record=record,
        )
        write_slot(store, real, ls2)

        def pad(v: torch.Tensor, fill=0) -> torch.Tensor:
            full = torch.full((K,) + tuple(v.shape[1:]), fill,
                              dtype=v.dtype, device=v.device)
            full[pos] = v
            return full

        return ServeOut(
            stage_idx=pad(out.stage_idx, -1), job_idx=pad(out.job_idx),
            num_exec=pad(out.num_exec), lgprob=pad(out.lgprob),
            decided=pad(out.decided), done=pad(out.done),
            reward=pad(out.reward), dt=pad(out.dt),
            wall_time=pad(out.wall_time),
            health_mask=pad(out.health_mask), valid=valid,
            obs=None if out.obs is None else out.obs.map(pad),
        ), pad(ls2.decisions)

    return fn


def serve_decide_fn(params: EnvParams, bank: WorkloadBank,
                    policy_fn: Callable,
                    knobs: dict[str, Any] | None = None,
                    record: bool = False) -> Callable:
    """The single-session program:
    `(store [C], slot, root, call, force_stage, force_nexec, use_force)
    -> ServeOut` of one row; the store is updated in place. The call's
    key `fold_in(root, call)` splits as the JAX program's does: (policy,
    engine). `record` adds the decision's `StoredObs`."""
    prog = _single_program(params, bank, policy_fn,
                           SERVE_KNOBS | (knobs or {}), record)
    return lambda *args: prog(*args)[0]


def serve_decide_batch_fn(params: EnvParams, bank: WorkloadBank,
                          batch_policy_fn: Callable, batch: int,
                          knobs: dict[str, Any] | None = None,
                          record: bool = False) -> Callable:
    """The batched program: `(store [C], slots [K], root, call) ->
    ServeOut of [K]`. ONE batched policy evaluation over the gathered
    sessions, then the batched apply-and-drain, batch position i on the
    i-th key of the engine key's K-way split (the JAX program's); the
    store is updated in place. Slots equal to C are padding. A
    stochastic policy samples lane i on the i-th key of the policy key's
    K-way split. `record` adds each lane's `StoredObs`."""
    prog = _batch_program(params, bank, batch_policy_fn, int(batch),
                          SERVE_KNOBS | (knobs or {}), record)
    return lambda *args: prog(*args)[0]


def serve_decide_ring_fn(params: EnvParams, bank: WorkloadBank,
                         policy_fn: Callable,
                         knobs: dict[str, Any] | None = None) -> Callable:
    """The ring-recording single-session program:
    `(store [C], ring, slot, sid, pver, root, call, force_stage,
    force_nexec, use_force) -> ServeOut` of one row. The record-on decision, whose
    full `RingRec` (stamped with `sid`, the version `pver` and the
    lane's decision count as `seq`) is appended to `ring` when the lane
    decided; the output carries no `obs`, the record-off payload. Store
    and ring are updated in place."""
    prog = _single_program(params, bank, policy_fn,
                           SERVE_KNOBS | (knobs or {}), True)

    def fn(store: LoopState, ring: TrajRing, slot: int, sid: int,
           pver: int, root: torch.Tensor, call: int, force_stage: int,
           force_nexec: int, use_force: bool) -> ServeOut:
        out, seq = prog(store, slot, root, call, force_stage, force_nexec,
                        use_force)
        dev = seq.device
        stamp = functools.partial(torch.full, (1,), dtype=_i32, device=dev)
        ring_append(ring, _ring_rec(out, stamp(sid), seq.to(_i32),
                                    stamp(pver)), out.decided)
        out.obs = None
        return out

    return fn


def serve_decide_batch_ring_fn(params: EnvParams, bank: WorkloadBank,
                               batch_policy_fn: Callable, batch: int,
                               knobs: dict[str, Any] | None = None
                               ) -> Callable:
    """The ring-recording batched program:
    `(store [C], ring, slots [K], sids [K], pver, root, call) -> ServeOut
    of [K]`. The record-on batch, one masked append of its decided lanes in
    lane order (padding and no-decision lanes go to the sink), and the
    record-off payload. `pver` is one version for the whole call: every
    decision of a batch reads the same weights."""
    K = int(batch)
    prog = _batch_program(params, bank, batch_policy_fn, K,
                          SERVE_KNOBS | (knobs or {}), True)

    def fn(store: LoopState, ring: TrajRing, slots: torch.Tensor,
           sids: torch.Tensor, pver: int, root: torch.Tensor,
           call: int) -> ServeOut:
        out, seq = prog(store, slots, root, call)
        pv = torch.full((K,), pver, dtype=_i32, device=seq.device)
        ring_append(ring, _ring_rec(out, sids.to(_i32), seq.to(_i32), pv),
                    out.decided)
        out.obs = None
        return out

    return fn


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class HostCopy:
    """A served call's outputs on their way to the host. On the card the
    copy goes into pinned buffers with `non_blocking=True` and an event
    recorded after it: `ready()` asks the event (no host sync),
    `numpy()` waits on it. On the CPU the outputs already are host
    tensors. `numpy()` issues no device op, so a harvester thread may
    call it. A record-on call's `obs` fields travel as `obs.<field>`."""

    __slots__ = ("_host", "_event")

    def __init__(self, out: ServeOut) -> None:
        vals = {k: v for k, v in vars(out).items() if k != "obs"}
        if out.obs is not None:
            vals.update({f"obs.{k}": v for k, v in vars(out.obs).items()})
        if out.valid.device.type == "cuda":
            self._host = {k: _pinned_like(v).copy_(v, non_blocking=True)
                          for k, v in vals.items()}
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = dict(vals), None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return {k: v.numpy() for k, v in self._host.items()}


class ColdSlot:
    """One paged-out session: the exact served view of its slot
    (`take_slot`, the serve programs' gather) in an independent device
    buffer, and on the card a pinned host copy started behind it. Until
    `drain` drops the device buffer, a page-in takes it directly (a
    device-to-device round trip); after, it copies the host buffers
    back. Every leaf is copied with `copy_` at its own dtype, so the
    round trip is bit-exact. On the CPU the gather itself is the host
    copy."""

    __slots__ = ("dev", "host", "_event")

    def __init__(self, store: LoopState, local: int) -> None:
        dev = take_slot(store, torch.tensor([local],
                                            device=store.mode.device))
        if store.mode.device.type == "cuda":
            self.dev = dev
            self.host = tree_map(
                lambda a: _pinned_like(a).copy_(a, non_blocking=True), dev)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self.dev, self.host, self._event = None, dev, None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def drain(self) -> None:
        """Free the device copy once the host copy has landed (waits for
        it)."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        self.dev = None

    def source(self, device: torch.device) -> LoopState:
        """The slot to write back on a page-in."""
        if self.dev is not None:
            return self.dev
        if device.type == "cuda":
            return tree_map(lambda a: a.to(device, non_blocking=True),
                            self.host)
        return self.host


class RingSnapshot:
    """A drain's copy of one group's ring (its cursor and its R record
    rows). On the card the copies go into pinned host buffers with
    `non_blocking=True` and an event recorded after them. They are
    ordered on the serving stream after every call already issued and
    before any later one, so they read the ring as it stood at the
    snapshot with no device-side clone and no host sync; `ready()` asks
    the event, `numpy()` waits on it. On the CPU the snapshot is a
    clone."""

    __slots__ = ("cursor", "rec", "_event")

    def __init__(self, ring: TrajRing) -> None:
        R = ring.size
        if ring.cursor.device.type == "cuda":
            self.cursor = _pinned_like(ring.cursor).copy_(ring.cursor,
                                                          non_blocking=True)
            self.rec = rec_map(
                lambda a: _pinned_like(a[:R]).copy_(a[:R], non_blocking=True),
                ring.rec)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self.cursor = ring.cursor.clone()
            self.rec = rec_map(lambda a: a[:R].clone(), ring.rec)
            self._event = None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> tuple[int, Any]:
        """(cursor, the record tree as numpy arrays)."""
        if self._event is not None:
            self._event.synchronize()
        return int(self.cursor), rec_map(lambda a: a.numpy(), self.rec)
