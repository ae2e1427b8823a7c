"""Host-side trajectory assembly from served decisions (counterpart of
`sparksched_tpu/online/trajectory.py`).

The actor half of the online learning loop: a record-on `SessionStore`
hands every served decision to this buffer as a `ServeResult` carrying
the decision's `StoredObs` record (the schema the training collector
writes, `trainers/rollout.py:store_obs`), or, with a device ring, as
drained chunks of `RingRec`s. The buffer assembles per-SESSION episodes
in arrival order (serving interleaves sessions across batches;
trajectories must not), cuts them into bounded segments, and keeps a
bounded FIFO of completed trajectories:

- a session's episode completes when its decision reports `done`, when
  the session is closed (partial segment), or when an open episode
  reaches `max_steps` decisions (a segment cut: the learner's padded T
  bounds segment length anyway);
- a QUARANTINED session's open episode is DROPPED, not learned from
  (`online_dropped_quarantined`);
- completed trajectories past `capacity` are evicted OLDEST first and
  counted (`online_dropped_overflow`);
- every decision carries its staleness stamp (`params_version` at
  dispatch) into the trajectory, which the learner's off-policy guard
  filters on.

Everything here is host numpy. Thread-safe by a single lock: the
serving thread adds, the background learner drains.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any

import numpy as np

from ..env.flat_loop import rec_map


class Trajectory:
    """One completed per-session decision segment (host numpy).

    Per-step arrays have leading [t] (t = `length` decisions); `obs` is
    a `StoredObs` of [t, ...] arrays. `wall_times` is [t + 1] (the obs
    times plus the final post-drain time, the collector's layout that
    `trainers/returns.step_dts` consumes); `params_version` is the
    per-decision staleness stamp; `done` marks a natural episode end
    (against a segment cut or a session close)."""

    __slots__ = (
        "session_id", "obs", "stage_idx", "job_idx", "num_exec_k",
        "lgprob", "reward", "wall_times", "params_version", "length",
        "done",
    )

    def __init__(self, session_id: int, steps: list[dict[str, Any]],
                 t0: float, done: bool) -> None:
        self.session_id = session_id
        self.length = len(steps)
        self.done = bool(done)
        self.obs = None
        if steps:
            self.obs = rec_map(
                lambda *ls: np.stack([np.asarray(x) for x in ls]),
                *[s["obs"] for s in steps])
        self.stage_idx = np.array([s["stage_idx"] for s in steps], np.int32)
        self.job_idx = np.array([s["job_idx"] for s in steps], np.int32)
        self.num_exec_k = np.array([s["num_exec_k"] for s in steps],
                                   np.int32)
        self.lgprob = np.array([s["lgprob"] for s in steps], np.float32)
        self.reward = np.array([s["reward"] for s in steps], np.float32)
        # wall_times[k] = obs-k time: t0 (the first step's pre-decision
        # clock), then each step's post-drain clock
        self.wall_times = np.concatenate(
            [[np.float32(t0)],
             np.array([s["wall_time"] for s in steps], np.float32)]
        )
        self.params_version = np.array(
            [s["params_version"] for s in steps], np.int32)

    @property
    def reward_sum(self) -> float:
        return float(self.reward.sum())

    def max_lag(self, current_version: int) -> int:
        """The largest params-version lag of any decision in the segment
        against `current_version`: the off-policy guard's statistic."""
        if self.length == 0:
            return 0
        return int(current_version - int(self.params_version.min()))


class TrajectoryBuffer:
    """Bounded per-session episode assembler + completed-trajectory
    FIFO. Implements the `SessionStore.collector` protocol: `add(result)`
    per served decision, `ingest_chunk(chunk)` per drained ring chunk,
    `on_close(sid, quarantined=)` at session teardown."""

    def __init__(self, capacity: int = 64, max_steps: int = 64,
                 min_decisions: int = 2, metrics=None) -> None:
        if capacity < 1 or max_steps < 1:
            raise ValueError(
                f"capacity={capacity} / max_steps={max_steps} must be "
                ">= 1"
            )
        self.capacity = int(capacity)
        self.max_steps = int(max_steps)
        self.min_decisions = int(min_decisions)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._open: dict[int, dict[str, Any]] = {}
        self._done: deque[Trajectory] = deque()
        self.stats = {
            "online_decisions": 0,
            "online_trajectories": 0,
            "online_dropped_overflow": 0,
            "online_dropped_short": 0,
            "online_dropped_quarantined": 0,
            "online_dropped_stale": 0,
            # open episodes dropped because a ring overrun ate records
            # (a per-session seq gap in a drained chunk): a spliced
            # trajectory must never reach the learner
            "online_dropped_gap": 0,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)

    @property
    def open_sessions(self) -> int:
        with self._lock:
            return len(self._open)

    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        if self.metrics is not None:
            self.metrics.counter(key, n)

    # -- the SessionStore.collector protocol ---------------------------

    def add(self, res) -> None:
        """One served decision (a `ServeResult` of a record-on store).
        A decision without its record fails loudly: silently learning on
        nothing is the failure this check removes."""
        if res.decided and res.obs is None:
            raise ValueError(
                "TrajectoryBuffer.add needs record-on serve results "
                "(SessionStore(record=True)); this store serves "
                "without per-decision StoredObs records"
            )
        with self._lock:
            sid = res.session_id
            if res.health_mask:
                # poisoned decision: the store quarantines the session;
                # its trajectory (this step included) is dropped
                self._drop_locked(sid, "online_dropped_quarantined")
                return
            if res.decided:
                ep = self._open.get(sid)
                if ep is None:
                    # the first step's pre-decision clock
                    ep = self._open[sid] = {
                        "t0": res.wall_time - res.dt, "steps": [],
                    }
                ep["steps"].append({
                    "obs": res.obs,
                    "stage_idx": res.stage_idx,
                    "job_idx": res.job_idx,
                    "num_exec_k": res.num_exec - 1,
                    "lgprob": res.lgprob,
                    "reward": res.reward,
                    "wall_time": res.wall_time,
                    "params_version": res.params_version,
                })
                self._count("online_decisions")
            if res.done:
                self._finish_locked(sid, done=True)
            elif (sid in self._open
                  and len(self._open[sid]["steps"]) >= self.max_steps):
                self._finish_locked(sid, done=False)  # segment cut

    def ingest_chunk(self, chunk) -> None:
        """One drained ring chunk: a `serve.aot.RingRec` of [n] numpy
        arrays in append order, the batched replacement for n `add()`
        calls. Per-session episodes are rebuilt from the `(sid, seq,
        params_version)` stamps, replaying `add()`'s assembly exactly
        (the same step dicts, the same Python scalars, the same
        quarantine / done / segment-cut transitions), so ring-drained
        trajectories equal the per-decision path's. Only decided records
        enter the ring, and a decided record that ends its episode
        carries `done` itself. A per-session `seq` gap (a ring overrun
        ate records) drops the corrupted open episode
        (`online_dropped_gap`) and starts afresh."""
        n = int(np.asarray(chunk.sid).shape[0])
        if n == 0:
            return
        with self._lock:
            for i in range(n):
                sid = int(chunk.sid[i])
                if int(chunk.health_mask[i]):
                    self._drop_locked(sid, "online_dropped_quarantined")
                    continue
                seq = int(chunk.seq[i])
                ep = self._open.get(sid)
                if (ep is not None and "seq" in ep
                        and seq != ep["seq"] + 1):
                    self._drop_locked(sid, "online_dropped_gap")
                    ep = None
                wall = float(chunk.wall_time[i])
                if ep is None:
                    ep = self._open[sid] = {
                        "t0": wall - float(chunk.dt[i]), "steps": [],
                    }
                ep["seq"] = seq
                ep["steps"].append({
                    "obs": rec_map(lambda a: a[i], chunk.obs),
                    "stage_idx": int(chunk.stage_idx[i]),
                    "job_idx": int(chunk.job_idx[i]),
                    "num_exec_k": int(chunk.num_exec[i]) - 1,
                    "lgprob": float(chunk.lgprob[i]),
                    "reward": float(chunk.reward[i]),
                    "wall_time": wall,
                    "params_version": int(chunk.params_version[i]),
                })
                self._count("online_decisions")
                if bool(chunk.done[i]):
                    self._finish_locked(sid, done=True)
                elif len(ep["steps"]) >= self.max_steps:
                    self._finish_locked(sid, done=False)

    def on_close(self, sid: int, quarantined: bool = False) -> None:
        """Session teardown: finalize the partial segment (or drop it,
        when the close is a quarantine)."""
        with self._lock:
            if quarantined:
                self._drop_locked(sid, "online_dropped_quarantined")
            else:
                self._finish_locked(sid, done=False)

    # -- internals -----------------------------------------------------

    def _drop_locked(self, sid: int, counter: str) -> None:
        if self._open.pop(sid, None) is not None:
            self._count(counter)

    def _finish_locked(self, sid: int, done: bool) -> None:
        ep = self._open.pop(sid, None)
        if ep is None:
            return
        if len(ep["steps"]) < self.min_decisions:
            self._count("online_dropped_short")
            return
        self._done.append(Trajectory(sid, ep["steps"], ep["t0"], done))
        self._count("online_trajectories")
        while len(self._done) > self.capacity:
            self._done.popleft()  # FIFO eviction, oldest first
            self._count("online_dropped_overflow")

    # -- the learner side ----------------------------------------------

    def drain(self, n: int, current_version: int | None = None,
              max_lag: int | None = None) -> list[Trajectory]:
        """Pop up to `n` completed trajectories, oldest first. With a
        staleness bound (`current_version` + `max_lag`), trajectories
        whose params-version lag exceeds it are DISCARDED and counted
        (`online_dropped_stale`) instead of returned."""
        out: list[Trajectory] = []
        with self._lock:
            while self._done and len(out) < n:
                tr = self._done.popleft()
                if (max_lag is not None and current_version is not None
                        and tr.max_lag(current_version) > max_lag):
                    self._count("online_dropped_stale")
                    continue
                out.append(tr)
        return out

    def requeue(self, trajs: list[Trajectory]) -> None:
        """Return drained trajectories to the FRONT of the completed
        queue (they were the oldest): if the serving thread filled the
        buffer between drain and requeue, the overflow eviction drops
        these stale returns, not the fresh arrivals."""
        with self._lock:
            self._done.extendleft(reversed(trajs))
            while len(self._done) > self.capacity:
                self._done.popleft()
                self._count("online_dropped_overflow")
