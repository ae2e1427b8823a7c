"""The learner half of the online loop: PPO on served-decision
trajectories (counterpart of `sparksched_tpu/online/learner.py`).

Actors are the serving sessions (a record-on `SessionStore` feeding the
`TrajectoryBuffer`); the learner drains completed trajectories into
FIXED-SHAPE rollouts, each segment padded and masked into the
collector's `Rollout` layout (`trainers/rollout.py`), so the trainer's
`PPO._update` runs unchanged: the health gates, the skip of a poisoned
minibatch, the KL stop, both encoder kernels on the card.

The learner owns its weights: its trainer builds its own scheduler,
seeded from the store's live weights, and updates them in place with
its own Adam state. An accepted update is published as a COPY of the
weights; on the card the learner works on its own CUDA stream and the
copy comes with an event recorded after it, which the serving thread's
swap waits on (`online/bus.py`).

Off-policy handling, two layers:
- a HARD staleness bound (`max_param_lag`): trajectories whose
  params-version lag against the learner's current version exceeds it
  are discarded and counted (`TrajectoryBuffer.drain`);
- PPO's ratio clipping weighs down whatever lag remains inside the
  bound (the stored log-probs are the behaviour policy's).

Health gates and rollback: the update runs with the `health:` block on;
a post-update `health_mask` with a retryable bit, or a non-finite loss,
rejects the step: the learner restores the weights and Adam state it
had before (the trainer's rollback pattern) and publishes nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import prng
from ..config import EnvParams
from ..env import core
from ..env.health import RETRYABLE_MASK, describe_mask
from ..env.state import EnvState
from ..obs.runlog import emit
from ..ownership import assert_owner
from ..trainers.ppo import PPO
from ..trainers.rollout import Rollout, zero_stored
from .trajectory import Trajectory, TrajectoryBuffer

# learner-trainer defaults: shorter epochs and batches than offline
# training (online minibatches are small and frequent), the flagship
# clip/KL settings otherwise
_LEARNER_TRAIN_DEFAULTS: dict[str, Any] = {
    "num_epochs": 2,
    "num_batches": 2,
    "clip_range": 0.2,
    "target_kl": 0.01,
    "entropy_coeff": 0.04,
    "beta_discount": 5.0e-3,
    "opt_kwargs": {"lr": 3.0e-4},
    "max_grad_norm": 0.5,
}


def make_learner_trainer(
    agent_cfg: dict[str, Any],
    env_params: EnvParams,
    batch_trajectories: int,
    max_steps: int,
    learner_cfg: dict[str, Any] | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> PPO:
    """A `PPO` trainer shaped for the online learner: B =
    `batch_trajectories` lanes as ONE baseline group (online sessions run
    independent arrival sequences, so the critic-free baseline is the
    cross-trajectory mean), T = `max_steps` decisions, health gates ON.
    Its `_update` is the offline trainer's; its collector never runs."""
    env_cfg = {
        k: v for k, v in dataclasses.asdict(env_params).items()
        if v is not None
    }
    train_cfg = dict(_LEARNER_TRAIN_DEFAULTS)
    train_cfg.update(learner_cfg or {})
    if "reward_buff_cap" in train_cfg and "beta_discount" not in (
        learner_cfg or {}
    ):
        # the trainer demands exactly ONE returns mode; an explicit
        # reward_buff_cap override displaces the default discount
        train_cfg.pop("beta_discount", None)
    train_cfg.update({
        "trainer_cls": "PPO",
        "num_iterations": 1,
        "num_sequences": 1,
        "num_rollouts": int(batch_trajectories),
        "rollout_steps": int(max_steps),
        "seed": int(seed),
        "use_tensorboard": False,
        "checkpointing_freq": 10 ** 9,
        # the port's trainer accepts only the collector it has; the
        # learner never collects
        "rollout_engine": "flat",
        "flat_single_eval": True,
    })
    return PPO(
        dict(agent_cfg), env_cfg, train_cfg,
        health_cfg={"enabled": True}, device=device,
    )


class OnlineLearner:
    """Drains the `TrajectoryBuffer`, updates, publishes to the
    `ParamBus`. Drive it inline (`step()` between serving windows) or as
    a background thread (`start_background()`); the bus applies swaps on
    the SERVING thread, between calls, either way."""

    def __init__(
        self,
        trainer: PPO,
        buffer: TrajectoryBuffer,
        bus=None,
        *,
        max_param_lag: int = 4,
        swap_every: int = 1,
        init_params=None,
        version0: int = 0,
        runlog=None,
        metrics=None,
    ) -> None:
        self.trainer = trainer
        self.buffer = buffer
        self.bus = bus
        self.max_param_lag = int(max_param_lag)
        self.swap_every = int(swap_every)
        self.runlog = runlog
        self.metrics = metrics
        self.B = trainer.num_rollouts
        self.T = trainer.rollout_steps
        self.device = trainer.device
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.state = trainer.init_state()
        if init_params is not None:
            # start from the SERVING weights (one policy, two stacks),
            # copied into the learner's own tensors
            with torch.no_grad():
                trainer.scheduler.load_params(
                    {k: v.detach() for k, v in init_params.items()})
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # published versions continue the store's numbering, so the
        # per-decision staleness stamps and the learner's lag share one
        # monotonic axis
        self.version = int(version0)
        self.stats = {
            "learner_steps": 0,
            "learner_rejected": 0,
            "learner_published": 0,
        }
        self.history: list[dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # what ended the background thread, if it raised
        self.error: BaseException | None = None

        # the padding template: one reset state broadcast to [B] fills
        # the Rollout's final_state (required by the layout, unused by
        # the update)
        p, bank = trainer.params_env, trainer.bank
        state0 = core.reset(p, bank, prng.PRNGKey(17, self.device)[None])
        self._final_state = EnvState(**{
            f.name: getattr(state0, f.name).expand(
                (self.B,) + getattr(state0, f.name).shape[1:])
            for f in dataclasses.fields(EnvState)
        })

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    # -- rollout assembly ----------------------------------------------

    def _pad_rollout(self, trajs: list[Trajectory]) -> Rollout:
        """Pad B trajectory segments into the collector's layout: [B,T]
        per-step fields, `valid` masking real decisions, walls
        forward-filled with each lane's final time (the collector's
        padding), resets zero (segments never span an auto-reset:
        episode ends end the segment)."""
        B, T = self.B, self.T
        assert len(trajs) == B, (len(trajs), B)
        obs = zero_stored(self.trainer.params_env, (B, T), "cpu").map(
            lambda t: t.numpy())
        stage_idx = np.full((B, T), -1, np.int32)
        job_idx = np.zeros((B, T), np.int32)
        num_exec_k = np.zeros((B, T), np.int32)
        lgprob = np.zeros((B, T), np.float32)
        reward = np.zeros((B, T), np.float32)
        walls = np.zeros((B, T + 1), np.float32)
        valid = np.zeros((B, T), bool)
        for b, tr in enumerate(trajs):
            t = min(tr.length, T)
            if t and tr.obs is not None:
                for f in dataclasses.fields(obs):
                    getattr(obs, f.name)[b, :t] = np.asarray(
                        getattr(tr.obs, f.name))[:t]
            stage_idx[b, :t] = tr.stage_idx[:t]
            job_idx[b, :t] = tr.job_idx[:t]
            num_exec_k[b, :t] = tr.num_exec_k[:t]
            lgprob[b, :t] = tr.lgprob[:t]
            reward[b, :t] = tr.reward[:t]
            walls[b, : t + 1] = tr.wall_times[: t + 1]
            walls[b, t + 1:] = tr.wall_times[t]  # forward-fill final
            valid[b, :t] = True

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        return Rollout(
            obs=obs.map(dev),
            stage_idx=dev(stage_idx),
            job_idx=dev(job_idx),
            num_exec_k=dev(num_exec_k),
            lgprob=dev(lgprob),
            reward=dev(reward),
            wall_times=dev(walls),
            valid=dev(valid),
            resets=dev(np.zeros((B, T), bool)),
            final_state=self._final_state,
            final_reset_count=dev(np.zeros((B,), np.int32)),
        )

    # -- the update ----------------------------------------------------

    def ready(self) -> bool:
        return len(self.buffer) >= self.B

    def warmup(self) -> float:
        """Run the update once on an all-padding rollout and restore the
        state, so the first real step does not pay first-use costs (the
        stream, the allocator, kernel loading)."""
        t0 = time.perf_counter()
        dummy = [Trajectory(0, [], 0.0, True) for _ in range(self.B)]
        with self._on_stream():
            snap = self.state.snapshot()
            self.trainer._update(self.state, self._pad_rollout(dummy))
            self.state.restore(snap)
        if self.stream is not None:
            self.stream.synchronize()
        return time.perf_counter() - t0

    def step(self) -> dict[str, Any] | None:
        """One learner update, if >= B completed trajectories are
        buffered (None otherwise): drain (stale segments discarded by the
        off-policy guard), pad, `PPO._update`, health-gate, and, when
        accepted, publish the new version to the bus. Returns the step's
        info dict."""
        assert_owner(self, "online-learner")
        trajs = self.buffer.drain(
            self.B, current_version=self.version,
            max_lag=self.max_param_lag,
        )
        while len(trajs) < self.B and len(self.buffer) > 0:
            trajs += self.buffer.drain(
                self.B - len(trajs), current_version=self.version,
                max_lag=self.max_param_lag,
            )
        if len(trajs) < self.B:
            # not enough fresh segments: put back what was taken
            self.buffer.requeue(trajs)
            return None
        t0 = time.perf_counter()
        with self._on_stream():
            ro = self._pad_rollout(trajs)
            last_good = self.state.snapshot()
            _, stats = self.trainer._update(self.state, ro)
        stats = {k: (None if v is None else float(v))
                 for k, v in stats.items()}
        mask = int(stats.get("health_mask") or 0)
        info = {
            "policy_loss": stats["policy_loss"],
            "approx_kl_div": stats["approx_kl_div"],
            "entropy": stats["entropy"],
            "health_mask": mask,
            "decisions": int(sum(tr.length for tr in trajs)),
            "traj_reward_mean": float(
                np.mean([tr.reward_sum for tr in trajs])),
            "max_lag": max(tr.max_lag(self.version) for tr in trajs),
            # the port's update counts what it applied (not in JAX's)
            "minibatches_applied": stats.get("minibatches_applied"),
        }
        if mask & RETRYABLE_MASK or not np.isfinite(info["policy_loss"]):
            # the trainer's rollback: keep the last-good weights and Adam
            # state, never publish a poisoned version
            with self._on_stream():
                self.state.restore(last_good)
            self.stats["learner_rejected"] += 1
            if self.metrics is not None:
                self.metrics.counter("online_learner_rejected")
            if self.runlog is not None:
                self.runlog.health(mask, action="learner_rollback",
                                   origin="online_learner")
            emit(
                f"[online] learner update rejected "
                f"({describe_mask(mask) or ['non-finite loss']}); "
                "state rolled back"
            )
            info["accepted"] = False
            info["update_s"] = time.perf_counter() - t0
            self.history.append(info)
            return info
        self.version += 1
        self.stats["learner_steps"] += 1
        if self.metrics is not None:
            self.metrics.counter("online_learner_steps")
        info["accepted"] = True
        info["version"] = self.version
        if self.bus is not None and self.version % self.swap_every == 0:
            with self._on_stream():
                pub = {k: v.detach().clone()
                       for k, v in self.state.params.items()}
                ready = None
                if self.stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self.stream)
            self.bus.publish(pub, self.version, ready=ready)
            self.stats["learner_published"] += 1
        info["update_s"] = time.perf_counter() - t0
        if self.runlog is not None:
            self.runlog.scalars(self.version, {
                "online_policy_loss": info["policy_loss"],
                "online_kl": info["approx_kl_div"],
                "online_traj_reward_mean": info["traj_reward_mean"],
                "online_version": self.version,
            })
        self.history.append(info)
        return info

    # -- background mode -----------------------------------------------

    def start_background(self, interval_s: float = 0.02) -> None:
        """A learner thread polling the buffer. Its updates run beside
        the serving calls (on their own stream on the card); published
        weights are APPLIED by the serving thread via `ParamBus.pump`,
        between calls. An exception ends the thread and is kept in
        `error`."""
        if self._thread is not None:
            raise RuntimeError("learner thread already running")
        self._stop.clear()

        def loop() -> None:
            try:
                while not self._stop.is_set():
                    if self.ready():
                        self.step()
                    else:
                        time.sleep(interval_s)
            except Exception as e:  # the thread ends; the caller sees it
                self.error = e

        self._thread = threading.Thread(
            target=loop, name="online-learner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=60.0)
        self._thread = None
