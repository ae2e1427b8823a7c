"""Health sentinels over the environment state (counterpart of
`sparksched_tpu/env/health.py`: the bit table, `state_health`,
`reward_health` and `grad_health`).

A health mask is an i32 bitmask of invariant violations computed as
tensor reductions, one per lane."""

from __future__ import annotations

import torch

from .state import EnvState

H_NONFINITE_TIME = 1
H_COMMIT_CONSERVE = 2
H_EXEC_CONSERVE = 4
H_TASK_MONOTONIC = 8
H_NONFINITE_REWARD = 16
H_NONFINITE_LOSS = 32
H_NONFINITE_GRAD = 64
H_NONFINITE_PARAM = 128
H_STRAGGLER = 256
H_OOM = 512

HEALTH_BITS: dict[str, int] = {
    "nonfinite_time": H_NONFINITE_TIME,
    "commit_conservation": H_COMMIT_CONSERVE,
    "exec_conservation": H_EXEC_CONSERVE,
    "task_monotonicity": H_TASK_MONOTONIC,
    "nonfinite_reward": H_NONFINITE_REWARD,
    "nonfinite_loss": H_NONFINITE_LOSS,
    "nonfinite_grad": H_NONFINITE_GRAD,
    "nonfinite_param": H_NONFINITE_PARAM,
    "straggler": H_STRAGGLER,
    "oom": H_OOM,
}

RETRYABLE_MASK = (
    H_NONFINITE_TIME | H_COMMIT_CONSERVE | H_EXEC_CONSERVE
    | H_TASK_MONOTONIC | H_NONFINITE_REWARD | H_NONFINITE_LOSS
    | H_NONFINITE_GRAD | H_NONFINITE_PARAM | H_OOM
)


def describe_mask(mask: int) -> list[str]:
    """Decoded bit names of a host-side mask int."""
    m = int(mask)
    return [name for name, bit in HEALTH_BITS.items() if m & bit]


def _bit(pred: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(pred, bit, 0).to(torch.int32)


def _any(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).any(1)


def state_health(state: EnvState, prev: EnvState | None = None,
                 resetting: torch.Tensor | None = None) -> torch.Tensor:
    """i32[B] violation bitmask per lane. `prev` enables the cross-step
    monotonicity check; `resetting` ([B]) disables it per lane."""
    bad_time = ~torch.isfinite(state.wall_time) | _any(
        state.stage_exists & ~torch.isfinite(state.stage_duration)
    ) | _any(torch.isnan(state.job_t_completed))
    bad_commit = _any(state.commit_count != state.commit_count_to_stage) | \
        _any(state.moving_count != state.moving_count_to_stage)
    bad_exec = (
        _any(state.exec_at_common & state.exec_moving)
        | _any(state.exec_moving & ~torch.isfinite(state.exec_arrive_time))
        | _any(state.exec_executing & ~state.exec_task_valid)
        | _any(state.exec_executing & ~torch.isfinite(state.exec_finish_time))
    )
    bad_tasks = (
        _any(state.stage_completed_tasks > state.stage_num_tasks)
        | _any(state.stage_remaining < 0)
        | _any(state.stage_executing < 0)
    )
    if prev is not None:
        decreased = _any(
            state.stage_completed_tasks < prev.stage_completed_tasks
        ) | (state.num_jobs < prev.num_jobs)
        if resetting is not None:
            decreased = decreased & ~resetting
        bad_tasks = bad_tasks | decreased
    return (
        _bit(bad_time, H_NONFINITE_TIME)
        | _bit(bad_commit, H_COMMIT_CONSERVE)
        | _bit(bad_exec, H_EXEC_CONSERVE)
        | _bit(bad_tasks, H_TASK_MONOTONIC)
    )


def reward_health(reward: torch.Tensor) -> torch.Tensor:
    """i32 bitmask (same shape as `reward`)."""
    return _bit(~torch.isfinite(reward), H_NONFINITE_REWARD)


def tree_nonfinite(tensors) -> torch.Tensor:
    """bool []: any floating tensor of `tensors` (an iterable, or a dict's
    values) holds a non-finite value; other dtypes are skipped."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    flags = [~torch.isfinite(t).all() for t in tensors
             if t is not None and t.is_floating_point()]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any().cpu()


def grad_health(loss: torch.Tensor | None = None, grads=None, params=None
                ) -> torch.Tensor:
    """i32 [] bitmask over the update-side quantities; every argument
    optional (None contributes nothing). `grads` and `params` are
    iterables of tensors or dicts of them."""
    mask = torch.tensor(0, dtype=torch.int32)
    if loss is not None:
        mask = mask | _bit(~torch.isfinite(loss.detach().cpu()),
                           H_NONFINITE_LOSS)
    if grads is not None:
        mask = mask | _bit(tree_nonfinite(grads), H_NONFINITE_GRAD)
    if params is not None:
        mask = mask | _bit(tree_nonfinite(params), H_NONFINITE_PARAM)
    return mask
