"""The port's `chaos:` block and out-of-memory retry against the JAX
package's (`sparksched_tpu/chaos.py`, `scripts_chaos_drill.py`).

- `ChaosMonkey` hits the same (lane, step, job) of a rollout for
  `nan_grad` / `bank_row` (float32 and bfloat16 duration buffers) and
  the same lane for `straggler` as the JAX package's for the same shapes,
  seed and iteration, only on attempt 0; `oom` raises
  `torch.OutOfMemoryError` on attempt 0 only; `corrupt_bank` poisons the
  same entries and refuses an int-coded bank.
- A run of the drill's trainer config (5 executors, 3 job slots, 2
  lanes, T = 30, the flat single-eval engine) with `nan_grad`,
  `bank_row`, `straggler` and `oom` scheduled at iterations 1-4 writes
  the same `chaos`, `health` and `recovery` records as the JAX trainer
  under the same config (kind, action, bits, injected faults, iteration,
  attempt), finishes every iteration and leaves finite parameters: the
  drill's detection and recovery assertions, held against the JAX run.

`test_torch_chaos_recovery.py` holds the out-of-memory retry and the
sigkill resume.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from sparksched_tpu import chaos as jchaos
from sparksched_tpu.obs.telemetry import telemetry_zeros_like
from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch import chaos
from sparksched_tpu_torch.obs.telemetry import telemetry_zeros
from sparksched_tpu_torch.trainers import make_trainer
from sparksched_tpu_torch.workload import make_workload_bank, quantize_bank

from ._torch_parity import drill_cfg as _drill_cfg
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from ._torch_parity import runlog_records as _records

@struct.dataclass
class _JObs:
    duration: jnp.ndarray


@struct.dataclass
class _JRo:
    reward: jnp.ndarray
    obs: _JObs


@dataclasses.dataclass
class _TObs:
    duration: torch.Tensor


@dataclasses.dataclass
class _TRo:
    reward: torch.Tensor
    obs: _TObs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,iteration", [(0, 0), (7, 1), (3, 5),
                                            (11, 12)])
def test_injected_indices_match_jax(dtype, seed, iteration):
    B, T, J, S = 4, 9, 6, 5
    cfg = {"seed": seed, "nan_grad": [iteration], "bank_row": [iteration],
           "straggler": [iteration], "oom": [iteration]}
    jm, tm = jchaos.ChaosMonkey(cfg), chaos.ChaosMonkey(cfg)
    jro = _JRo(jnp.zeros((B, T)), _JObs(jnp.zeros((B, T, J, S),
                                                   getattr(jnp, dtype))))
    tro = _TRo(torch.zeros(B, T), _TObs(torch.zeros(
        B, T, J, S, dtype=getattr(torch, dtype))))
    jout, jinj = jm.poison_rollout(jro, iteration, 0)
    tout, tinj = tm.poison_rollout(tro, iteration, 0)
    assert jinj == tinj == ["nan_grad", "bank_row"]
    assert np.array_equal(np.isnan(np.asarray(jout.reward)),
                          tout.reward.isnan().numpy())
    jd = np.isnan(np.asarray(jout.obs.duration, np.float32))
    assert tout.obs.duration.dtype == getattr(torch, dtype)
    assert np.array_equal(jd, tout.obs.duration.float().isnan().numpy())
    assert jd.sum() == S and not tro.reward.isnan().any()  # a copy
    assert tm.poison_rollout(tro, iteration, 1)[1] == []
    assert tm.poison_rollout(tro, iteration + 1, 0)[1] == []
    jt, jinj = jm.inflate_straggler(telemetry_zeros_like((B,)), iteration, 0)
    tt, tinj = tm.inflate_straggler(telemetry_zeros(B), iteration, 0)
    assert jinj == tinj == ["straggler"]
    assert np.array_equal(np.asarray(jt.loop_iters),
                          tt.loop_iters.numpy())
    assert int(tt.loop_iters.max()) == 100
    with pytest.raises(torch.OutOfMemoryError, match="chaos"):
        tm.maybe_raise_oom(iteration, 0)
    tm.maybe_raise_oom(iteration, 1)
    tm.maybe_raise_oom(iteration + 1, 0)


def test_corrupt_bank_matches_jax():
    jb, tb = jax_bank(5, 20), make_workload_bank(5, 20, device="cpu")
    jc, tc = jchaos.corrupt_bank(jb), chaos.corrupt_bank(tb)
    assert np.array_equal(np.isnan(np.asarray(jc.dur)),
                          tc.dur.isnan().numpy())
    assert not tb.dur.isnan().any()
    with pytest.raises(ValueError, match="quantized"):
        chaos.corrupt_bank(quantize_bank(tb, "int16"))


def _fault_records(art) -> list[tuple]:
    return [(r["ev"], r.get("action"), r.get("bits"), r.get("injected"),
             r.get("iteration"), r.get("attempt"))
            for r in _records(art) if r["ev"] in ("chaos", "health",
                                                   "recovery")]


# seed 3 (the drill's bank_row seed) puts the bank_row NaN on a live node
FAULTS = {"nan_grad": [1], "bank_row": [2], "straggler": [3], "oom": [4],
          "seed": 3}


def test_fault_records_match_jax_trainer(tmp_path):
    health = {"straggler_ratio_max": 1.9}
    jt = jax_make_trainer(_drill_cfg(tmp_path / "jax", 5, health, FAULTS))
    jt.train()
    tt = make_trainer(_drill_cfg(tmp_path / "port", 5, health, FAULTS),
                      device="cpu")
    state = tt.train()
    want = _fault_records(tmp_path / "jax")
    got = _fault_records(tmp_path / "port")
    assert got == want
    kinds = {(ev, act) for ev, act, *_ in got}
    assert kinds == {("chaos", None), ("health", "rollback_retry"),
                     ("recovery", "rollback_retry"),
                     ("health", "quarantine")}
    oom = [r for r in _records(tmp_path / "port") if r["ev"] == "health"
           and "oom" in r["bits"]]
    assert oom and "simulated chaos OOM" in oom[0]["detail"]
    assert state.iteration == 5
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert [s["health_retries"] for s in tt.stats_log] == [0, 1, 1, 0, 1]
