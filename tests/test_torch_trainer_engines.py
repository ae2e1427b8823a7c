"""The port trainer's collection engines.

- `make_trainer(config/test.yaml, device="cpu")` builds with the JAX
  trainer's engine settings: the `core` engine (the config sets no
  `rollout_engine`), no per-lane micro-step budget in use, sync mode.
- One PPO iteration of `config/test.yaml` (50 executors, 10 job slots,
  2 lanes, Decima 16 / [32, 16] / [64, 64], PPO 3 x 10; `rollout_steps`
  cut from 480 to 48 for time) against the JAX trainer's, from the same
  carried weights (x0.3): every rollout leaf as
  `tests/_torch_parity.py:rollout_mismatches` holds it — the wall times
  within rtol 1e-6 (the reset's float32 `log1p` ulp carries into them)
  and the rewards within 1e-5 (under `beta_discount` a reward is a
  difference of two float32 exponentials, and torch's and XLA's `exp`
  may part in the last ulp) — and the counters bit-equal. The update
  runs at `test_torch_trainer.py`'s linear Adam (lr 3e-2, eps 1e-2 in
  place of the config's lr 3e-4, eps 1e-8; the collection does not read
  them): there each parameter's change is held to the JAX change within
  rtol 1e-4 / atol 1e-7 per applied step, the policy heads per tensor
  (`assert_update_close(heads_per_tensor=True)`) and each head's
  one-element output bias against the largest change in its head: that
  bias's exact gradient is 0 (log-softmax ignores a shift of all
  scores), a sum over every node and executor row that cancels to
  float32 noise, larger at 50 executors than in `test_torch_trainer.py`.
  At eps 1e-8 an element whose
  gradient sits at rounding level steps along float32 noise over the
  iteration's 30 minibatches, in either package.
- Every engine setting the JAX trainer accepts trains here: `core` or
  `flat`, `flat_single_eval` true or false, `rollout_duration` set or
  not (the small config, 1 iteration, health on); asynchronous runs keep
  their lanes (`_env_states`) and their reset ordinals.
- An asynchronous run whose second iteration's first attempt is poisoned
  (`chaos: nan_grad`) retries from the carry the first iteration left,
  not from the poisoned attempt's.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import yaml

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.env import flat_loop as tfl
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import (
    LINEAR_ADAM,
    POLICY_HEADS,
    assert_update_close,
    jax_telemetry_array,
    mini_train_cfg,
    rollout_mismatches,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

TEST_T = 48


def _test_cfg(tmp_path, **trainer) -> dict:
    with open("config/test.yaml") as fp:
        cfg = yaml.safe_load(fp)
    cfg["trainer"].update(artifacts_dir=str(tmp_path), **trainer)
    return cfg


def test_test_config_builds_with_the_jax_engine_settings(tmp_path):
    cfg = _test_cfg(tmp_path)
    tt = make_trainer(cfg, device="cpu")
    jt = jax_make_trainer(cfg)
    assert tt.rollout_engine == jt.rollout_engine == "core"
    assert tt.rollout_duration is jt.rollout_duration is None
    assert tt.flat_single_eval == jt.flat_single_eval
    assert tt.flat_knobs == jt.flat_knobs
    assert tt.flat_batch_knobs == jt.flat_batch_knobs
    assert tt.flat_micro_groups == jt.flat_micro_groups
    assert tt.rollout_steps == jt.rollout_steps == 480
    lane = _test_cfg(tmp_path, rollout_engine="flat", flat_single_eval=False,
                     flat_event_burst=4)
    tl, jl = make_trainer(lane, device="cpu"), jax_make_trainer(lane)
    assert tl.flat_knobs == jl.flat_knobs and not tl.flat_knobs[
        "fulfill_bulk"]
    assert tl.flat_micro_groups == jl.flat_micro_groups == 480


def test_one_iteration_of_the_test_config_matches_jax(tmp_path):
    cfg = _test_cfg(tmp_path, rollout_steps=TEST_T, opt_kwargs=LINEAR_ADAM)
    jt = jax_make_trainer(cfg)
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    carried = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.scheduler.params))
    st = jt.init_state()
    st = st.replace(rng=jax.random.fold_in(jax.random.PRNGKey(42), 0))
    jro, _, jtm = jt._collect_jit(st.params, st.iteration, st.rng, None)
    st, _ = jt._update_jit(st, jro)

    tt = make_trainer(cfg, device="cpu")
    tt.scheduler.load_params(carried)
    p0 = {k: torch.as_tensor(v) for k, v in carried.items()}
    seen = []
    collect = tt._collect

    def keep(iteration, rng, counts=None):
        out = collect(iteration, rng, counts)
        seen.append(counts["telemetry"].t.numpy())
        return out

    tt._collect = keep
    stats = []
    tt.train(callback=lambda i, state, s: stats.append(
        ({k: v.detach().clone() for k, v in state.params.items()}, s)))
    bad = rollout_mismatches(jro, tt.last_rollout, reward_rtol=1e-5,
                             wall_rtol=1e-6, actions_where_valid=True)
    assert not bad, bad
    assert np.array_equal(jax_telemetry_array(jtm), seen[0])
    (params, s), = stats
    assert s["decisions"] == np.asarray(jro.valid).sum() > 2 * 20
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, st.params))
    steps = int(s["minibatches_applied"])
    # a head's one-element output bias: its change against the head's
    outs = {k for k, v in params.items()
            if k.startswith(POLICY_HEADS) and v.numel() == 1}
    assert len(outs) == 2
    for k in outs:
        head = k.split(".")[0]
        scale = max(float((torch.as_tensor(np.asarray(want[h]))
                           - p0[h]).abs().max())
                    for h in want if h.startswith(head + "."))
        err = abs(float(params[k] - torch.as_tensor(np.asarray(want[k]))))
        assert err <= 1e-7 * steps + 1e-4 * scale, k
    assert_update_close({k: v for k, v in want.items() if k not in outs},
                        {k: v for k, v in params.items() if k not in outs},
                        p0, steps, cfg["trainer"]["opt_kwargs"]["lr"],
                        linear=True, heads_per_tensor=True)


ENGINES = [
    ("core", True, None), ("core", True, 2e6),
    ("flat", True, None), ("flat", True, 2e6),
    ("flat", False, None), ("flat", False, 2e6),
]


@pytest.mark.parametrize("engine,single,duration", ENGINES)
def test_every_engine_setting_trains(engine, single, duration, tmp_path):
    cfg = mini_train_cfg(
        num_iterations=2, rollout_steps=12, rollout_engine=engine,
        flat_single_eval=single, flat_event_burst=2,
        rollout_duration=duration, artifacts_dir=str(tmp_path))
    tt = make_trainer(cfg, device="cpu")
    p0 = {k: v.detach().clone() for k, v in tt.scheduler.params.items()}
    tt.train()
    assert [s["health_mask"] for s in tt.stats_log] == [0.0, 0.0]
    assert all(s["decisions"] > 0 for s in tt.stats_log)
    assert any(not torch.equal(p0[k], v)
               for k, v in tt.scheduler.params.items())
    if duration is None:
        assert tt._env_states is None
        return
    carry, rc = tt._env_states
    assert isinstance(carry, tfl.LoopState if engine == "flat" else
                      type(tt.last_rollout.final_state))
    # the first reset was ordinal 0; each later one counts from 1
    assert (rc >= 1).all() and rc.shape == (4,)


def _leaves(x) -> list[torch.Tensor]:
    if isinstance(x, tfl.LoopState):
        return [v.clone() for _, v in tfl.leaves(x)]
    return [getattr(x, f.name).clone() for f in dataclasses.fields(x)]


def test_async_retry_restarts_from_the_iteration_carry(tmp_path):
    cfg = mini_train_cfg(num_iterations=2, rollout_steps=12,
                         rollout_duration=2e6, artifacts_dir=str(tmp_path))
    cfg["health"] = {"enabled": True, "backoff_seconds": 0.0,
                     "max_retries": 2}
    cfg["chaos"] = {"nan_grad": [1]}
    tt = make_trainer(cfg, device="cpu")
    calls = []
    collect = tt._collect

    def keep(iteration, rng, counts=None):
        given = tt._env_states
        calls.append((iteration, None if given is None else (
            _leaves(given[0]), given[1].clone())))
        out = collect(iteration, rng, counts)
        calls[-1] += (_leaves(counts["env_states"][0]),)
        return out

    tt._collect = keep
    tt.train()
    assert [c[0] for c in calls] == [0, 1, 1]
    assert calls[0][1] is None
    (_, (first, rc1), _), (_, (retry, rc2), _) = calls[1], calls[2]
    for a, b, c in zip(first, retry, calls[0][2]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(rc1, rc2)
    assert tt.stats_log[-1]["health_retries"] == 1.0
    assert tt.stats_log[-1]["health_mask"] == 0.0
