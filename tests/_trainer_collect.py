"""The port trainer's `_collect` against the JAX trainer's `_collect_jit`
over two iterations, for `tests/test_torch_trainer_collect_*.py`."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.env import flat_loop as tfl
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import (
    jax_impl,
    jax_leaves,
    jax_telemetry_array,
    mini_train_cfg,
    mismatched_leaves,
    port_leaves,
    rollout_mismatches,
    to_port_key,
)

# T rows a collection; a short mean time limit, so that asynchronous
# lanes restart inside both iterations; the asynchronous budget
TRAINER_T, TIME_LIMIT, DURATION = 24, 3.0e5, 2.0e6


def trainer_collections(engine: str, single: bool, duration, impl: str,
                        art: str) -> list[tuple]:
    """Both trainers of `mini_train_cfg` at the engine setting (the JAX
    init's weights x0.3 carried to the port), `_collect` of iterations
    0 and 1 under the keys `Trainer.train` gives them, each
    asynchronous iteration from the carry the one before returned on
    its own side. Per iteration: (JAX rollout, JAX carry, JAX counters,
    port rollout, port health mask, port counts)."""
    cfg = mini_train_cfg(rollout_steps=TRAINER_T, rollout_engine=engine,
                         flat_single_eval=single, flat_event_burst=2,
                         rollout_duration=duration, artifacts_dir=art,
                         fast_prng=impl == "rbg")
    cfg["env"]["mean_time_limit"] = TIME_LIMIT
    # the JAX trainer sets jax's process-wide impl under fast_prng
    with (jax_impl(impl) if impl == "rbg" else contextlib.nullcontext()):
        jt = jax_make_trainer(cfg)
        assert jax.config.jax_default_prng_impl == impl
        jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                     jt.scheduler.params)
        tt = make_trainer(cfg, device="cpu")
        assert tt.prng_impl == impl
        tt.scheduler.load_params(params_from_flax(jax.tree_util.tree_map(
            np.asarray, jt.scheduler.params)))
        out, jcarry = [], None
        for i in range(2):
            key = jax.random.fold_in(jax.random.PRNGKey(42), i)
            jro, jcarry, jtm = jt._collect_jit(jt.scheduler.params,
                                               jnp.int32(i), key, jcarry)
            counts: dict = {}
            tro, hm = tt._collect(i, to_port_key(key), counts)
            tt._env_states = counts.get("env_states")
            out.append((jro, jcarry, jax_telemetry_array(jtm), tro, hm,
                        counts))
    return out


def assert_collections_match(engine: str, duration, collections) -> None:
    """Every rollout leaf as `rollout_mismatches` holds it (the wall
    times within rtol 1e-6: the episodes' arrival times come from the
    reset's float32 `log1p`, where torch and XLA may part in the last
    ulp, as `test_torch_trainer_engines.py` holds `config/test.yaml`'s;
    `job_idx` /
    `num_exec_k` of the core engine on the valid steps), the counters
    and the health mask bit-equal, and the asynchronous carry: the
    flat engines' LoopState leaf by leaf (floats within 1e-6), core's
    EnvState (the rollout's final state) and the reset ordinals. An
    asynchronous run must reset some lane, and its first reset ordinal
    is the iteration's + 1."""
    resets = 0
    for i, (jro, jcarry, jtm, tro, hm, counts) in enumerate(collections):
        bad = rollout_mismatches(jro, tro,
                                 wall_rtol=1e-6,
                                 actions_where_valid=engine == "core")
        assert not bad, (i, bad)
        assert tro.valid.sum() > 0
        assert np.array_equal(jtm, counts["telemetry"].t.numpy()), i
        assert np.array_equal(jtm[:, -1], hm.numpy()) and not hm.any()
        if duration is None:
            assert jcarry is None and "env_states" not in counts
            continue
        carry, rc = counts["env_states"]
        assert np.array_equal(np.asarray(jcarry[1]), rc.numpy())
        if engine == "flat":
            assert isinstance(carry, tfl.LoopState)
            assert not mismatched_leaves(jax_leaves(jcarry[0]),
                                         port_leaves(carry, None), 1e-6), i
        else:
            assert carry is tro.final_state
        resets += int(tro.resets.sum())
        if i == 0:  # the first reset used ordinal 0; the next counts 1
            assert (rc.numpy() == 1 + tro.resets.sum(1).numpy()).all()
    assert resets > 0 or duration is None
