"""The port trainer's checkpoints, train states and resume against the
JAX `Trainer`'s (`tests/test_health.py::test_torn_checkpoint_write_falls_
back_to_previous_generation`, `::test_resume_after_sigkill_is_step_
exact`, `tests/test_trainers.py::test_ppo_trains_and_checkpoints`).

- A run stopped after its first iteration (the health block's
  `checkpoint_every: 1` write is all it leaves) and resumed for one more
  equals an uninterrupted 2-iteration run bit for bit: parameters, Adam's
  moments and steps, the schedule's count, the differential-returns
  window, the rng and the iteration (the train state's bytes). The config
  is `mini_train_cfg` with differential returns and `lr_anneal`, so that
  every part of the state matters.
- Keep-K rotation: `path.1` holds the previous generation; a torn newest
  generation falls back to it (a runlog `recovery` record); a save after
  that never rotates the torn file over the intact one; with every
  generation torn the load raises. A train state stamped with another
  `prng_impl` raises at once, naming the `fast_prng` value to set.
- Over the 2-iteration trainer comparison of `test_torch_trainer.py`
  (weights x0.3, `checkpointing_freq: 2`): the port's best model —
  iteration, avg_num_jobs (to its 3 decimals), completed jobs, parameters
  — equals the JAX `Trainer`'s `checkpoints/2/`, the parameters as the
  trainer test holds them; the port's `model.msgpack` loads into the JAX
  `DecimaScheduler(state_dict_path=)` and gives the port's greedy actions
  and log-probs on the rollout's recorded observations.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.env.observe import Observation as JaxObservation
from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax
from sparksched_tpu_torch.serialization import from_bytes, to_bytes
from sparksched_tpu_torch.trainers import make_trainer
from sparksched_tpu_torch.trainers.rollout import stored_to_observation

from ._torch_parity import (
    MINI_AGENT,
    assert_update_close,
    mini_train_cfg,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


class _Stop(Exception):
    pass


def _resume_cfg(art, iterations: int) -> dict:
    cfg = mini_train_cfg(num_iterations=iterations, artifacts_dir=str(art),
                         lr_anneal={"final": 1.0e-4, "steps": 4},
                         reward_buff_cap=500)
    del cfg["trainer"]["beta_discount"]
    cfg["health"] = {"enabled": True, "checkpoint_every": 1, "keep": 2}
    return cfg


def test_stop_and_resume_equals_uninterrupted(tmp_path):
    full_t = make_trainer(_resume_cfg(tmp_path / "full", 2), device="cpu")
    full = full_t.train()

    def stop_after_first(i, state, stats):
        if i == 0:
            raise _Stop  # the process dies between iterations

    stopped = make_trainer(_resume_cfg(tmp_path / "stop", 2), device="cpu")
    with pytest.raises(_Stop):
        stopped.train(callback=stop_after_first)
    ckpt = tmp_path / "stop" / "train_state.msgpack"
    meta = json.loads((tmp_path / "stop" /
                       "train_state.msgpack.meta.json").read_text())
    assert meta["iteration"] == 1 and meta["prng_impl"] == "threefry2x32"
    resumer = make_trainer(_resume_cfg(tmp_path / "stop", 1), device="cpu")
    resumed = resumer.train(resume_from=str(ckpt))
    assert resumed.iteration == full.iteration == 2
    for k, v in full.params.items():
        assert torch.equal(v, resumed.params[k]), k
    assert resumed.opt_state.count == full.opt_state.count > 0
    assert resumed.buf is not None and int(resumed.buf.ptr) > 0
    assert (to_bytes(resumer.train_state_tree(resumed))
            == to_bytes(full_t.train_state_tree(full)))
    # the resumed run's own final write is the same state
    assert ((tmp_path / "stop" / "train_state.msgpack").read_bytes()
            == (tmp_path / "full" / "train_state.msgpack").read_bytes())


def test_keep_k_rotation_and_torn_write_fallback(tmp_path):
    cfg = mini_train_cfg(artifacts_dir=str(tmp_path / "art"))
    cfg["obs"] = {"runlog": str(tmp_path / "run.jsonl"), "memory": False}
    t = make_trainer(cfg, device="cpu")
    t._setup()
    path = str(tmp_path / "state.msgpack")
    s1 = t.init_state()
    p1 = {k: v.detach().clone() for k, v in s1.params.items()}
    t.save_train_state(s1, path)
    with torch.no_grad():
        for v in s1.params.values():
            v.add_(1.0)
    s1.iteration = 1
    t.save_train_state(s1, path)  # rotates the first write to path.1
    assert os.path.exists(path + ".1")
    assert os.path.exists(path + ".1.meta.json")
    assert t.load_train_state(path).iteration == 1
    # torn write: the digest check rejects it, the previous generation
    # loads
    data = open(path, "rb").read()
    with open(path, "wb") as fp:
        fp.write(data[: len(data) // 2])
    restored = t.load_train_state(path)
    assert restored.iteration == 0
    for k, v in restored.params.items():
        assert torch.equal(v, p1[k]), k
    # a save after the torn write drops it instead of rotating it over
    # the intact previous generation
    restored.iteration = 2
    t.save_train_state(restored, path)
    assert t.load_train_state(path).iteration == 2
    assert t.load_train_state(path + ".1").iteration == 0
    for p in (path, path + ".1"):
        with open(p, "wb") as fp:
            fp.write(b"junk")
    with pytest.raises(ValueError, match="no intact generation"):
        t.load_train_state(path)
    t._runlog.close()
    recs = [json.loads(x) for x in open(tmp_path / "run.jsonl")]
    fb = [r for r in recs if r["ev"] == "recovery"]
    assert fb and fb[0]["action"] == "checkpoint_fallback"
    assert fb[0]["loaded"] == path + ".1"


def test_prng_impl_mismatch_raises(tmp_path):
    t = make_trainer(mini_train_cfg(artifacts_dir=str(tmp_path)),
                     device="cpu")
    path = str(tmp_path / "state.msgpack")
    t.save_train_state(t.init_state(), path)
    meta = json.loads(open(path + ".meta.json").read())
    meta["prng_impl"] = "rbg"
    with open(path + ".meta.json", "w") as fp:
        json.dump(meta, fp)
    with pytest.raises(ValueError,
                       match="PRNG impl 'rbg'.*set `fast_prng: True`"):
        t.load_train_state(path)


def test_best_model_matches_jax_trainer(tmp_path):
    def cfg_at(art):
        return mini_train_cfg(artifacts_dir=str(art), checkpointing_freq=2)

    jt = jax_make_trainer(cfg_at(tmp_path / "jax"))
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    carried = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.scheduler.params))
    jt.train()
    tt = make_trainer(cfg_at(tmp_path / "port"), device="cpu")
    tt.scheduler.load_params(carried)
    applied = []
    tt.train(callback=lambda i, s, st: applied.append(
        int(st["minibatches_applied"])))

    jdir, tdir = (tmp_path / "jax" / "checkpoints" / "2",
                  tmp_path / "port" / "checkpoints" / "2")
    jmeta = json.loads((jdir / "state.json").read_text())
    tmeta = json.loads((tdir / "state.json").read_text())
    assert list(tmeta) == list(jmeta)
    assert tmeta["iteration"] == jmeta["iteration"]
    assert tmeta["completed_job_count"] == jmeta["completed_job_count"]
    assert abs(tmeta["avg_num_jobs"] - jmeta["avg_num_jobs"]) <= 1e-3
    want = params_from_flax(from_bytes((jdir / "model.msgpack").read_bytes()))
    got = params_from_flax(from_bytes((tdir / "model.msgpack").read_bytes()))
    steps = sum(applied[:tmeta["iteration"]])
    if steps:
        assert_update_close(want, got, carried, steps,
                            cfg_at(tmp_path)["trainer"]["opt_kwargs"]["lr"],
                            linear=False)
    else:  # the carried weights themselves, on both sides
        for k, v in got.items():
            assert torch.equal(v, carried[k]) and torch.equal(want[k], v), k

    # the port's model file in the JAX scheduler: the port's choices
    path = str(tdir / "model.msgpack")
    nexec = tt.params_env.num_executors
    js = JaxDecima(num_executors=nexec, state_dict_path=path, **MINI_AGENT)
    ts = DecimaScheduler(nexec, state_dict_path=path, device="cpu",
                         **MINI_AGENT)
    ro = tt.last_rollout
    so = ro.obs.map(lambda a: a[ro.valid][:32])
    to = stored_to_observation(tt.bank, so)
    jo = JaxObservation(**{k: jnp.asarray(v.numpy())
                           for k, v in vars(to).items()})
    tsi, tne, taux = ts.batch_policy(None, to, deterministic=True)
    jsi, jne, jaux = js.batch_policy(jax.random.PRNGKey(0), jo,
                                     deterministic=True)
    assert np.array_equal(np.asarray(jsi), tsi.numpy())
    assert np.array_equal(np.asarray(jne), tne.numpy())
    np.testing.assert_allclose(taux["lgprob"].numpy(),
                               np.asarray(jaux["lgprob"]), rtol=1e-5,
                               atol=1e-6)
