"""The port's trainer against the JAX package's, and its entry point.

- Slice level: a port `Trainer` and a JAX `Trainer` built from the same
  config (`mini_train_cfg`: the flagship's PPO, Adam and engine
  settings at 5 executors, 6 job slots, 4 lanes, T = 48) with the same
  carried weights (x0.3). The JAX side runs its jitted `_collect` and
  `_update` per iteration with the keys its `train()` derives; the port
  runs `train()`. After each of 2 iterations the parameters agree
  within rtol 1e-4 / atol 1e-6 but the policy heads, held to Adam's
  step bound (`assert_update_close`, see `test_torch_ppo.py`), and the
  iteration's episode lengths and valid decisions are equal. The same
  again at the linear Adam (eps 1e-2, lr 3e-2), where every parameter's
  change, the heads' too, is held to the JAX change within rtol 1e-4 /
  atol 1e-7 per applied step.
- `python -m sparksched_tpu_torch.train -f <config> --device cpu` trains
  on the CPU; without `--device` it asks for the card and raises where
  there is none.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import yaml

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch import train as train_cli
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import LINEAR_ADAM, assert_update_close, mini_train_cfg
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _two_iterations(cfg: dict, linear: bool, art) -> None:
    jt = jax_make_trainer(cfg)
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    carried = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.scheduler.params))
    jst = jt.init_state()
    jax_iters = []
    for i in range(2):  # Trainer.train's loop, health clean
        st = jst.replace(rng=jax.random.fold_in(jax.random.PRNGKey(42), i))
        ro, _, tm = jt._collect_jit(st.params, st.iteration, st.rng, None)
        st, stats = jt._update_jit(st, ro)
        assert int(np.bitwise_or.reduce(np.asarray(tm.health_mask))) == 0
        jst = st.replace(iteration=st.iteration + 1)
        jax_iters.append((jst.params, np.asarray(ro.valid).sum(-1)))

    cfg["trainer"]["artifacts_dir"] = str(art)
    tt = make_trainer(cfg, device="cpu")
    tt.scheduler.load_params(carried)
    p0 = {k: torch.as_tensor(v) for k, v in carried.items()}
    port_iters = []
    tt.train(callback=lambda i, state, stats: port_iters.append(
        ({k: v.detach().clone() for k, v in state.params.items()}, stats)))
    assert len(port_iters) == 2
    steps = 0
    lr = cfg["trainer"]["opt_kwargs"]["lr"]
    for (jp, jvalid), (tp, stats) in zip(jax_iters, port_iters):
        assert stats["health_mask"] == 0
        assert stats["decisions"] == jvalid.sum()
        assert stats["episode_length"] == pytest.approx(jvalid.mean())
        steps += int(stats["minibatches_applied"])
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
        assert_update_close(want, tp, p0, steps, lr, linear=linear)


def test_two_iterations_match_jax_trainer(tmp_path):
    _two_iterations(mini_train_cfg(), linear=False, art=tmp_path)


def test_two_iterations_match_jax_trainer_linear_adam(tmp_path):
    """The same at the linear Adam, where every parameter's change, the
    policy heads' too, is held to the reference's change."""
    _two_iterations(mini_train_cfg(opt_kwargs=LINEAR_ADAM), linear=True,
                    art=tmp_path)


def test_cli_trains_on_cpu_and_asks_for_the_card(tmp_path, capsys):
    cfg = mini_train_cfg(num_iterations=1, rollout_steps=12,
                         num_sequences=1, artifacts_dir=str(tmp_path / "art"))
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_cli.main(["-f", str(path), "--device", "cpu"])
    assert "Iteration 1 complete" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["-f", str(path)])


def test_health_retry_rolls_back_and_reseeds(monkeypatch, tmp_path):
    """A rollout whose health mask trips a retryable bit: the iteration
    is rolled back to the state before it (parameters and Adam), run
    again on `fold_in(fold_in(PRNGKey(seed), i), 90_000 + attempt)`
    after the backoff, and kept once healthy."""
    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.env.health import H_NONFINITE_REWARD

    cfg = mini_train_cfg(num_iterations=1, rollout_steps=12,
                         num_sequences=1, artifacts_dir=str(tmp_path))
    cfg["health"] = {"enabled": True, "backoff_seconds": 0.0,
                     "max_retries": 2}
    tt = make_trainer(cfg, device="cpu")
    seen = []
    collect = tt._collect

    def poisoned_once(iteration, rng, counts=None):
        seen.append((rng.clone(), {k: v.detach().clone() for k, v in
                                   tt.scheduler.net.named_parameters()},
                     tt_state["opt"].count if tt_state else None))
        ro, hm = collect(iteration, rng, counts)
        if len(seen) == 1:
            hm = hm | H_NONFINITE_REWARD
        return ro, hm

    tt_state = {}
    init = tt.init_state

    def init_state():
        st = init()
        tt_state["opt"] = st.opt_state
        return st

    monkeypatch.setattr(tt, "_collect", poisoned_once)
    monkeypatch.setattr(tt, "init_state", init_state)
    tt.train()
    assert len(seen) == 2
    rng0 = prng.fold_in(prng.PRNGKey(42), 0)
    assert torch.equal(seen[0][0], rng0)
    assert torch.equal(seen[1][0], prng.fold_in(rng0, 90_001))
    for k, v in seen[0][1].items():  # rolled back before the retry
        assert torch.equal(seen[1][1][k], v), k
    assert seen[1][2] == 0
    assert tt.stats_log[-1]["health_retries"] == 1.0
    assert tt.stats_log[-1]["health_mask"] == 0.0
