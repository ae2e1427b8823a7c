"""`python -m sparksched_tpu_torch.evaluate` against the JAX flat collector
at trained weights.

`models/decima/model_tpu.msgpack`, greedy, and the fair heuristic on the
first 2 held-out seeds of `scripts_eval_decima.py` (base 10,000) at the
script's env, with the decision cap cut from 600 to 120 to fit the time
(the full 24-seed table is a chip run, not a tier-1 test): every recorded
action, the valid mask and the final state's avg JCT equal the JAX
`collect_flat_sync_batch` driven by `DecimaScheduler(state_dict_path=)
.batch_policy(..., deterministic=True)` (and by the vmapped fair policy)
on the same reset lanes and key — the first comparison at trained
weights. The avg JCTs are float32 sums over jobs, held within rtol 1e-6.
The entry point runs on the CPU with `--device cpu`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sparksched_tpu import metrics as jmetrics
from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.env import core as jcore
from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.schedulers import RoundRobinScheduler as JaxFair
from sparksched_tpu.trainers import rollout as jro
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch import evaluate as ev
from sparksched_tpu_torch import metrics

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

STEPS = 120


def test_trained_model_matches_jax_flat_collector():
    seeds = [ev.HELD_OUT_BASE, ev.HELD_OUT_BASE + 1]
    res = ev.evaluate(seeds=seeds, steps=STEPS, device="cpu")
    jp = JaxParams(**ev.ENV)
    jb = jax_bank(jp.num_executors, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    jd = JaxDecima(num_executors=jp.num_executors, state_dict_path=ev.MODEL,
                   **ev.AGENT)
    fair = JaxFair(jp.num_executors, dynamic_partition=True)
    states = jax.vmap(lambda s: jcore.reset(jp, jb, jax.random.PRNGKey(s)))(
        jnp.asarray(seeds))
    key = jax.random.PRNGKey(ev.HELD_OUT_BASE)
    policies = {
        "fair": lambda k, o: jax.vmap(lambda oo: fair.policy(k, oo))(o),
        "decima": lambda k, o: jd.batch_policy(k, o, deterministic=True),
    }
    for name, pol in policies.items():
        jout = jro.collect_flat_sync_batch(jp, jb, pol, key, STEPS, states)
        ro = res["rollouts"][name]
        valid = np.asarray(jout.valid)
        assert np.array_equal(valid, ro.valid.numpy()), name
        assert valid.sum() > 100
        for f in ("stage_idx", "job_idx", "num_exec_k"):
            assert np.array_equal(np.asarray(getattr(jout, f))[valid],
                                  getattr(ro, f).numpy()[valid]), (name, f)
        want = np.asarray(jax.vmap(jmetrics.avg_job_duration)(
            jout.final_state))
        got = metrics.avg_job_duration(ro.final_state).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(res[name]["avg_jct_s"], want * 1e-3,
                                   rtol=1e-6)
    assert res["decima"]["mean_avg_jct_s"] < res["fair"]["mean_avg_jct_s"]
    assert res["decima"]["near_ties"] >= res["decima"]["exact_ties"] > 0


def test_cli_runs_on_cpu(capsys, tmp_path):
    out = tmp_path / "eval.json"
    res = ev.main(["--device", "cpu", "--seeds", "1", "--steps", "8",
                   "--out", str(out)])
    text = capsys.readouterr().out
    assert "mean avg JCT" in text and out.exists()
    assert res["seeds"] == [ev.HELD_OUT_BASE]
    assert res["fair"]["decisions"] == 8
