"""The port's run log (`sparksched_tpu_torch/obs/runlog.py`) and the
trainer's `obs:` block against the JAX package's.

- A 2-iteration run of each trainer (`mini_train_cfg`, weights x0.3, the
  run log on, telemetry on) writes the same sequence of record kinds —
  apart from the JAX package's JIT-compile records, which an eager port
  has no counterpart of, and `memory`, which each package writes only
  where its device reports allocator stats — with the same keys in each
  record; the `scalars` values agree within rtol 1e-4 / atol 1e-6 (the
  trainer test's parameter tolerance; wall-clock seconds excepted), the
  `telemetry` summaries are equal.
- The run log's size cap rotates the file into numbered segments, each a
  complete JSONL file, and `run_end` stays the active file's last record.
- The flagship config no longer names its checkpoint, health and `obs:`
  keys, or `fast_prng` (its run is an rbg run), as ignored; nor
  `use_tensorboard` and `obs.trace_iteration` when set (they are
  honoured: `test_torch_profiler.py`).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.config import load
from sparksched_tpu_torch.obs.runlog import RunLog
from sparksched_tpu_torch.schedulers import params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import mini_train_cfg
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_COUNTERPART = ("jit_compile", "jit_compile_detail", "memory")
CLOCK_KEYS = ("t", "secs", "collect_seconds", "update_seconds")


def _records(path) -> list[dict]:
    return [r for r in map(json.loads, open(path))
            if r["ev"] not in NO_COUNTERPART]


def test_two_iteration_runlog_matches_jax(tmp_path):
    def cfg_at(name):
        cfg = mini_train_cfg(artifacts_dir=str(tmp_path / name))
        cfg["obs"] = {"runlog": str(tmp_path / f"{name}.jsonl"),
                      "telemetry": True}
        return cfg

    jt = jax_make_trainer(cfg_at("jax"))
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    tt = make_trainer(cfg_at("port"), device="cpu")
    tt.scheduler.load_params(params_from_flax(jax.tree_util.tree_map(
        np.asarray, jt.scheduler.params)))
    jt.train()
    tt.train()
    want, got = _records(tmp_path / "jax.jsonl"), _records(
        tmp_path / "port.jsonl")
    assert [r["ev"] for r in got] == [r["ev"] for r in want]
    assert [r["ev"] for r in got] == [
        "run_start"] + ["span", "span", "telemetry", "scalars"] * 2 + [
        "run_end"]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["ev"], set(g) ^ set(w))
        if g["ev"] == "telemetry":
            assert g["summary"] == w["summary"]
        elif g["ev"] in ("span", "run_start", "run_end"):
            assert {k: v for k, v in g.items() if k not in CLOCK_KEYS} == {
                k: v for k, v in w.items() if k not in CLOCK_KEYS}
        elif g["ev"] == "scalars":
            for k, v in w.items():
                if k in CLOCK_KEYS:
                    continue
                assert g[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_size_cap_rotates_into_complete_segments(tmp_path):
    path = str(tmp_path / "r.jsonl")
    log = RunLog(path, max_bytes=400)
    for i in range(20):
        log.scalars(i, {"x": float(i), "pad": "p" * 40})
    log.close(iteration=20)
    segs = sorted((p for p in os.listdir(tmp_path) if p != "r.jsonl"),
                  key=lambda p: int(p.rsplit(".", 1)[1]))
    assert segs and segs[0] == "r.jsonl.1"
    seen = []
    for p in segs + ["r.jsonl"]:
        recs = [json.loads(x) for x in open(tmp_path / p)]
        seen += [r["iteration"] for r in recs if r["ev"] == "scalars"]
    assert seen == list(range(20))
    active = [json.loads(x) for x in open(path)]
    assert active[0]["ev"] == "rotate" and active[-1]["ev"] == "run_end"


def test_flagship_config_keys_are_honoured(capsys):
    cfg = load(os.path.join(REPO, "config", "decima_tpch.yaml"))
    t = make_trainer(cfg, device="cpu")
    out = capsys.readouterr().out
    ignored = out.split("ignored:", 1)[1] if "ignored:" in out else ""
    for key in ("checkpointing_freq", "checkpoint_every", "health.keep",
                "straggler_ratio_max", "obs.runlog", "obs.telemetry"):
        assert key not in ignored, key
    assert "fast_prng" not in ignored and t.prng_impl == "rbg"
    assert t.checkpointing_freq == 50 and t.health_checkpoint_every == 25
    assert t.checkpoint_keep == 2 and t.obs_runlog and t.obs_telemetry
    # the config sets use_tensorboard: False; set, it is honoured
    cfg["trainer"]["use_tensorboard"] = True
    cfg["obs"]["trace_iteration"] = 3
    t = make_trainer(cfg, device="cpu")
    assert "ignored" not in capsys.readouterr().out
    assert t.use_tensorboard and t.obs_trace_iteration == 3
