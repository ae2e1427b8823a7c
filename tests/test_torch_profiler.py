"""The port's profiler, the iteration trace and the TensorBoard mirror (the
JAX package's `trainers/profiler.py` and the trainer's `profiling`,
`profile_trace_dir`, `obs.trace_iteration` / `trace_dir` and
`use_tensorboard`).

- `Profiler`: the sink receives the span when quiet; a raise inside a
  traced block leaves no capture running (JAX's `tests/test_obs.py`
  cases); `annotate` opens a profiler range only while one runs.
- One training run (`mini_train_cfg`, PPO, 2 iterations at T = 12) with
  `obs.trace_iteration: 1`, `profile_trace_dir`, `use_tensorboard` and
  the run log: the legacy directory holds the first collect only, the
  obs directory iteration 2's collect and update, each with its
  `iter N ...` range and the `annotate` labels inside it; TensorBoard's
  event file holds the run log's `scalars` records' tags, values and
  steps exactly.
- With `torch.utils.tensorboard` unimportable the run goes on and says
  where the stats went (the run log).
- No key of the shipped configs' `trainer:`, `agent:` and `obs:` blocks is
  named as ignored; only `parallel.*` is.
"""

from __future__ import annotations

import functools
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from sparksched_tpu_torch.obs.tracing import annotate
from sparksched_tpu_torch.trainers import Profiler, make_trainer

from ._torch_parity import mini_train_cfg, runlog_records
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profiler_sink_receives_span_even_when_quiet(capsys):
    got = []
    with Profiler(None, "lbl", quiet=True,
                  sink=lambda n, s: got.append((n, s))) as p:
        pass
    assert got == [("lbl", p.elapsed)] and p.elapsed >= 0.0
    assert capsys.readouterr().out == ""
    with Profiler(None, "loud"):
        pass
    assert "[profiler] loud:" in capsys.readouterr().out


def _names(path: str) -> set:
    with open(path) as fp:
        return {e.get("name") for e in json.load(fp)["traceEvents"]}


def test_profiler_stops_capture_on_exception(tmp_path):
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        with Profiler(str(tmp_path / "t1"), "lbl", quiet=True,
                      sink=lambda n, s: got.append(n)):
            with annotate("inner"):
                raise RuntimeError("boom")
    assert got == ["lbl"] and not torch.autograd._profiler_enabled()
    # the capture is free again: a fresh one starts, records and exports
    with Profiler(str(tmp_path / "t2"), "again", quiet=True) as p:
        with annotate("phase"):
            torch.ones(3).sum()
    assert {"again", "phase"} <= _names(p.trace_path)
    assert p.trace_bytes == os.path.getsize(p.trace_path) > 0
    # outside a capture annotate opens no profiler range
    with annotate("untraced") as a:
        assert a._range is None


@functools.lru_cache(maxsize=None)
def _traced_run(root: str):
    cfg = mini_train_cfg(rollout_steps=12, use_tensorboard=True,
                         profiling=True, artifacts_dir=root,
                         profile_trace_dir=os.path.join(root, "legacy"))
    cfg["obs"] = {"runlog": True, "memory": False, "trace_iteration": 1,
                  "trace_dir": os.path.join(root, "trace")}
    tt = make_trainer(cfg, device="cpu")
    tt.train()
    return tt


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return _traced_run(str(tmp_path_factory.mktemp("traced")))


def test_trace_iteration_and_legacy_dir(traced):
    root = traced.artifacts_dir
    assert sorted(os.listdir(os.path.join(root, "legacy"))) == [
        "iter_1_collect.json"]
    assert sorted(os.listdir(os.path.join(root, "trace"))) == [
        "iter_2_collect.json", "iter_2_update.json"]
    assert [os.path.basename(p.trace_path) for p in traced.last_traces] == [
        "iter_2_collect.json", "iter_2_update.json"]
    collect = _names(os.path.join(root, "trace", "iter_2_collect.json"))
    update = _names(os.path.join(root, "trace", "iter_2_update.json"))
    assert {"iter 2 collect", "decima/gnn"} <= collect
    assert {"iter 2 update", "train/ppo_update", "decima/gnn"} <= update
    assert "iter 1 collect" in _names(
        os.path.join(root, "legacy", "iter_1_collect.json"))
    spans = [r["name"] for r in runlog_records(root) if r["ev"] == "span"]
    assert spans == ["iter 1 collect", "iter 1 update", "iter 2 collect",
                     "iter 2 update"]


def test_tensorboard_scalars_equal_the_runlog(traced):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    recs = [r for r in runlog_records(traced.artifacts_dir)
            if r["ev"] == "scalars"]
    assert [r["iteration"] for r in recs] == [0, 1]
    files = glob.glob(os.path.join(traced.artifacts_dir, "tb", "*"))
    assert len(files) == 1
    acc = EventAccumulator(files[0], size_guidance={"scalars": 0})
    acc.Reload()
    want = {}
    for r in recs:
        for k, v in r.items():
            if k not in ("ev", "t", "iteration"):
                want.setdefault(k, []).append((r["iteration"], v))
    assert set(acc.Tags()["scalars"]) == set(want)
    for tag, pairs in want.items():
        got = [(e.step, e.value) for e in acc.Scalars(tag)]
        assert [s for s, _ in got] == [s for s, _ in pairs], tag
        np.testing.assert_array_equal(
            np.float32([v for _, v in got]), np.float32([v for _, v in pairs]),
            err_msg=tag)


def test_tensorboard_fallback_without_the_package(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = mini_train_cfg(num_iterations=1, rollout_steps=8,
                         use_tensorboard=True, artifacts_dir=str(tmp_path))
    cfg["obs"] = {"runlog": True, "memory": False}
    tt = make_trainer(cfg, device="cpu")
    tt.train()
    out = capsys.readouterr().out
    assert "use_tensorboard: torch.utils.tensorboard is unavailable" in out
    assert os.path.join(str(tmp_path), "runlog") in out
    assert not os.path.exists(tmp_path / "tb")
    assert any(r["ev"] == "scalars" for r in runlog_records(tmp_path))


@pytest.mark.parametrize("name", ["decima_tpch.yaml",
                                  "decima_tpch_multichip.yaml", "test.yaml"])
def test_only_parallel_keys_are_named_as_ignored(name, capsys):
    with open(os.path.join(HERE, "config", name)) as fp:
        cfg = yaml.safe_load(fp)
    cfg["obs"] = dict(cfg.get("obs") or {}, slo={"rules": []},
                      trace_dir="unused")
    cfg["trainer"] |= {"profiling": True, "profile_trace_dir": "unused",
                       "use_tensorboard": True, "trainer_cls": "VPG"}
    cfg["agent"] |= {"compute_dtype": "bfloat16"}
    make_trainer(cfg, device="cpu")
    out = capsys.readouterr().out
    parallel = [f"parallel.{k}" for k in (cfg.get("parallel") or {})]
    if parallel:
        assert f"not ported yet, ignored: {', '.join(parallel)}" in out
    else:
        assert "ignored" not in out
