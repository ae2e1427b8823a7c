"""Recovery from the `chaos:` block's process-level faults in the port
trainer (`scripts_chaos_drill.py`'s `oom` and `sigkill` drills, and
`tests/test_health.py::test_resume_after_sigkill_is_step_exact`).

- A real `torch.OutOfMemoryError` (the class a CUDA allocation failure
  raises) from the update is retried as `oom` with the health block on:
  the partial step rolled back, the iteration run again on the reseeded
  key, `health` and `recovery` records written; with the block off it
  propagates.
- A `sigkill` run in a child process dies at iteration 1 (after its
  collect); resumed from the `checkpoint_every: 1` train state it ends
  bit-equal to an uninterrupted run (the train state's bytes), under
  `fast_prng: True`.

Config: the drill's (5 executors, 3 job slots, 2 lanes, T = 30) on the
flat single-eval engine (`_torch_parity.py:drill_cfg`).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from sparksched_tpu_torch.serialization import to_bytes
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import drill_cfg as _drill_cfg
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from ._torch_parity import runlog_records as _records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_real_oom_from_update_is_retried(tmp_path, monkeypatch):
    t = make_trainer(_drill_cfg(tmp_path / "on", 2), device="cpu")
    update, calls = t._update, []

    def oom_once(state, ro):
        calls.append((state.rng.clone(), {k: v.detach().clone()
                                          for k, v in state.params.items()}))
        if len(calls) == 1:
            with torch.no_grad():  # a partial step the rollback must undo
                for p in state.params.values():
                    p.add_(1.0)
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return update(state, ro)

    monkeypatch.setattr(t, "_update", oom_once)
    state = t.train()
    assert state.iteration == 2 and len(calls) == 3
    (rng0, p0), (rng1, p1) = calls[:2]
    assert not torch.equal(rng0, rng1)  # the retry is reseeded
    for k, v in p0.items():  # and starts from the rolled-back parameters
        assert torch.equal(p1[k], v), k
    recs = [r for r in _records(tmp_path / "on")
            if r["ev"] in ("health", "recovery")]
    assert [(r["ev"], r["action"], r["bits"]) for r in recs] == [
        ("health", "rollback_retry", ["oom"]),
        ("recovery", "rollback_retry", ["oom"])]
    assert "out of memory" in recs[0]["detail"]

    cfg = _drill_cfg(tmp_path / "off", 1)
    del cfg["health"]  # without the health block the error propagates
    t2 = make_trainer(cfg, device="cpu")

    def oom(state, ro):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(t2, "_update", oom)
    with pytest.raises(torch.OutOfMemoryError):
        t2.train()


def test_sigkill_resume_is_bit_exact(tmp_path):
    killed = tmp_path / "killed"
    cfg = _drill_cfg(killed, 3, chaos_blk={"sigkill": [1]},
                     fast_prng=True)
    # one torch thread, as this process runs (the float sums' order)
    code = ("import json, sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from sparksched_tpu_torch.trainers import make_trainer\n"
            "make_trainer(json.loads(sys.argv[1]), device='cpu').train()\n")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(cfg)],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=os.environ | {"PYTHONPATH": REPO})
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    assert "[chaos] SIGKILL at iteration 1" in r.stdout
    path = killed / "train_state.msgpack"
    meta = json.loads((killed / "train_state.msgpack.meta.json").read_text())
    assert meta["iteration"] == 1 and meta["prng_impl"] == "rbg"
    resumer = make_trainer(_drill_cfg(killed, 2, fast_prng=True),
                           device="cpu")
    resumed = resumer.train(resume_from=str(path))
    full_t = make_trainer(_drill_cfg(tmp_path / "full", 3, fast_prng=True),
                          device="cpu")
    full = full_t.train()
    assert resumed.iteration == full.iteration == 3
    assert any(r["ev"] == "resume" for r in _records(killed))
    assert (to_bytes(resumer.train_state_tree(resumed))
            == to_bytes(full_t.train_state_tree(full)))
