"""The port's serving slice against the JAX package's: the same small
setup as tests/test_serve.py (5 executors, 6 jobs, embed 8, job_bucket
4), a JAX `SessionStore` and the port's `SessionStore(device="cpu")`
with the weights carried across by `params_from_flax`, both built with
no knobs (each package's `SERVE_KNOBS`: the bulk engine) or both with
knobs={"event_bulk": False, "fulfill_bulk": False} (the sequential
engine). Over a mixed run of create / decide_batch / decide /
step / close calls every `ServeResult` field must agree (integers and
bools equal, floats within rtol 1e-5, with atol 1e-6 for values near
zero), and a poisoned session must quarantine alike. The weights are
scaled by 0.3 on both sides (see tests/test_torch_decima.py: at random
init the Tanh heads tie greedy choices below float32 resolution).

Also: the port imports no JAX (a subprocess serves a decision with
`jax`/`flax` blocked), and with no card its entry points raise unless
the caller asks for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.config import EnvParams as JaxParams
from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.serve import SessionQuarantined as JaxQuarantined
from sparksched_tpu.serve import SessionStore as JaxStore
from sparksched_tpu.workload import make_workload_bank as jax_bank
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env.health import H_NONFINITE_TIME
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax
from sparksched_tpu_torch.serve import SessionQuarantined, SessionStore
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_executors=5, embed_dim=8, gnn_mlp_kwargs={"hid_dims": [16]},
          policy_mlp_kwargs={"hid_dims": [16]}, job_bucket=4)
INT_FIELDS = ("session_id", "stage_idx", "job_idx", "num_exec", "decided",
              "done", "health_mask", "batched", "params_version")
FLOAT_FIELDS = ("lgprob", "reward", "dt", "wall_time")


# no knobs: each store's default, SERVE_KNOBS
KNOB_SETS = {"default": None,
             "knobs_off": {"event_bulk": False, "fulfill_bulk": False}}


@pytest.fixture(scope="module", params=list(KNOB_SETS))
def stores(request):
    knobs = KNOB_SETS[request.param]
    jp = JaxParams(num_executors=5, max_jobs=6, max_stages=20, max_levels=20,
                   mean_time_limit=None)
    jb = jax_bank(jp.num_executors, jp.max_stages)
    jp = jp.replace(max_stages=jb.max_stages, max_levels=jb.max_stages)
    js = JaxDecima(**KW)
    js.params = jax.tree_util.tree_map(lambda a: a * 0.3, js.params)
    jstore = JaxStore(jp, jb, js, capacity=6, max_batch=3, seed=0,
                      knobs=knobs)
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=jp.max_stages,
                   max_levels=jp.max_levels)
    tb = make_workload_bank(5, tp.max_stages, device="cpu")
    ts = DecimaScheduler(**KW, device="cpu")
    ts.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray, js.params)))
    tstore = SessionStore(tp, tb, ts, capacity=6, max_batch=3, seed=0,
                          knobs=knobs, device="cpu")
    assert tstore.knobs == jstore.knobs
    return jstore, tstore


def _same(a, b) -> None:
    for k in INT_FIELDS:
        assert getattr(a, k) == getattr(b, k), (k, a.to_dict(), b.to_dict())
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_serve_matches_jax_store(stores):
    jstore, tstore = stores
    seeds = [11, 12, None, 13, None]
    live = []
    for s in seeds:
        sid = jstore.create(seed=s)
        assert tstore.create(seed=s) == sid
        live.append(sid)
    rng = np.random.default_rng(0)
    served = 0
    for it in range(40):
        op = it % 5
        if op in (0, 1):
            batch = [int(x) for x in rng.choice(live, size=min(3, len(live)),
                                                replace=False)]
            for a, b in zip(jstore.decide_batch(batch),
                            tstore.decide_batch(batch)):
                _same(a, b)
                served += 1
        elif op == 2:
            sid = int(rng.choice(live))
            _same(jstore.decide(sid), tstore.decide(sid))
            served += 1
        elif op == 3:
            sid = int(rng.choice(live))
            sch = tstore.store.env.schedulable[sid].reshape(-1)
            stage = int(torch.argmax(sch.int())) if bool(sch.any()) else -1
            _same(jstore.step(sid, stage, 2), tstore.step(sid, stage, 2))
            served += 1
        elif it % 10 == 4:
            sid = live.pop(int(rng.integers(len(live))))
            jstore.close(sid)
            tstore.close(sid)
            seed = None if it % 20 == 4 else 100 + it
            new = jstore.create(seed=seed)
            assert tstore.create(seed=seed) == new
            live.append(new)
    assert served >= 40
    assert any(r.decided for r in tstore.decide_batch(live[:3]))
    for sid in live:
        jstore.close(sid)
        tstore.close(sid)


def test_quarantine_matches_jax_store(stores):
    jstore, tstore = stores
    bad, ok = jstore.create(seed=77), jstore.create(seed=78)
    assert (tstore.create(seed=77), tstore.create(seed=78)) == (bad, ok)
    env = jstore._store.env
    jstore._store = jstore._store.replace(env=env.replace(
        job_t_completed=env.job_t_completed.at[bad].set(jnp.nan)))
    tstore.store.env.job_t_completed[bad] = float("nan")
    a, b = jstore.decide(bad), tstore.decide(bad)
    _same(a, b)
    assert b.health_mask & H_NONFINITE_TIME
    assert tstore.stats["serve_quarantines"] == 1
    with pytest.raises(JaxQuarantined):
        jstore.decide(bad)
    for call in (lambda: tstore.decide(bad), lambda: tstore.step(bad, 0, 1),
                 lambda: tstore.decide_batch([ok, bad])):
        with pytest.raises(SessionQuarantined):
            call()
    _same(jstore.decide(ok), tstore.decide(ok))
    for sid in (bad, ok):
        jstore.close(sid)
        tstore.close(sid)


def test_port_imports_no_jax():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.schedulers import DecimaScheduler
from sparksched_tpu_torch.serve import (
    ContinuousBatcher, MicroBatcher, SessionStore, front_from_config,
    generate_arrivals, run_open_loop, store_from_config)
from sparksched_tpu_torch.serve.server import ServeClient, ServeServer
from sparksched_tpu_torch.workload import make_workload_bank
import sparksched_tpu_torch.train, sparksched_tpu_torch.trainers
import sparksched_tpu_torch.obs.critpath, sparksched_tpu_torch.obs.metrics
import sparksched_tpu_torch.serve.loadgen, sparksched_tpu_torch.ownership
import sparksched_tpu_torch.online
bank = make_workload_bank(5, device="cpu")
params = EnvParams(num_executors=5, max_jobs=6, max_stages=bank.max_stages,
                   max_levels=bank.max_stages)
sched = DecimaScheduler(5, embed_dim=8, job_bucket=4, device="cpu")
store = SessionStore(params, bank, sched, capacity=2, max_batch=2, device="cpu")
r = store.decide(store.create(seed=1))
assert r.decided and r.health_mask == 0
cfg = {"capacity": 4, "max_batch": 2, "hot_capacity": 2, "front": "pipelined",
       "trace": True, "metrics": True}
paged = store_from_config(cfg, params, bank, sched, device="cpu")
front = front_from_config(cfg, paged)
out = run_open_loop(paged, front, generate_arrivals(200.0, 6, 3, seed=1))
assert out["completed"] == 6
with ServeServer(paged, front) as server:
    with ServeClient("127.0.0.1", server.port) as client:
        tk = client.submit(client.create(seed=2))
        client.flush()
        assert tk.error is None
from sparksched_tpu_torch.online import online_from_config
ring = SessionStore(params, bank, sched, capacity=2, max_batch=2, record=True,
                    ring=2, device="cpu")
buf, learner, bus = online_from_config(
    {"max_steps": 2, "batch_trajectories": 1}, ring,
    {"agent_cls": "DecimaScheduler", "embed_dim": 8, "job_bucket": 4})
sid = ring.create(seed=3)
ring.decide(sid)
ring.decide(sid)
ring.drain_ring()
assert learner.step()["accepted"] and bus.pump()["event"] == "swap"
loaded = [m for m in sys.modules
          if m == "sparksched_tpu" or m.startswith("sparksched_tpu.")]
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_serve_knobs_are_the_jax_packages():
    from sparksched_tpu.serve.aot import SERVE_KNOBS as JAX_SERVE_KNOBS
    from sparksched_tpu_torch.serve import SERVE_KNOBS

    assert SERVE_KNOBS == JAX_SERVE_KNOBS


@pytest.mark.parametrize("knobs,err", [
    ({"bulk_width": 8}, ValueError),  # a knob neither package knows
])
def test_store_refuses_bulk_and_unknown_knobs(knobs, err):
    bank = make_workload_bank(5, device="cpu")
    params = EnvParams(num_executors=5, max_jobs=6, max_stages=bank.max_stages,
                       max_levels=bank.max_stages)
    sched = DecimaScheduler(5, embed_dim=8, device="cpu")
    with pytest.raises(err, match="bulk_width"):
        SessionStore(params, bank, sched, capacity=2, max_batch=2,
                     knobs=knobs, device="cpu")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_workload_bank(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecimaScheduler(5)
    bank = make_workload_bank(5, device="cpu")
    sched = DecimaScheduler(5, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SessionStore(EnvParams(num_executors=5), bank, sched)
    from sparksched_tpu_torch.serve import store_from_config
    from sparksched_tpu_torch.serve.server import server_from_config

    for build in (store_from_config, server_from_config):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build({"capacity": 2, "max_batch": 2},
                  EnvParams(num_executors=5), bank, sched)
    from sparksched_tpu_torch.online import make_learner_trainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_learner_trainer({"agent_cls": "DecimaScheduler"},
                             EnvParams(num_executors=5), 2, 4)
