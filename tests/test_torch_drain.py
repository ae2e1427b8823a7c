"""The port's `apply_and_drain` against the JAX package's over whole
episodes: at `SERVE_KNOBS` (the serving default: bulk passes on, one
fused cycle, bulk fulfillment), with `bulk_cycles=2` and with
`bulk_fused=False`, on a reference fixture, on the synthetic bank (two
lanes, short time limits) and in the dense-interleaving regime (the
duration sampler pinned to a table lookup at durations x 0.02, moving
delay 700: relaunch-generated finishes interleave with arrival bursts).
Every LoopState leaf and the span records (decided, reward, dt, reset)
are compared after every decision, the actions from the JAX fair
policy. Also the drain with `auto_reset`, where a lane restarts from
its drain key. Tolerances: integers and bools equal; floats bit-equal
on the fixture, within rtol 1e-6 on the synthetic bank and under the
pinned sampler (see `tests/test_torch_bulk.py`)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparksched_tpu.env import core as jcore
from sparksched_tpu.env import flat_loop as jfl
from sparksched_tpu.env.observe import observe as jobserve
from sparksched_tpu.schedulers import round_robin_policy as j_round_robin
from sparksched_tpu_torch.env import flat_loop
from sparksched_tpu_torch.env.observe import observe
from sparksched_tpu_torch.schedulers import round_robin_policy
from sparksched_tpu_torch.serve import SERVE_KNOBS

from ._torch_parity import port_from_jax
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_bulk import _assert_same, _episodes, _i32, _keys, _synthetic

KNOBS = {
    "serve": SERVE_KNOBS,
    "unfused": SERVE_KNOBS | {"bulk_fused": False},
    "cycles2": SERVE_KNOBS | {"bulk_cycles": 2},
}


@pytest.mark.parametrize("source,knobs", [
    ("fixture", "serve"), ("synthetic", "serve"), ("synthetic", "cycles2"),
    ("dense", "serve"), ("dense", "unfused"),
])
def test_apply_and_drain_matches_jax(monkeypatch, source, knobs):
    jp, jb, tp, tb, js, rtol = _episodes(monkeypatch, source)
    kn = KNOBS[knobs]
    ts = port_from_jax(js)
    b = js.mode.shape[0]

    @jax.jit
    def jstep(ls, si, ne, keys):
        return jax.vmap(lambda l, s, n, k: jfl.apply_and_drain(
            jp, jb, l, s, n, k, auto_reset=False, **kn))(ls, si, ne, keys)

    @jax.jit
    def fair(env):
        return jax.vmap(lambda e: j_round_robin(
            jobserve(jp, e), jp.num_executors, True))(env)

    bulked = 0
    for d in range(400):
        # a lane is over when its episode ended or its drain handed it
        # back with an empty queue and no round (it cannot progress)
        env = js.env
        stuck = ((js.mode == jfl.M_EVENT) & ~env.round_ready
                 & ~jax.vmap(jcore._has_pending_event)(env))
        done = jax.vmap(jfl._lane_done)(env)
        if bool((done | stuck).all()):
            assert bool(done.any())
            break
        si, ne = fair(js.env)
        if d % 7 == 6 and source != "dense":
            # now and then no selection: commit the rest (dense episodes,
            # whose jobs arrive early, would stall on an empty queue)
            si = jnp.full_like(si, -1)
        keys = jax.random.split(jax.random.PRNGKey(d), b)
        js, jrec = jstep(js, si, ne, keys)
        ts, trec = flat_loop.apply_and_drain(tp, tb, ts, _i32(si), _i32(ne),
                                             _keys(keys), **kn)
        _assert_same(js, ts, rtol, f"decision {d}")
        for a, t in zip(jrec, trec):
            a, t = np.asarray(a), t.numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(t, a, rtol=max(rtol, 1e-6),
                                           atol=1e-3)
            else:
                assert np.array_equal(a, t), (d, a, t)
        bulked = int(ts.bulked.sum())
    else:
        pytest.fail("the episodes did not end in 400 decisions")
    assert bulked > 0




def test_apply_and_drain_auto_reset_matches_jax():
    """With `auto_reset` a lane whose episode ends inside the drain
    restarts from its drain key's reset draw; 40 decisions on two
    synthetic lanes with short time limits, at `SERVE_KNOBS`."""
    jp, jb, tp, tb = _synthetic(mean_time_limit=5e5)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    js = jax.vmap(lambda k: jfl.init_loop_state(jcore.reset(jp, jb, k)))(keys)
    ts = port_from_jax(js)

    @jax.jit
    def jstep(ls, keys):
        def one(l, k):
            si, ne = j_round_robin(jobserve(jp, l.env), jp.num_executors,
                                   True)
            return jfl.apply_and_drain(jp, jb, l, si, ne, k,
                                       auto_reset=True, **SERVE_KNOBS)
        return jax.vmap(one)(ls, keys)

    for d in range(40):
        keys = jax.random.split(jax.random.PRNGKey(50 + d), 2)
        si, ne = round_robin_policy(observe(tp, ts.env), tp.num_executors)
        js, jrec = jstep(js, keys)
        ts, trec = flat_loop.apply_and_drain(tp, tb, ts, si, ne, _keys(keys),
                                             auto_reset=True, **SERVE_KNOBS)
        _assert_same(js, ts, 1e-6, f"decision {d}")
        for a, t in zip(jrec, trec):
            a, t = np.asarray(a), t.numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(t, a, rtol=1e-6, atol=1e-3)
            else:
                assert np.array_equal(a, t), (d, a, t)
    assert int(ts.episodes.sum()) >= 2  # episodes ended and restarted
