"""The port's Decima model against the flax one, with the same weights
carried across by `params_from_flax`: features and their compaction must
be equal; the NodeEncoder's plain version (`decima_node_encoder_ref`) and
the whole `DecimaNet` agree within rtol 1e-4 / atol 1e-5 (the tolerance
of the JAX package's own torch-forward test); greedy actions must be
equal; the >K full-width fallback and a batch that mixes edged and
edgeless lanes are covered.

Greedy actions are compared with the carried weights scaled by 0.3 on
both sides: at flax's random init the Tanh heads saturate at these
feature magnitudes, and greedy choices can then be separated by less
than two float32 implementations order alike; the scale keeps the
heads out of saturation."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.env.observe import Observation as JaxObservation
from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.schedulers.decima import compact_features as jax_compact
from sparksched_tpu_torch import prng
from sparksched_tpu_torch.config import EnvParams
from sparksched_tpu_torch.env import core, flat_loop
from sparksched_tpu_torch.env.observe import observe
from sparksched_tpu_torch.kernels.decima_encoder import (
    decima_node_encoder,
    decima_node_encoder_ref,
)
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax
from sparksched_tpu_torch.schedulers.decima import compact_features
from sparksched_tpu_torch.workload import make_workload_bank

from ._torch_parity import jax_h_node
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

N, J, B = 10, 24, 6
KW = dict(
    num_executors=N, embed_dim=8,
    gnn_mlp_kwargs={"hid_dims": [16, 8], "act_cls": "LeakyReLU",
                    "act_kwargs": {"negative_slope": 0.2}},
    policy_mlp_kwargs={"hid_dims": [16], "act_cls": "Tanh"},
)
FEATURE_FIELDS = ("x", "node_mask", "job_mask", "stage_mask", "exec_mask",
                  "adj", "node_level")


@pytest.fixture(scope="module")
def obs_pair():
    """A [B]-lane observation of progressed episodes, as port tensors and
    as the JAX package's Observation over the same arrays."""
    tp = EnvParams(num_executors=N, max_jobs=J, mean_time_limit=None)
    tb = make_workload_bank(N, tp.max_stages, device="cpu")
    tp = tp.replace(max_stages=tb.max_stages, max_levels=tb.max_stages)
    ls = flat_loop.init_loop_state(
        core.reset(tp, tb, torch.stack([prng.PRNGKey(s) for s in range(B)]))
    )
    for d in range(12):
        sch = ls.env.schedulable.reshape(B, -1)
        si = torch.where(sch.any(1), torch.argmax(sch.int(), 1), -1)
        ls, _ = flat_loop.apply_and_drain(
            tp, tb, ls, si.int(), torch.full((B,), 1 + d % 2, dtype=torch.int32),
            prng.split(prng.PRNGKey(d), B), event_bulk=False,
            fulfill_bulk=False,
        )
    to = observe(tp, ls.env)
    jo = JaxObservation(**{k: jnp.asarray(v.numpy()) for k, v in vars(to).items()})
    assert int(to.job_mask.sum(1).max()) > 2
    return to, jo


def _pair(scale: float = 1.0, **kw):
    js = JaxDecima(**KW, **kw)
    js.params = jax.tree_util.tree_map(lambda a: a * scale, js.params)
    ts = DecimaScheduler(**KW, **kw, device="cpu")
    ts.load_params(params_from_flax(jax.tree_util.tree_map(np.asarray, js.params)))
    return js, ts


def _encode_ref(ts, tf):
    net = ts.net
    return decima_node_encoder_ref(
        tf.x, tf.adj, tf.node_level, tf.node_mask, net.encoder_weights(),
        net.num_levels, net.slope,
    )


def test_features_and_compaction_equal(obs_pair):
    to, jo = obs_pair
    js, ts = _pair()
    jf, tf = jax.vmap(js.features)(jo), ts.features(to)
    for name in FEATURE_FIELDS:
        assert np.array_equal(np.asarray(getattr(jf, name)),
                              getattr(tf, name).numpy()), name
    jk, jids = jax.vmap(lambda f: jax_compact(f, 4))(jf)
    tk, tids = compact_features(tf, 4)
    assert np.array_equal(np.asarray(jids), tids.numpy())
    for name in FEATURE_FIELDS:
        assert np.array_equal(np.asarray(getattr(jk, name)),
                              getattr(tk, name).numpy()), name


@pytest.mark.parametrize("num_levels", [0, 6])
def test_encoder_ref_and_net_match_flax(obs_pair, num_levels):
    to, jo = obs_pair
    js, ts = _pair(num_levels=num_levels)
    jf, tf = jax.vmap(js.features)(jo), ts.features(to)
    np.testing.assert_allclose(_encode_ref(ts, tf).numpy(),
                               jax_h_node(js, jf), rtol=1e-4, atol=1e-5)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        decima_node_encoder(
            tf.x, tf.adj, tf.node_level, tf.node_mask,
            ts.net.encoder_weights(), num_levels, ts.net.slope,
        ).numpy(),
        _encode_ref(ts, tf).numpy(),
    )
    jss, jes = js.net.apply(js.params, jf)
    tss, tes = ts.net(tf)
    np.testing.assert_allclose(tss.numpy(), np.asarray(jss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tes.numpy(), np.asarray(jes), rtol=1e-4, atol=1e-5)


def test_encoder_weights_packed_once_per_parameter_version():
    """The kernel's packed weights are built once and reused until a
    weight changes (`load_params`, as `SessionStore.set_params` does)."""
    _, ts = _pair()
    w = ts.net.encoder_weights()
    assert ts.net.encoder_weights() is w
    ts.load_params({k: v * 2 for k, v in ts.params.items()})
    w2 = ts.net.encoder_weights()
    assert w2 is not w
    np.testing.assert_array_equal(w2.packed.numpy(), w.packed.numpy() * 2)
    assert ts.net.encoder_weights() is w2


def test_mixed_edged_and_edgeless_batch(obs_pair):
    """The edgeless fallback is per lane: lanes whose adjacency is wiped
    take h = prep(x) while their batch-mates keep the message pass."""
    to, jo = obs_pair
    js, ts = _pair()
    tf = ts.features(to)
    wipe = torch.tensor([i % 2 == 1 for i in range(B)])
    tf.adj = tf.adj & ~wipe[:, None, None, None]
    assert bool(tf.adj[0].any()) and not bool(tf.adj[1].any())
    jf = jax.vmap(js.features)(jo).replace(adj=jnp.asarray(tf.adj.numpy()))
    np.testing.assert_allclose(_encode_ref(ts, tf).numpy(),
                               jax_h_node(js, jf), rtol=1e-4, atol=1e-5)
    jss, jes = js.net.apply(js.params, jf)
    tss, tes = ts.net(tf)
    np.testing.assert_allclose(tss.numpy(), np.asarray(jss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tes.numpy(), np.asarray(jes), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("job_bucket", [0, 4, 20])
def test_greedy_actions_equal_with_compaction_and_fallback(obs_pair, job_bucket):
    """job_bucket 4 is below the busiest lane's active-job count (the
    full-width fallback), 20 compacts every lane; 0 never compacts."""
    to, jo = obs_pair
    busiest = int(to.job_mask.sum(1).max())
    assert 4 < busiest <= 20 < J
    js, ts = _pair(scale=0.3, job_bucket=job_bucket)
    ja = js.batch_policy(jax.random.PRNGKey(0), jo, deterministic=True)
    ta = ts.batch_policy(None, to, deterministic=True)
    for a, b in zip(ja[:2], ta[:2]):
        assert np.array_equal(np.asarray(a), b.numpy())
    for k in ("job_idx", "num_exec_k"):
        assert np.array_equal(np.asarray(ja[2][k]), ta[2][k].numpy())
    np.testing.assert_allclose(ta[2]["lgprob"].numpy(),
                               np.asarray(ja[2]["lgprob"]), rtol=1e-5, atol=1e-6)
    # compacted or not, the port's scores agree on every active job
    tf = ts.features(to)
    ss, es = ts.score(tf)
    fs, fe = ts.net(tf)
    m = tf.job_mask
    np.testing.assert_allclose(ss[m].numpy(), fs[m].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(es[m].numpy(), fe[m].numpy(), rtol=1e-5, atol=1e-6)
    jss, jes = js.score(js.params, jax.vmap(js.features)(jo))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-4, atol=1e-5)

