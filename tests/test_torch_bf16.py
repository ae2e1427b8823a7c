"""`compute_dtype: bfloat16` in the port against the JAX package's bf16
`DecimaNet`, and the bf16 NodeEncoder kernels' own source against the
plain versions, on the CPU.

Tolerances are in bf16 ulps at the output's scale (the ulp of its largest
magnitude, u = 2^-8 relative) or relative to a gradient's norm:

- The forward: the bf16 plain NodeEncoder and the whole scores against
  JAX's within 1 ulp and at least 99% bit-equal (measured: bit-equal; the
  plain version rounds where XLA:CPU rounds: each Dense's product, then
  its bias sum, LeakyReLU's product with the slope rounded to bf16, the
  aggregation, the update's sum, the DAG and global sums), and apart
  from the port's own float32 scores by more than 10 ulps.
- The NodeEncoder's gradient given the same dL/dh: every weight within
  2^-8 of its norm (measured: bit-equal), every bias within 0.1 of its
  norm. XLA:CPU sums a bias's cotangent over the rows one bf16 addition
  at a time (a broadcast's transpose; measured to match a sequential bf16
  sum bit for bit), torch in float32, rounded once.
- The whole net's gradient (both heads' cotangents go through broadcasts
  summed the same way) within 5e-2 of its norm, and apart from the
  float32 gradient by more than 1e-3 of its norm.
- A PPO and a VPG update from the same rollout (collected by the JAX bf16
  trainer) and weights, at Adam eps 1e-2 / lr 3e-2 (a step linear in the
  gradient): the change of all parameters together within 5e-2 of the
  JAX change's norm, and apart from the port's float32 update.
- The kernels' arithmetic (`csrc/encoder_bf16.cuh`, what both bf16 CUDA
  kernels run) built with g++, one thread a block, against the plain
  versions on `make_case`'s inputs: the forward within 2 ulps and at
  least 98% bit-equal, the gradient within 2e-2 of each tensor's norm
  (the plain version rounds each use's weight gradient to bf16, the
  kernel sums the uses in float32), as `tests/test_torch_cuda.py` holds
  the card.
- Parameters, optimizer state and model files stay float32: a JAX bf16
  scheduler's parameters load unchanged; the wrappers take only their
  own dtype; another compute_dtype raises, naming it.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu.schedulers import DecimaScheduler as JaxDecima
from sparksched_tpu.trainers import make_trainer as jax_make_trainer
from sparksched_tpu_torch.kernels import build
from sparksched_tpu_torch.kernels.decima_encoder import (
    BF16,
    act_slope,
    decima_node_encoder,
    decima_node_encoder_bf16,
    decima_node_encoder_bwd_bf16,
    decima_node_encoder_bwd_ref,
    decima_node_encoder_ref,
    edgeless_per_lane,
    pack_weights,
    unpack_grad,
)
from sparksched_tpu_torch.schedulers import DecimaScheduler, params_from_flax
from sparksched_tpu_torch.trainers import make_trainer

from ._torch_parity import (
    BF16_BWD_REL,
    BF16_FWD_EQUAL,
    BF16_FWD_ULPS,
    BF16_UPDATE_REL,
    CASES,
    LINEAR_ADAM,
    bf16_ulps,
    make_case,
    mini_train_cfg,
    port_rollout_from_jax,
    rel_norm,
)
from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)
from .test_torch_decima import KW, obs_pair  # noqa: F401  (fixture)

ENCODER = ("mlp_prep.", "mlp_msg.", "mlp_update.")


def _pair(cdt):
    js = JaxDecima(**KW, compute_dtype=cdt)
    ts = DecimaScheduler(**KW, compute_dtype=cdt, device="cpu")
    ts.load_params(params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return js, ts


def _jax_h(js, jf, params):
    """The JAX net's h_node (the input of mlp_dag past x), per lane."""
    def one(p, f):
        seen = {}

        def icpt(nf, args, kw, ctx):
            if ctx.module.name == "mlp_dag" and ctx.method_name == "__call__":
                seen["h"] = args[0][..., 5:]
            return nf(*args, **kw)

        with fnn.intercept_methods(icpt):
            js.net.apply(p, f)
        return seen["h"]

    return jax.vmap(lambda f: one(params, f))(jf)


def test_forward_matches_jax_bf16(obs_pair):  # noqa: F811
    to, jo = obs_pair
    js, ts = _pair("bfloat16")
    jf, tf = jax.vmap(js.features)(jo), ts.features(to)
    assert ts.net.cdt == BF16
    h = decima_node_encoder_bf16(tf.x.to(BF16), tf.adj, tf.node_level,
                                 tf.node_mask, ts.net.encoder_weights(), 0,
                                 ts.net.slope)
    jh = torch.from_numpy(np.asarray(_jax_h(js, jf, js.params),
                                     np.float32))
    assert h.dtype == BF16 and bf16_ulps(h, jh) <= 1.0
    assert float((h.float() == jh).float().mean()) >= 0.99
    ss, es = ts.net(tf)
    assert ss.dtype == es.dtype == torch.float32
    jss, jes = jax.vmap(lambda f: js.net.apply(js.params, f))(jf)
    for got, want in ((ss, jss), (es, jes)):
        want = torch.from_numpy(np.asarray(want))
        assert bf16_ulps(got, want) <= 1.0
        assert float((got == want).float().mean()) >= 0.99
    s32, e32 = _pair(None)[1].net(tf)
    assert bf16_ulps(ss, s32) > 10 and bf16_ulps(es, e32) > 10


@pytest.mark.parametrize("whole", [False, True])
def test_gradient_matches_jax_bf16(obs_pair, whole):  # noqa: F811
    to, jo = obs_pair
    grads = {}
    for cdt in (None, "bfloat16"):
        js, ts = _pair(cdt)
        jf, tf = jax.vmap(js.features)(jo), ts.features(to)
        rng = np.random.default_rng(1)
        ss, es = ts.net(tf)
        gh = rng.standard_normal(tf.x.shape[:3] + (8,)).astype(np.float32)
        gs = rng.standard_normal(ss.shape).astype(np.float32)
        ge = rng.standard_normal(es.shape).astype(np.float32)

        def loss(p):
            if not whole:
                return (_jax_h(js, jf, p).astype(jnp.float32) * gh).sum()
            a, b = jax.vmap(lambda f: js.net.apply(p, f))(jf)
            return (a * gs).sum() + (b * ge).sum()

        want = params_from_flax(jax.tree_util.tree_map(
            np.asarray, jax.grad(loss)(js.params)))
        net = ts.net.requires_grad_(True)
        if whole:
            ss, es = net(tf)
            ((ss * torch.from_numpy(gs)).sum()
             + (es * torch.from_numpy(ge)).sum()).backward()
        else:
            h = net.encode(tf, tf.x.to(net.cdt))
            (h.float() * torch.from_numpy(gh)).sum().backward()
        got = {k: p.grad for k, p in net.named_parameters()
               if p.grad is not None}
        assert all(g.dtype == torch.float32 for g in got.values())
        grads[cdt] = got
        if not whole:
            assert set(got) == {k for k in want if k.startswith(ENCODER)}
            for k, g in got.items():
                tol = 0.1 if k.endswith("bias") else 2.0 ** -8
                assert rel_norm(g, want[k]) <= tol, k
            if cdt:  # the plain backward is the wrapper's on the CPU
                w = net.encoder_weights()
                ref = decima_node_encoder_bwd_ref(
                    tf.x.to(BF16), tf.adj, tf.node_level, tf.node_mask, w,
                    0, net.slope, torch.from_numpy(gh).to(BF16))
                names = [k for k, _ in net.named_parameters()
                         if k.startswith(ENCODER)]
                for k, r in zip(names, ref):
                    assert rel_norm(got[k], r) <= 2.0 ** -8, k
        else:
            flat = torch.cat([g.reshape(-1) for g in got.values()])
            ref = torch.cat([torch.as_tensor(want[k]).reshape(-1)
                             for k in got])
            assert rel_norm(flat, ref) <= (BF16_UPDATE_REL if cdt else 1e-4)
    a = torch.cat([g.reshape(-1) for g in grads["bfloat16"].values()])
    b = torch.cat([g.reshape(-1) for g in grads[None].values()])
    assert rel_norm(a, b) > 1e-3


@functools.lru_cache(maxsize=None)
def _jax_rollout(trainer_cls: str):
    cfg = mini_train_cfg(trainer_cls=trainer_cls, opt_kwargs=LINEAR_ADAM)
    cfg["agent"]["compute_dtype"] = "bfloat16"
    jt = jax_make_trainer(cfg)
    jt.scheduler.params = jax.tree_util.tree_map(lambda a: a * 0.3,
                                                 jt.scheduler.params)
    st = jt.init_state()
    rng = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    ro, _, _ = jt._collect_jit(st.params, st.iteration, rng, None)
    st2, _ = jax.jit(jt._update)(st.replace(rng=rng), ro)
    return cfg, jt.scheduler.params, rng, ro, st2.params


@pytest.mark.parametrize("trainer_cls", ["PPO", "VPG"])
def test_update_matches_jax_bf16(trainer_cls):
    cfg, params, rng, jro, jp2 = _jax_rollout(trainer_cls)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jp2))
    changes = {}
    for cdt in (None, "bfloat16"):
        c = dict(cfg, agent=dict(cfg["agent"], compute_dtype=cdt))
        tt = make_trainer(c, device="cpu")
        tt.scheduler.load_params(params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        st = tt.init_state()
        st.rng = torch.from_numpy(np.asarray(rng).astype(np.int64))
        p0 = {k: v.detach().clone() for k, v in st.params.items()}
        st, _ = tt._update(st, port_rollout_from_jax(jro))
        assert all(v.dtype == torch.float32 for v in st.params.values())
        changes[cdt] = torch.cat([(v.detach() - p0[k]).reshape(-1)
                                  for k, v in st.params.items()])
        names = list(st.params)
    ref = torch.cat([(want[k] - p0[k]).reshape(-1) for k in names])
    assert rel_norm(changes["bfloat16"], ref) <= BF16_UPDATE_REL
    assert rel_norm(changes["bfloat16"], changes[None]) > 1e-3


def test_params_stay_f32_and_jax_bf16_params_load():
    js, ts = _pair("bfloat16")
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    for k, v in ts.net.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k
    w = ts.net.encoder_weights()
    assert w.packed.dtype == BF16 and w.packed.numel() % 8 == 0
    assert all(t.dtype == torch.float32 for ls in (w.prep, w.msg, w.update)
               for pair in ls for t in pair)
    with pytest.raises(NotImplementedError, match="'float16'"):
        DecimaScheduler(**KW, compute_dtype="float16", device="cpu")


def test_wrappers_take_only_their_dtype():
    x, adj, lvl, mask = (torch.from_numpy(a) for a in
                         make_case("dag", 2, 3, 20, 5, seed=0))
    gen = torch.Generator().manual_seed(0)
    layers = [[(torch.randn(o, i, generator=gen), torch.randn(o, generator=gen))
               for i, o in zip(d[:-1], d[1:])]
              for d in ([5, 16, 8], [8, 16, 8], [8, 16, 8])]
    w32, w16 = pack_weights(*layers), pack_weights(*layers, dtype=BF16)
    xb = x.to(BF16)
    for fn, xx, w in ((decima_node_encoder, xb, w32),
                      (decima_node_encoder, x, w16),
                      (decima_node_encoder_bf16, x, w16),
                      (decima_node_encoder_bf16, xb, w32)):
        with pytest.raises(ValueError):
            fn(xx, adj, lvl, mask, w, 0, 0.2)
    with pytest.raises(ValueError, match="grad_h"):
        decima_node_encoder_bwd_bf16(xb, adj, lvl, mask, w16, 0, 0.2,
                                     torch.zeros(2, 3, 20, 8))
    before = decima_node_encoder_bf16.plain_calls
    out = decima_node_encoder_bf16(xb, adj, lvl, mask, w16, 0, 0.2)
    assert out.dtype == BF16
    assert decima_node_encoder_bf16.plain_calls == before + 1


SHIM = r"""
#include <cstdlib>
#include "encoder_bf16.cuh"
static unsigned char* carve(const EncDims& d, bool bwd, EncSm* s) {
  size_t n = (enc_carve(d, bwd, nullptr, nullptr) + 15) / 16 * 16;
  unsigned char* base = (unsigned char*)aligned_alloc(16, n);
  enc_carve(d, bwd, base, s);
  return base;
}
extern "C" int enc_fwd(const uint16_t* x, const uint8_t* adj,
                       const int32_t* lvl, const uint8_t* mask,
                       const uint8_t* el, const uint16_t* W, uint16_t* out,
                       int B, int K, int S, int F, int D, int nl,
                       float slope, const int* spec) {
  EncDims d;
  if (enc_dims(&d, spec, B, K, S, F, D, nl, slope)) return -1;
  EncSm s;
  unsigned char* base = carve(d, false, &s);
  const Blk b{0, 1};
  enc_load_weights(b, d, W, s);
  for (long j = 0; j < (long)B * K; ++j)
    enc_forward_job(b, d, s, j, x, adj, lvl, mask, el, out);
  free(base);
  return 0;
}
extern "C" int enc_bwd(const uint16_t* x, const uint8_t* adj,
                       const int32_t* lvl, const uint8_t* mask,
                       const uint8_t* el, const uint16_t* W,
                       const uint16_t* gh, float* grad, int B, int K, int S,
                       int F, int D, int nl, float slope, const int* spec) {
  EncDims d;
  if (enc_dims(&d, spec, B, K, S, F, D, nl, slope)) return -1;
  EncSm s;
  unsigned char* base = carve(d, true, &s);
  const Blk b{0, 1};
  enc_load_weights(b, d, W, s);
  for (int i = 0; i < d.wtotal; ++i) s.acc[i] = 0.f;
  for (long j = 0; j < (long)B * K; ++j)
    enc_backward_job(b, d, s, j, x, adj, lvl, mask, el, gh);
  for (int i = 0; i < d.wtotal; ++i) grad[i] = s.acc[i];
  free(base);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """`csrc/encoder_bf16.cuh` built with g++ behind SHIM."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernels' arithmetic for this test"
    d = tmp_path_factory.mktemp("enc_bf16")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libenc_bf16.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{build.CSRC}", str(d / "shim.cpp"), "-o",
                    str(lib)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _layers(gen, dims):
    return [(torch.randn(o, i, generator=gen) * i ** -0.5,
             torch.randn(o, generator=gen) * 0.1)
            for i, o in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("num_levels,slope", [(0, 0.2), (3, 0.01)])
@pytest.mark.parametrize("case", CASES)
def test_host_built_kernels_match_plain_versions(host_kernels, case,
                                                 num_levels, slope):
    b, k, s = 3, 7, 20
    x, adj, lvl, mask = (torch.from_numpy(a) for a in
                         make_case(case, b, k, s, 5, seed=num_levels))
    adj[0] = False  # an edgeless lane beside edged ones
    gen = torch.Generator().manual_seed(7)
    w = pack_weights(_layers(gen, [5, 32, 16, 16]),
                     _layers(gen, [16, 32, 16, 16]),
                     _layers(gen, [16, 32, 16, 16]), dtype=BF16)
    xb = x.to(BF16)
    g = torch.randn(b, k, s, 16, generator=gen).to(BF16)
    el = edgeless_per_lane(adj).contiguous()
    nl = min(num_levels, s) if num_levels else s
    p = ctypes.c_void_p
    common = (p(xb.data_ptr()), p(adj.data_ptr()), p(lvl.data_ptr()),
              p(mask.data_ptr()), p(el.data_ptr()), p(w.packed.data_ptr()))
    dims = (b, k, s, 5, 16, nl, ctypes.c_float(act_slope(slope, BF16)),
            w.spec.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    out = torch.empty(b, k, s, 16, dtype=BF16)
    assert host_kernels.enc_fwd(*common, p(out.data_ptr()), *dims) == 0
    ref = decima_node_encoder_ref(xb, adj, lvl, mask, w, num_levels, slope)
    assert bf16_ulps(out, ref) <= BF16_FWD_ULPS
    assert float((out == ref).float().mean()) >= BF16_FWD_EQUAL
    grad = torch.empty(w.packed.numel(), dtype=torch.float32)
    assert host_kernels.enc_bwd(*common, p(g.data_ptr()),
                                p(grad.data_ptr()), *dims) == 0
    gref = decima_node_encoder_bwd_ref(xb, adj, lvl, mask, w, num_levels,
                                       slope, g)
    for a, r in zip(unpack_grad(w, grad), gref):
        assert rel_norm(a, r) <= BF16_BWD_REL
