"""The port's key paths against chained jax.random.split / fold_in.

- `csrc/prng_core.cuh`'s path body (`threefry_path_item`, the one body
  of the threefry kernel), built with g++ through a C shim, and the
  plain `prng.derive`: paths of depth 1 to 3 under both impls, counters
  near 2^32 - 1, the call's varying counter, root rows read through a
  stride, the draw modes at the end of a path, and a path with no hop.
- Each call site that derives its key chain in one launch, against the
  JAX package's chain (`sparksched_tpu/trainers/rollout.py`,
  `trainer.py`, `ppo.py`, `serve/aot.py`): three collector rows at
  B = 16, `Trainer.lane_keys` at G = R = 4, `PPO.minibatch_indices` at
  E = 3, B = 16, T = 128, and a served `decide_batch` with padded slots.
- The site counts on CPU tensors: a collection row costs one call of
  the wrapper under rbg, a greedy served `decide_batch` at most two.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparksched_tpu_torch import prng
from sparksched_tpu_torch.kernels import build
from sparksched_tpu_torch.kernels.threefry import (
    PATH_END,
    PATH_VAR,
    path_table,
    threefry2x32,
    threefry2x32_keys_ref,
)

from ._torch_parity import one_torch_thread  # noqa: F401  (autouse)

U32 = np.uint32
SHIM = r"""
#include "prng_core.cuh"
using namespace prng_core;
extern "C" void shim_paths(const int64_t* roots, long long root_stride,
                           long long num_roots, int halves,
                           const int64_t* paths, int depth,
                           long long num_paths, unsigned long long var,
                           long long n, int mode, void* out) {
  for (long long t = 0; t < num_roots * num_paths * n * halves; ++t)
    threefry_path_item(roots, root_stride, halves, paths, depth, num_paths,
                       var, n, mode, t, out);
}
"""
MODE = {"pair": 0, "bits": 1, "uniform": 2}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The path body behind the C shim, built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: prng_core.cuh's host build needs it")
    d = tmp_path_factory.mktemp("key_paths")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libkey_paths.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-I", build.CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.shim_paths.argtypes = [vp, ll, ll, ci, vp, ci, ll, ctypes.c_ulonglong,
                              ll, ci, vp]
    return so


def core_paths(core, roots: np.ndarray, table: torch.Tensor, n: int = 1,
               mode: str = "pair", var: int = 0, row_stride: int = 0):
    """The kernel's items over `roots` [R, W] (read from rows of
    `row_stride` words, the others garbage) and `table` [..., D]."""
    r, w = roots.shape
    stride = row_stride or w
    rows = np.full((r, stride), -7, np.int64)
    rows[:, :w] = roots
    tab = np.ascontiguousarray(table.reshape(-1, table.shape[-1]).numpy())
    out_w = w if mode == "pair" else 1
    out = np.empty((r, tab.shape[0], n, out_w),
                   np.float32 if mode == "uniform" else np.int64)
    core.shim_paths(rows.ctypes.data, stride, r, w // 2, tab.ctypes.data,
                    tab.shape[1], tab.shape[0], var, n, MODE[mode],
                    out.ctypes.data)
    out = out.reshape((r,) + tuple(table.shape[:-1]) + (n, out_w))
    return out if mode == "pair" else out[..., 0]


def _keys(rs, k: int, words: int) -> np.ndarray:
    return rs.integers(0, 2**32, (k, words), dtype=np.uint64).astype(U32)


def _jkeys(keys: np.ndarray):
    impl = "rbg" if keys.shape[-1] == 4 else "threefry2x32"
    return jax.random.wrap_key_data(jnp.asarray(keys), impl=impl)


def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# each path as (table row, the jax chain it stands for); V = 777 is `var`
V = 777
TOP = 2**32 - 1
PATHS = [
    ((0,), lambda k: jax.random.split(k, 4)[0]),
    ((5,), lambda k: jax.random.fold_in(k, 5)),
    ((TOP,), lambda k: jax.random.fold_in(k, TOP)),
    ((PATH_VAR,), lambda k: jax.random.fold_in(k, V)),
    ((1, 6), lambda k: jax.random.split(jax.random.split(k, 4)[1], 8)[6]),
    ((TOP, TOP - 1), lambda k: jax.random.fold_in(
        jax.random.fold_in(k, TOP), TOP - 1)),
    ((PATH_VAR, 1), lambda k: jax.random.split(jax.random.fold_in(k, V))[1]),
    ((1, 3, 0), lambda k: jax.random.split(
        jax.random.split(jax.random.split(k, 4)[1], 16)[3])[0]),
    ((13, 2, 15), lambda k: jax.random.fold_in(
        jax.random.split(jax.random.fold_in(k, 13), 3)[2], 15)),
    ((PATH_VAR, 1, TOP - 2), lambda k: jax.random.fold_in(
        jax.random.split(jax.random.fold_in(k, V))[1], TOP - 2)),
]


def _want(keys: np.ndarray) -> np.ndarray:
    """[R, len(PATHS), W]: every path's jax chain from every key."""
    jk = _jkeys(keys)
    return np.stack([_data(jax.vmap(f)(jk)) for _, f in PATHS], 1)


@pytest.mark.parametrize("words", [2, 4])
def test_core_and_plain_paths_match_jax_chains(core, words):
    rs = np.random.default_rng(100 + words)
    keys = _keys(rs, 64, words)
    want = _want(keys)
    table = path_table([p for p, _ in PATHS], "cpu")
    assert table.shape == (len(PATHS), 3)
    assert int((table == PATH_END).sum()) == 2 * 4 + 3
    for stride in (0, 2 * words + 3):
        got = core_paths(core, keys, table, var=V, row_stride=stride)
        assert np.array_equal(got[:, :, 0], want)
    # the plain derive on CPU keys read through a row stride, and the
    # table's leading shape in the output's
    buf = torch.from_numpy(rs.integers(0, 2**32, (64, 3, words)).astype(
        np.int64))
    buf[:, 2] = _t(keys)
    roots = buf[:, 2]
    assert not roots.is_contiguous()
    plain0 = threefry2x32.plain_calls
    got = prng.derive(roots, table, var=V)
    assert threefry2x32.plain_calls - plain0 == 1
    assert torch.equal(got, _t(want))
    # the varying counter is a fold_in datum: its low 32 bits
    assert torch.equal(prng.derive(roots, table, var=V + 2**32), got)
    shaped = path_table([p for p, _ in PATHS], "cpu", (2, 5))
    got = prng.derive(roots.reshape(8, 8, words), shaped, var=V)
    assert torch.equal(got, _t(want).reshape(8, 8, 2, 5, words))


def test_draws_at_the_end_of_a_path(core):
    """bits / uniform at n counters from a path's last hop: jax.random's
    draws from the key the path's other hops make."""
    rs = np.random.default_rng(7)
    keys = _keys(rs, 40, 2)
    jk = _jkeys(keys)
    table = path_table([(1, 0), (PATH_VAR, 0), (0,)], "cpu")
    heads = [lambda k: jax.random.split(k, 4)[1],
             lambda k: jax.random.fold_in(k, V),
             lambda k: k]
    for mode, draw in (("bits", lambda k: jax.random.bits(k, (37,))),
                       ("uniform", lambda k: jax.random.uniform(k, (37,)))):
        want = np.stack([np.asarray(jax.vmap(lambda k: draw(h(k)))(jk))
                         for h in heads], 1)
        got = core_paths(core, keys, table, 37, mode, V)
        plain = threefry2x32_keys_ref(_t(keys), 37, V, mode, table)
        if mode == "bits":
            want = want.astype(np.int64)
            assert torch.equal(plain, torch.from_numpy(want))
        else:
            assert np.array_equal(plain.numpy(), want)
        assert np.array_equal(got, want)
    # split's fan-out at the end of a path: (1, 5..7) = split(split(k,
    # 4)[1], 8)[5:8]
    got = core_paths(core, keys, path_table([(1, 5)], "cpu"), 3, "pair")
    want = _data(jax.vmap(lambda k: jax.random.split(
        jax.random.split(k, 4)[1], 8)[5:8])(jk))
    assert np.array_equal(got[:, 0], want)


@pytest.mark.parametrize("words", [2, 4])
def test_a_path_of_no_hop_keeps_its_root(core, words):
    keys = _keys(np.random.default_rng(words), 5, words)
    table = torch.tensor([[PATH_END, 3], [4, PATH_END]])
    got = core_paths(core, keys, table)
    plain = threefry2x32_keys_ref(_t(keys), 1, 0, "pair", table)
    assert np.array_equal(got, plain.numpy())
    assert np.array_equal(got[:, 0, 0], keys.astype(np.int64))
    assert np.array_equal(got[:, 1, 0], _data(jax.vmap(
        lambda k: jax.random.fold_in(k, 4))(_jkeys(keys))))


def test_path_tables_refuse_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="hops"):
        path_table([(1,), ()], "cpu")
    with pytest.raises(ValueError, match="hops"):
        path_table([tuple(range(9))], "cpu")
    with pytest.raises(ValueError, match="counter"):
        path_table([(2**32,)], "cpu")
    with pytest.raises(ValueError, match="counter"):
        path_table([(-3,)], "cpu")
    key = prng.PRNGKey(1)
    with pytest.raises(ValueError, match="path table"):
        prng.derive(key, torch.zeros(2, 9, dtype=torch.int64))
    with pytest.raises(ValueError, match="path table"):
        prng.derive(key, torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="path table"):
        prng.derive(key, torch.zeros(2, 2, dtype=torch.int64).to("meta"))


# --- the call sites ---------------------------------------------------------


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_collector_rows_match_jax(impl):
    """Three rows of `collect_flat_sync_batch`'s chain (JAX: `k, k_pol,
    k_dec, k_drain = split(k, 4)`, the policy's `split(k_pol, B)` and
    each lane's `split`, `split(k_dec, B)`, `split(k_drain, B)`)."""
    from sparksched_tpu_torch.trainers.rollout import row_paths

    B = 16
    for split in (True, False):
        jk = jax.random.key(21, impl=impl)
        tk = _t(_data(jk))
        paths = row_paths(B, split, torch.device("cpu"))
        n_pol = 2 * B if split else 1
        for _ in range(3):
            jk, jpol, jdec, jdrain = jax.random.split(jk, 4)
            keys = prng.derive(tk, paths)
            tk = keys[0]
            assert torch.equal(tk, _t(_data(jk)))
            if split:
                lanes = jax.vmap(jax.random.split)(jax.random.split(jpol, B))
                assert torch.equal(keys[1:1 + n_pol].unflatten(0, (B, 2)),
                                   _t(_data(lanes)))
            else:
                assert torch.equal(keys[1], _t(_data(jpol)))
            assert torch.equal(keys[1 + n_pol:1 + n_pol + B],
                               _t(_data(jax.random.split(jdec, B))))
            assert torch.equal(keys[1 + n_pol + B:],
                               _t(_data(jax.random.split(jdrain, B))))


@pytest.mark.parametrize("fixed", [False, True])
def test_lane_keys_match_jax(fixed):
    """`Trainer.lane_keys` at G = R = 4 against the JAX trainer's
    `seq_key(g, iteration)` and `fold_in(seq, 1000 + r)`, both impls."""
    from sparksched_tpu_torch.trainers.trainer import Trainer

    G = R = 4
    for impl in ("threefry2x32", "rbg"):
        tr = types.SimpleNamespace(
            fixed_sequences=fixed, num_sequences=G, num_rollouts=R,
            device="cpu", seed_key=lambda impl=impl: prng.PRNGKey(
                42, "cpu", impl=impl))
        master = jax.random.key(42, impl=impl)
        for iteration in (0, 3, 2**31 + 5):
            seq, lane = Trainer.lane_keys(tr, iteration)
            it = 0 if fixed else iteration
            g_ids = jnp.repeat(jnp.arange(G), R)
            r_ids = jnp.tile(jnp.arange(R), G)
            js = jax.vmap(lambda g, it=it: jax.random.fold_in(
                jax.random.fold_in(master, g), it))(g_ids)
            jl = jax.vmap(lambda s, r: jax.random.fold_in(s, 1000 + r))(
                js, r_ids)
            assert torch.equal(seq, _t(_data(js)))
            assert torch.equal(lane, _t(_data(jl)))


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_minibatch_indices_match_jax(impl):
    """`PPO.minibatch_indices` at E = 3, B = 16, T = 128 against the JAX
    update's (`sparksched_tpu/trainers/ppo.py`: `split(fold_in(rng, 13),
    E)`, each epoch key folded over the lanes, a permutation each)."""
    from sparksched_tpu_torch.trainers.ppo import PPO

    E, B, T, nb = 3, 16, 128, 10
    jrng = jax.random.fold_in(jax.random.key(9, impl=impl), 4)
    ppo = types.SimpleNamespace(num_epochs=E, num_batches=nb)
    mb_idx, mb_ok = PPO.minibatch_indices(ppo, _t(_data(jrng)), B, T)
    ep_keys = jax.random.split(jax.random.fold_in(jrng, 13), E)
    lane_keys = jax.vmap(lambda ek: jax.vmap(
        lambda b: jax.random.fold_in(ek, b))(jnp.arange(B)))(ep_keys)
    perms = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.permutation(k, T)))(lane_keys))
    mbs = -(-T // nb)
    perms = np.concatenate([perms, np.zeros((E, B, nb * mbs - T),
                                            np.int32)], -1)
    want = perms.reshape(E, B, nb, mbs).transpose(0, 2, 1, 3).reshape(
        E * nb, B, mbs)
    assert np.array_equal(mb_idx.numpy(), want)
    assert mb_ok.shape == (E * nb, mbs)


@pytest.fixture(scope="module")
def served():
    """A port store of 6 slots, max_batch 4 (the serving tests' small
    setup), with 4 sessions."""
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.serve import SessionStore
    from sparksched_tpu_torch.workload import make_workload_bank

    from ._torch_parity import MINI_AGENT

    tb = make_workload_bank(5, 20, device="cpu")
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=tb.max_stages,
                   max_levels=tb.max_stages)
    ts = DecimaScheduler(num_executors=5, job_bucket=4, device="cpu",
                         **MINI_AGENT)
    store = SessionStore(tp, tb, ts, capacity=6, max_batch=4, seed=3,
                         device="cpu")
    sids = [store.create() for _ in range(4)]
    return store, sids


def test_served_keys_match_jax(served, monkeypatch):
    """The policy and engine keys a served call hands the decision (JAX:
    `split(fold_in(base, call))`, a batch's lanes the K-way split of
    each, taken at the real slots' positions), padded slots in the
    middle of a batch and at its end; a greedy `decide_batch` costs at
    most two calls of the wrapper."""
    from sparksched_tpu_torch.serve import aot

    store, sids = served
    seen = []
    orig = aot._decide

    def spy(params, bank, policy_fn, ls, k_pol, k_env, *a, **k):
        seen.append((k_pol.clone(), k_env.clone()))
        return orig(params, bank, policy_fn, ls, k_pol, k_env, *a, **k)

    monkeypatch.setattr(aot, "_decide", spy)
    base = jax.random.PRNGKey(3)
    K = store.max_batch

    def want(call, pos):
        kp, ke = jax.random.split(jax.random.fold_in(base, call))
        if pos is None:
            return _data(kp)[None], _data(ke)[None]
        return (_data(jax.random.split(kp, K))[pos],
                _data(jax.random.split(ke, K))[pos])

    plain0 = threefry2x32.plain_calls
    store.decide_batch(sids[:3])  # one padded slot at the end
    assert threefry2x32.plain_calls - plain0 <= 2
    call = store._calls
    for got, w in zip(seen.pop(), want(call, [0, 1, 2])):
        assert torch.equal(got, _t(w))
    store.decide(sids[3])
    for got, w in zip(seen.pop(), want(store._calls, None)):
        assert torch.equal(got, _t(w))
    # padding in the middle: the program itself, slots [C, s0, C, s1]
    C = store.group_slots
    slots = torch.tensor([C, 0, C, 1])
    store._decidek(store._stores[0], slots, store._base_key, 11)
    for got, w in zip(seen.pop(), want(11, [1, 3])):
        assert torch.equal(got, _t(w))


def test_collection_rows_cost_one_launch_each_under_rbg():
    """N rows of a collection call the wrapper N times under rbg (the
    row's one `derive`; the heads' Gumbel draws are rbg draws), and the
    rollout equals the one whose policy splits its key itself."""
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.env import core
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.trainers import rollout as tro
    from sparksched_tpu_torch.workload import make_workload_bank

    from ._torch_parity import MINI_AGENT

    tb = make_workload_bank(5, 20, device="cpu")
    tp = EnvParams(num_executors=5, max_jobs=6, max_stages=tb.max_stages,
                   max_levels=tb.max_stages, mean_time_limit=2e7)
    ts = DecimaScheduler(num_executors=5, job_bucket=3, device="cpu",
                         **MINI_AGENT)
    lanes = 4
    master = prng.PRNGKey(5, impl="rbg")
    seq = prng.split(master, lanes)
    key = prng.fold_in(master, 7)
    runs = {}
    for split_keys in (True, False):
        states = core.reset_pair(tp, tb, seq, prng.fold_in(seq, 1000))
        counts = {}
        plain0 = threefry2x32.plain_calls
        runs[split_keys] = tro.collect_flat_sync_batch(
            tp, tb, ts.lane_policy if split_keys else ts.batch_policy, key,
            24, states, counts=counts, split_policy_keys=split_keys)
        calls = threefry2x32.plain_calls - plain0
        if split_keys:
            assert counts["rows"] > 3
            assert calls == counts["rows"]
        else:  # the policy's split of the key and each lane's split
            assert calls == 3 * counts["rows"]
    for f in ("stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
              "valid", "wall_times"):
        assert torch.equal(getattr(runs[True], f), getattr(runs[False], f)), f
