"""The port's CUDA kernels against their plain versions on the card
(needs an NVIDIA card; skips elsewhere), on random DAGs and on the
seeded adversarial inputs of `make_case` (`tests/_torch_parity.py`),
from a single job to more blocks than the card holds at once: the
NodeEncoder within 1e-5, its backward within 1e-4 * max|ref| + 1e-6 per
gradient tensor against the plain backward evaluated in float64 (at
these random weights and 1,603 jobs the kernel and the float32 plain
backward disagreed, and the float64 evaluation sided with the kernel)
and bit-equal from run to run, up to [1024, 200] jobs half of them dead;
an all-dead batch gives exactly 0. Model files and train states on the
card: the JAX package's trained `model_tpu.msgpack` loaded through the
port's codec gives the CPU's parameters and, on observations of a
held-out episode, the CPU's scores within 1e-4 relative to their scale;
a train state saved by a card trainer after one iteration loads into a
fresh card trainer with every byte equal and Adam's moments on the
card. The paged, grouped session store on the card: the page round trip
through pinned host memory bit-exact, the in-flight window equal to
`decide_batch` bit for bit, and the CPU store's decisions. The rbg
Philox kernel bit-equal to its plain version on 2,048 keys at odd counts
(counters that carry and wrap among them), as words and as uniforms,
and over key batches (one stream of the batch's first key). Run
there with `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(`--noconftest`: the suite's conftest imports JAX, which the card's
machine need not have)."""

from __future__ import annotations

import pytest
import torch

from sparksched_tpu_torch.kernels.decima_encoder import (
    BF16,
    DecimaNodeEncoderFn,
    decima_node_encoder,
    decima_node_encoder_bf16,
    decima_node_encoder_bwd,
    decima_node_encoder_bwd_bf16,
    decima_node_encoder_bwd_ref,
    decima_node_encoder_ref,
    encoder_params,
    pack_weights,
)

from ._torch_parity import (
    BF16_BWD_REL,
    BF16_FWD_EQUAL,
    BF16_FWD_ULPS,
    CASES,
    bf16_ulps,
    bwd_ref64,
    bwd_ref64_pinned,
    make_case,
    rel_norm,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layers(gen, dims, dev):
    return [(torch.randn(o, i, generator=gen).to(dev) * i ** -0.5,
             torch.randn(o, generator=gen).to(dev) * 0.1)
            for i, o in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("b,k,s", [(1, 1, 3), (3, 5, 20), (8, 32, 20)])
def test_kernel_matches_plain_version(card, b, k, s):
    gen = torch.Generator().manual_seed(b * 100 + k)
    d = 16
    x = torch.randn(b, k, s, 5, generator=gen).to(card)
    adj = torch.triu(torch.rand(b, k, s, s, generator=gen) < 0.2, 1)
    adj[0] = False  # lane 0 edgeless, the rest edged
    lvl = torch.zeros(b, k, s, dtype=torch.int32)
    for c in range(s):  # topological generation: 1 + deepest parent
        par = adj[..., :, c].float() * (lvl.float() + 1)
        lvl[..., c] = par.amax(-1).int()
    mask = torch.rand(b, k, s, generator=gen) < 0.9
    w = pack_weights(_layers(gen, [5, 32, 16, d], card),
                     _layers(gen, [d, 32, 16, d], card),
                     _layers(gen, [d, 32, 16, d], card))
    args = (w, 0, 0.2)
    ins = (x, adj.to(card), lvl.to(card), mask.to(card))
    before = decima_node_encoder.launches
    out = decima_node_encoder(*ins, *args)
    torch.cuda.synchronize()
    assert decima_node_encoder.launches == before + 1
    ref = decima_node_encoder_ref(*ins, *args)
    assert float((out - ref).abs().max()) <= 1e-5


# B*K = 1 and 3 (fewer jobs than SMs), 256 (the serve shape), 258 and
# 1603 (more blocks than an H100 holds at once)
SHAPES = [(1, 1), (1, 3), (8, 32), (3, 86), (7, 229)]


@pytest.mark.parametrize("num_levels", [0, 3])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,k", SHAPES)
def test_kernel_matches_plain_version_on_adversarial_cases(card, b, k, case,
                                                           num_levels):
    x, adj, lvl, mask = make_case(case, b, k, 20, 5, seed=b * 1000 + k)
    if b > 1:
        adj[0] = False  # an edgeless lane beside edged ones
    gen = torch.Generator().manual_seed(7)
    w = pack_weights(_layers(gen, [5, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card))
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    out = decima_node_encoder(*ins, w, num_levels, 0.2)
    torch.cuda.synchronize()
    ref = decima_node_encoder_ref(*ins, w, num_levels, 0.2)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("dims,s", [
    (([5, 16, 8, 8], [8, 16, 8, 8], [8, 16, 8, 8]), 20),  # embed 8, hid [16, 8]
    (([5, 24, 12], [12, 40, 12], [12, 12]), 32),  # a 40-wide layer, 32 slots
])
def test_kernel_matches_plain_version_at_other_widths(card, dims, s):
    """Widths outside the repo's configurations run the kernel's
    runtime-width layers; S = 32 fills the warp."""
    x, adj, lvl, mask = make_case("random_levels", 3, 7, s, 5, seed=s)
    adj[0] = False
    gen = torch.Generator().manual_seed(s)
    w = pack_weights(*(_layers(gen, d, card) for d in dims))
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    for num_levels in (0, 3):
        out = decima_node_encoder(*ins, w, num_levels, 0.2)
        torch.cuda.synchronize()
        ref = decima_node_encoder_ref(*ins, w, num_levels, 0.2)
        assert float((out - ref).abs().max()) <= 1e-5


def test_kernel_refuses_more_than_32_slots(card):
    x, adj, lvl, mask = make_case("dag", 1, 2, 33, 5, seed=0)
    gen = torch.Generator().manual_seed(0)
    w = pack_weights(_layers(gen, [5, 16], card), _layers(gen, [16, 16], card),
                     _layers(gen, [16, 16], card))
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    with pytest.raises(ValueError, match="32 stage slots"):
        decima_node_encoder(*ins, w, 0, 0.2)


def _grad_err(got, ref) -> float:
    """The worst error of any gradient tensor over its tolerance."""
    return max(float((a - b).abs().max()) / (1e-4 * float(b.abs().max())
                                             + 1e-6)
               for a, b in zip(got, ref))


@pytest.mark.parametrize("num_levels", [0, 3])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,k", SHAPES)
def test_bwd_kernel_matches_plain_version_on_adversarial_cases(
        card, b, k, case, num_levels):
    x, adj, lvl, mask = make_case(case, b, k, 20, 5, seed=b * 1000 + k)
    if b > 1:
        adj[0] = False  # an edgeless lane beside edged ones
    gen = torch.Generator().manual_seed(7)
    w = pack_weights(_layers(gen, [5, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card))
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    g = torch.randn(b, k, 20, 16, generator=gen).to(card)
    before = decima_node_encoder_bwd.launches
    got = decima_node_encoder_bwd(*ins, w, num_levels, 0.2, g)
    torch.cuda.synchronize()
    assert decima_node_encoder_bwd.launches == before + 1
    ref = bwd_ref64(*ins, w, num_levels, 0.2, g)
    assert _grad_err(got, ref) <= 1.0
    again = decima_node_encoder_bwd(*ins, w, num_levels, 0.2, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dims,s", [
    (([5, 16, 8, 8], [8, 16, 8, 8], [8, 16, 8, 8]), 20),  # embed 8, hid [16, 8]
    (([5, 24, 12], [12, 40, 12], [12, 12]), 32),  # a 40-wide layer, 32 slots
    (([5, 16], [16, 16], [16, 16]), 3),  # one-layer MLPs, 3 slots
])
def test_bwd_kernel_matches_plain_version_at_other_widths(card, dims, s):
    """Widths outside the repo's configurations: the padded layouts, a
    one-layer update MLP (its aggregation kept in the hidden buffer), S
    not a multiple of 4 (the adjacency read a byte at a time)."""
    x, adj, lvl, mask = make_case("random_levels", 3, 7, s, 5, seed=s)
    adj[0] = False
    gen = torch.Generator().manual_seed(s)
    w = pack_weights(*(_layers(gen, d, card) for d in dims))
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    g = torch.randn(3, 7, s, dims[0][-1], generator=gen).to(card)
    for num_levels in (0, 3):
        got = decima_node_encoder_bwd(*ins, w, num_levels, 0.2, g)
        torch.cuda.synchronize()
        ref = bwd_ref64(*ins, w, num_levels, 0.2, g)
        assert _grad_err(got, ref) <= 1.0


def _flagship_weights(card):
    gen = torch.Generator().manual_seed(7)
    return gen, pack_weights(_layers(gen, [5, 32, 16, 16], card),
                             _layers(gen, [16, 32, 16, 16], card),
                             _layers(gen, [16, 32, 16, 16], card))


def test_bwd_kernel_at_the_update_chunk_with_dead_jobs(card):
    """[1024, 200] jobs, every other one dead (the live list compacts
    102,400 jobs, each of the card's warps takes dozens): within
    tolerance of the float64 plain backward on the kernel's LeakyReLU
    branches (`bwd_ref64_pinned`, 64 items at a time), and a rerun gives
    the same bits. Against the plain float64 backward on its own branches
    neither the kernel nor the float32 plain backward stays within the
    tolerance at this size: a few dozen of the ~3.5e8 pre-activations lie
    within float32 rounding of 0, and each that a float32 evaluation puts
    on the other branch moves a weight gradient by several times 1e-4 of
    its tensor's largest element."""
    x, adj, lvl, mask = make_case("dead_jobs", 1024, 200, 20, 5, seed=11)
    gen, w = _flagship_weights(card)
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    g = torch.randn(1024, 200, 20, 16, generator=gen).to(card)
    got = decima_node_encoder_bwd(*ins, w, 0, 0.2, g)
    torch.cuda.synchronize()
    ref = bwd_ref64_pinned(*ins, w, 0, 0.2, g, lanes=64)
    assert _grad_err(got, ref) <= 1.0
    again = decima_node_encoder_bwd(*ins, w, 0, 0.2, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_bwd_kernel_all_dead_batch_is_exactly_zero(card):
    """No job with a valid node (edges, NaN inputs and gradients kept):
    every gradient element is exactly 0."""
    x, adj, lvl, mask = make_case("dag", 8, 32, 20, 5, seed=1)
    mask[:] = False
    x[:] = float("nan")
    gen, w = _flagship_weights(card)
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    g = torch.full((8, 32, 20, 16), float("nan"), device=card)
    got = decima_node_encoder_bwd(*ins, w, 0, 0.2, g)
    torch.cuda.synchronize()
    assert all(bool((t == 0).all()) for t in got)


def test_encoder_function_gradients_on_card_match_cpu(card):
    """`DecimaNodeEncoderFn` on the card (both kernels) against the same
    function on the CPU (the plain versions under autograd)."""
    x, adj, lvl, mask = make_case("dag", 4, 9, 20, 5, seed=3)
    gen = torch.Generator().manual_seed(3)
    dims = ([5, 32, 16, 16], [16, 32, 16, 16], [16, 32, 16, 16])
    layers = [_layers(gen, d, "cpu") for d in dims]
    g = torch.randn(4, 9, 20, 16, generator=gen)
    grads = {}
    for dev in ("cpu", "cuda"):
        # detached copies: leaves on each device (`.to("cpu")` of a CPU
        # tensor would return the tensor itself, and its CUDA copy would then
        # be a non-leaf without a .grad)
        ls = [[(w.detach().to(dev).requires_grad_(True),
                b.detach().to(dev).requires_grad_(True))
               for w, b in mlp] for mlp in layers]
        w = pack_weights(*ls)
        ins = [torch.from_numpy(a).to(dev) for a in (x, adj, lvl, mask)]
        h = DecimaNodeEncoderFn.apply(*ins, w, 0, 0.2, *encoder_params(w))
        (h * g.to(dev)).sum().backward()
        grads[dev] = [p.grad.cpu() for p in encoder_params(w)]
    assert _grad_err(grads["cuda"], grads["cpu"]) <= 1.0


# The bf16 kernels against their plain versions evaluated on the CPU (the
# card's bf16 GEMMs may reduce in other orders), within the tolerances of
# `tests/_torch_parity.py` (BF16_FWD_ULPS, BF16_FWD_EQUAL, BF16_BWD_REL),
# and the backward bit-equal from run to run.


def _bf16_check(card, x, adj, lvl, mask, w, num_levels, g, lanes=None):
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    ins[0] = ins[0].to(BF16)
    cpu = [t.cpu() for t in ins]
    wc = pack_weights(*([(a.cpu(), b.cpu()) for a, b in ls]
                        for ls in (w.prep, w.msg, w.update)), dtype=BF16)
    f0, b0 = (decima_node_encoder_bf16.launches,
              decima_node_encoder_bwd_bf16.launches)
    out = decima_node_encoder_bf16(*ins, w, num_levels, 0.2)
    got = decima_node_encoder_bwd_bf16(*ins, w, num_levels, 0.2, g.to(card))
    torch.cuda.synchronize()
    assert decima_node_encoder_bf16.launches == f0 + 1
    assert decima_node_encoder_bwd_bf16.launches == b0 + 1
    ref = decima_node_encoder_ref(*cpu, wc, num_levels, 0.2)
    assert out.dtype == BF16 and bf16_ulps(out, ref) <= BF16_FWD_ULPS
    assert float((out.cpu() == ref).float().mean()) >= BF16_FWD_EQUAL
    step = lanes or x.shape[0]
    gref = None
    for i in range(0, x.shape[0], step):
        part = decima_node_encoder_bwd_ref(
            *(t[i:i + step] for t in cpu), wc, num_levels, 0.2,
            g[i:i + step].cpu())
        gref = part if gref is None else [a + b for a, b in zip(gref, part)]
    assert max(rel_norm(a, b) for a, b in zip(got, gref)) <= BF16_BWD_REL
    again = decima_node_encoder_bwd_bf16(*ins, w, num_levels, 0.2,
                                         g.to(card))
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("num_levels", [0, 3])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,k", [(1, 1), (3, 86), (8, 32)])
def test_bf16_kernels_match_plain_versions(card, b, k, case, num_levels):
    x, adj, lvl, mask = make_case(case, b, k, 20, 5, seed=b * 1000 + k)
    if b > 1:
        adj[0] = False  # an edgeless lane beside edged ones
    gen = torch.Generator().manual_seed(7)
    w = pack_weights(_layers(gen, [5, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card), dtype=BF16)
    g = torch.randn(b, k, 20, 16, generator=gen).to(BF16)
    _bf16_check(card, x, adj, lvl, mask, w, num_levels, g)


def test_bf16_kernels_at_the_update_chunk_with_dead_jobs(card):
    """[256, 200] jobs, every other one dead: the update chunk's shape."""
    x, adj, lvl, mask = make_case("dead_jobs", 256, 200, 20, 5, seed=11)
    gen = torch.Generator().manual_seed(7)
    w = pack_weights(_layers(gen, [5, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card),
                     _layers(gen, [16, 32, 16, 16], card), dtype=BF16)
    g = torch.randn(256, 200, 20, 16, generator=gen).to(BF16)
    _bf16_check(card, x, adj, lvl, mask, w, 0, g, lanes=32)


def test_bf16_and_f32_wrappers_take_only_their_dtype(card):
    """On the card a call launches the kernel of its dtype or raises: no
    bf16 work goes to the float32 kernel or a plain version."""
    x, adj, lvl, mask = make_case("dag", 2, 3, 20, 5, seed=0)
    gen = torch.Generator().manual_seed(0)
    dims = ([5, 32, 16, 16], [16, 32, 16, 16], [16, 32, 16, 16])
    layers = [_layers(gen, d, card) for d in dims]
    w32, w16 = pack_weights(*layers), pack_weights(*layers, dtype=BF16)
    ins = [torch.from_numpy(a).to(card) for a in (x, adj, lvl, mask)]
    xb = ins[0].to(BF16)
    before = (decima_node_encoder.launches, decima_node_encoder.plain_calls,
              decima_node_encoder_bf16.plain_calls)
    for fn, args in ((decima_node_encoder, (xb, *ins[1:], w32)),
                     (decima_node_encoder, (xb, *ins[1:], w16)),
                     (decima_node_encoder_bf16, (ins[0], *ins[1:], w16)),
                     (decima_node_encoder_bf16, (xb, *ins[1:], w32))):
        with pytest.raises(ValueError):
            fn(*args, 0, 0.2)
    g = torch.zeros(2, 3, 20, 16, device=card)
    with pytest.raises(ValueError):
        decima_node_encoder_bwd_bf16(xb, *ins[1:], w16, 0, 0.2, g)
    assert (decima_node_encoder.launches, decima_node_encoder.plain_calls,
            decima_node_encoder_bf16.plain_calls) == before


FLAGSHIP_AGENT = dict(
    embed_dim=16,
    gnn_mlp_kwargs={"hid_dims": [32, 16], "act_cls": "LeakyReLU",
                    "act_kwargs": {"negative_slope": 0.2}},
    policy_mlp_kwargs={"hid_dims": [64, 64], "act_cls": "Tanh"},
)


def test_model_file_loads_onto_the_card(card):
    import os

    from sparksched_tpu_torch import evaluate as ev
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.trainers.rollout import stored_to_observation

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "decima", "model_tpu.msgpack")
    on_card = DecimaScheduler(10, state_dict_path=path, device=card,
                              **FLAGSHIP_AGENT)
    on_cpu = DecimaScheduler(10, state_dict_path=path, device="cpu",
                             **FLAGSHIP_AGENT)
    for k, v in on_cpu.params.items():
        assert on_card.params[k].device.type == "cuda"
        assert torch.equal(on_card.params[k].cpu(), v), k
    params, bank = ev.eval_env("cpu")
    res = ev.evaluate(path, seeds=[ev.HELD_OUT_BASE], steps=40, device="cpu")
    ro = res["rollouts"]["decima"]
    so = ro.obs.map(lambda a: a[ro.valid])
    obs = stored_to_observation(bank, so)
    with torch.no_grad():
        want = on_cpu.score(on_cpu.features(obs))
        got = on_card.score(on_card.features(
            type(obs)(**{k: v.to(card) for k, v in vars(obs).items()})))
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max()) + 1e-6


def test_train_state_round_trip_on_the_card(card, tmp_path):
    from sparksched_tpu_torch.serialization import to_bytes
    from sparksched_tpu_torch.trainers import make_trainer

    from ._torch_parity import mini_train_cfg

    cfg = mini_train_cfg(num_iterations=1, rollout_steps=16,
                         num_sequences=1, artifacts_dir=str(tmp_path),
                         reward_buff_cap=100)
    del cfg["trainer"]["beta_discount"]
    trainer = make_trainer(cfg, device=card)
    state = trainer.train()
    fresh = make_trainer(cfg, device=card)
    restored = fresh.load_train_state(str(tmp_path / "train_state.msgpack"))
    assert restored.iteration == 1
    assert (to_bytes(fresh.train_state_tree(restored))
            == to_bytes(trainer.train_state_tree(state)))
    moments = restored.opt_state.opt.state
    assert moments and all(st["exp_avg"].device.type == "cuda"
                           for st in moments.values())
    assert restored.buf.dt.device.type == "cuda"


def _serve_stack(dev):
    from sparksched_tpu_torch.config import EnvParams
    from sparksched_tpu_torch.schedulers import DecimaScheduler
    from sparksched_tpu_torch.workload import make_workload_bank

    bank = make_workload_bank(5, device=dev)
    params = EnvParams(num_executors=5, max_jobs=6,
                       max_stages=bank.max_stages,
                       max_levels=bank.max_stages)
    sched = DecimaScheduler(5, embed_dim=8, gnn_mlp_kwargs={"hid_dims": [16]},
                            policy_mlp_kwargs={"hid_dims": [16]},
                            job_bucket=4, device=dev)
    sched.load_params({k: v.cpu() * 0.3 for k, v in sched.params.items()})
    return params, bank, sched


def test_paged_grouped_store_on_the_card(card):
    """The paged, grouped store on the card: a page-out through pinned
    host memory and back is bit-exact on every leaf, the in-flight
    window equals `decide_batch` bit for bit, and the decisions equal the
    CPU store's (integers equal, floats within 1e-5 relative)."""
    from sparksched_tpu_torch.serve import SessionStore

    from ._torch_parity import slot_bytes

    def store(dev):
        p, b, s = _serve_stack(dev)
        return SessionStore(p, b, s, capacity=8, hot_capacity=4, groups=2,
                            max_batch=2, seed=0, device=dev)

    gpu, twin, cpu = store("cuda"), store("cuda"), store("cpu")
    sids = [gpu.create(seed=10 + i) for i in range(8)]
    assert [twin.create(seed=10 + i) for i in range(8)] == sids
    assert [cpu.create(seed=10 + i) for i in range(8)] == sids
    sid = next(s for s in sids if gpu.is_hot(s))
    slot = int(gpu._slot_of[sid])
    g, local = divmod(slot, gpu.group_slots)
    before = slot_bytes(gpu._stores[g], local)
    gpu._page_out(slot)
    gpu._free_slots[g].append(slot)
    gpu._drain_writebacks(wait=True)
    assert gpu._cold[sid].dev is None
    assert slot_bytes(gpu._cold[sid].host, 0) == before
    [back] = gpu._ensure_hot([sid])
    g, local = divmod(back, gpu.group_slots)
    assert slot_bytes(gpu._stores[g], local) == before
    groups = [[s for s in sids if gpu.session_group(s) == g][:2]
              for g in (0, 1)]
    for _ in range(3):
        calls = [gpu.dispatch_batch(b) for b in groups]
        gpu.harvest(wait=True)
        want = [r for b in groups for r in twin.decide_batch(b)]
        host = [r for b in groups for r in cpu.decide_batch(b)]
        got = [r for c in calls for r in c.results]
        assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
        for a, b in zip(got, host):
            for k in ("stage_idx", "job_idx", "num_exec", "decided", "done",
                      "health_mask"):
                assert getattr(a, k) == getattr(b, k), k
            for k in ("lgprob", "reward", "dt", "wall_time"):
                assert getattr(a, k) == pytest.approx(getattr(b, k),
                                                      rel=1e-5, abs=1e-5)


def test_ring_append_on_the_card_matches_cpu(card):
    """The ring append on the card: masked-off lanes land in the sink row
    (no device-side assert), the cursor and every row bit-equal to the
    CPU's, across the wrap, with scalar and batch masks."""
    from sparksched_tpu_torch.env.flat_loop import make_ring, ring_append

    gen = torch.Generator().manual_seed(3)
    rings = {d: make_ring(5, {"a": torch.zeros((), dtype=torch.int32,
                                               device=d),
                              "b": torch.zeros(2, device=d)})
             for d in ("cpu", "cuda")}
    for k in range(12):
        n = () if k % 3 == 0 else (4,)
        recs = {"a": torch.randint(0, 99, n, generator=gen,
                                   dtype=torch.int32),
                "b": torch.randn(n + (2,), generator=gen)}
        mask = torch.rand(n, generator=gen) < 0.6
        for d, r in rings.items():
            ring_append(r, {x: v.to(d) for x, v in recs.items()}, mask.to(d))
    cpu, gpu = rings["cpu"], rings["cuda"]
    assert int(gpu.cursor) == int(cpu.cursor) > 5
    for x in ("a", "b"):
        assert torch.equal(gpu.rec[x][:5].cpu(), cpu.rec[x][:5])


def _ring_store(dev, ring, buf):
    from sparksched_tpu_torch.serve import SessionStore

    p, b, s = _serve_stack(dev)
    return SessionStore(p, b, s, capacity=8, hot_capacity=4, groups=2,
                        max_batch=2, seed=0, record=True, ring=ring,
                        collector=buf, device=dev)


def _drive_ring(st) -> None:
    sids = [st.create(seed=20 + i) for i in range(8)]
    groups = [[s for s in sids if st.session_group(s) == g][:2]
              for g in (0, 1)]
    for _ in range(4):
        for b in groups:
            st.dispatch_batch(b)
        st.harvest(wait=True)
    for s in sids:
        st.close(s)
    st.drain_ring(wait=True)


def test_ring_store_on_the_card(card):
    """The ring store on the card, driven through the in-flight window:
    its trajectories bit-equal to the card's per-decision record path,
    nothing dropped, and equal to the CPU ring store's (stamps, actions
    and records equal, the served floats within 1e-5 relative)."""
    from sparksched_tpu_torch.online import TrajectoryBuffer

    out = {}
    for dev, ring in (("cuda", 4), ("cuda", 0), ("cpu", 4)):
        buf = TrajectoryBuffer(capacity=64, max_steps=3, min_decisions=1)
        st = _ring_store(dev, ring, buf)
        _drive_ring(st)
        if ring:
            assert st.stats["serve_ring_dropped"] == 0
            assert st.stats["serve_ring_records"] > 2 * ring
        out[(dev, ring)] = sorted(buf.drain(10 ** 6), key=lambda t: (
            t.session_id, float(t.wall_times[0])))
    fields = ("stage_idx", "job_idx", "num_exec_k", "lgprob", "reward",
              "wall_times", "params_version")
    a, b, c = out[("cuda", 4)], out[("cuda", 0)], out[("cpu", 4)]
    assert len(a) == len(b) == len(c) > 0
    for x, y, z in zip(a, b, c):
        assert (x.session_id, x.length, x.done) == (y.session_id, y.length,
                                                    y.done)
        assert (x.session_id, x.length, x.done) == (z.session_id, z.length,
                                                    z.done)
        for f in fields:
            assert getattr(x, f).tobytes() == getattr(y, f).tobytes(), f
        for f in ("stage_idx", "job_idx", "num_exec_k", "params_version"):
            assert (getattr(x, f) == getattr(z, f)).all(), f
        for f in ("lgprob", "reward", "wall_times"):
            assert getattr(x, f) == pytest.approx(getattr(z, f), rel=1e-5,
                                                  abs=1e-5), f
        for f in vars(x.obs):
            assert getattr(x.obs, f).tobytes() == getattr(y.obs, f).tobytes()
            assert getattr(x.obs, f).tobytes() == getattr(z.obs, f).tobytes()


def test_online_learner_on_the_card(card):
    """One learner update on the card against the CPU's from the same
    trajectories and weights (the stats within rtol 1e-4 / atol 1e-6,
    the weights within test_torch_ppo.py's bounds, the policy heads to
    Adam's step bound); the version reaches a card store through the
    bus on the next pump, and the background thread steps, publishes
    and stops cleanly."""
    import time

    import numpy as np

    from sparksched_tpu_torch.online import (
        OnlineLearner,
        ParamBus,
        TrajectoryBuffer,
        make_learner_trainer,
    )

    from ._torch_parity import assert_update_close

    agent = {"agent_cls": "DecimaScheduler", "embed_dim": 8,
             "gnn_mlp_kwargs": {"hid_dims": [16]},
             "policy_mlp_kwargs": {"hid_dims": [16]}, "job_bucket": 4}
    buf = TrajectoryBuffer(capacity=64, max_steps=8, min_decisions=1)
    _drive_ring(_ring_store("cpu", 4, buf))
    trajs = buf.drain(2)
    assert len(trajs) == 2
    p, _, s = _serve_stack("cpu")
    w0 = {k: v.detach().clone() for k, v in s.params.items()}
    store = _ring_store("cuda", 4, None)
    bus = ParamBus(store, probation_decisions=4)
    res = {}
    for dev in ("cuda", "cpu"):
        lr = OnlineLearner(make_learner_trainer(agent, p, 2, 8, device=dev),
                           TrajectoryBuffer(), bus if dev == "cuda" else None,
                           init_params=w0)
        lr.buffer.requeue(list(trajs))
        info = lr.step()
        assert info["accepted"], info
        res[dev] = (info, {k: v.detach().cpu()
                           for k, v in lr.state.params.items()}, lr)
    (gi, gp, glr), (ci, cp, _) = res["cuda"], res["cpu"]
    for k in ("policy_loss", "approx_kl_div", "entropy"):
        np.testing.assert_allclose(gi[k], ci[k], rtol=1e-4, atol=1e-6)
    assert_update_close(cp, gp, w0, int(ci["minibatches_applied"]), 3e-4,
                        False)
    assert bus.pump() == {"event": "swap", "version": 1}
    for k, v in store.model_params.items():
        assert torch.equal(v.cpu(), gp[k]), k
    sid = store.create(seed=1)
    assert store.decide(sid).params_version == 1
    glr.buffer.requeue(list(trajs))
    glr.start_background()
    for _ in range(500):
        if glr.stats["learner_published"] >= 2:
            break
        time.sleep(0.01)
    glr.stop()
    assert glr.error is None and glr.stats["learner_published"] == 2
    assert bus.pump()["event"] == "swap" and store.params_version == 2


def test_rbg_kernel_matches_plain_version(card):
    from sparksched_tpu_torch.kernels.rbg import (
        bits_to_uniform,
        rbg_bits_ref,
        rbg_random_bits,
        rbg_uniform,
    )

    g = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 2**32, (2048, 4), generator=g,
                         dtype=torch.int64)
    keys[:3] = torch.tensor([[1, 2, 0xFFFFFFFF, 0xFFFFFFFF],
                             [0xFFFFFFFF] * 4, [5, 6, 0xFFFFFFFE, 0]])
    keys = keys.to(card)
    launches = rbg_random_bits.launches
    for i in range(keys.shape[0]):
        n = 2 * (i % 67) + 1
        want = rbg_bits_ref(keys[i], n)
        assert torch.equal(rbg_random_bits(keys[i], (n,)), want), i
        assert torch.equal(rbg_uniform(keys[i], (n,)),
                           bits_to_uniform(want)), i
    for batch, shape in (((16,), (50, 2)), ((16,), (8, 50, 2)),
                         ((3, 16), (7,)), ((16,), ())):
        kb = keys[:16 * (3 if len(batch) == 2 else 1)].reshape(batch + (4,))
        got = rbg_uniform(kb, shape)
        want = rbg_bits_ref(kb, got.numel()).reshape(got.shape)
        assert torch.equal(got, bits_to_uniform(want)), (batch, shape)
    torch.cuda.synchronize()
    assert rbg_random_bits.launches == launches + 2 * keys.shape[0] + 4


def test_threefry_path_kernel_matches_plain_version(card):
    """The path kernel bit-equal to its plain version on random path
    tables (depths 1 to 3, varying counters, counters near 2^32) and at
    the call sites' tables, roots read through a row stride, one launch
    a call."""
    from sparksched_tpu_torch import prng
    from sparksched_tpu_torch.kernels.threefry import (
        MODES,
        PATH_VAR,
        path_table,
        threefry2x32,
        threefry2x32_keys_ref,
    )
    from sparksched_tpu_torch.serve.aot import _call_paths
    from sparksched_tpu_torch.trainers.ppo import permutation_paths
    from sparksched_tpu_torch.trainers.rollout import row_paths
    from sparksched_tpu_torch.trainers.trainer import lane_paths

    g = torch.Generator().manual_seed(11)
    words = torch.randint(0, 2**32, (512, 3, 4), generator=g,
                          dtype=torch.int64).to(card)
    pool = {4: words[:, 1], 2: words[:, 2, 1:3]}
    tables = [row_paths(16, True, card), row_paths(16, False, card),
              lane_paths(4, 4, card), permutation_paths(3, 16, card),
              _call_paths(8, card), _call_paths(0, card)]
    for depth in (1, 2, 3):
        rows = torch.randint(0, 2**32, (40, depth), generator=g).tolist()
        for i, r in enumerate(rows):
            r[i % depth] = PATH_VAR if i % 3 == 0 else 2**32 - 1 - i
            del r[:i % depth]
        tables.append(path_table(rows, card))
    launches = threefry2x32.launches
    calls = 0
    for w in (2, 4):
        for mode in (MODES if w == 2 else ("pair",)):
            for t in tables:
                for n in (1, 3):
                    for var in (0, 5, 2**32 - 1):
                        got = threefry2x32(pool[w][:64], n, var, mode, t)
                        calls += 1
                        want = threefry2x32_keys_ref(pool[w][:64], n, var,
                                                     mode, t)
                        assert torch.equal(got, want), (w, mode, t.shape, n)
        root = pool[w][7]
        assert torch.equal(prng.derive(root, tables[0]),
                           prng.derive(root.cpu(), tables[0].cpu()).to(card))
        calls += 1
    torch.cuda.synchronize()
    assert threefry2x32.launches == launches + calls
