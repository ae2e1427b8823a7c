"""Decima GNN policy in PyTorch (counterpart of
`sparksched_tpu/schedulers/decima.py`).

Same five normalized node features, the same level-wise message pass
leaf to root, the same dag/global summaries and two policy heads, over
fixed-shape `[B,J,S]` tensors with masks (B lanes). The NodeEncoder runs
through `kernels.decima_encoder` (the CUDA kernel on the card, its plain
version on the CPU); the other dense layers stay `nn.Linear`. Parameter
names follow the flax tree (`mlp_prep.dense_0.weight`, ...), so
`params_from_flax` carries weights across from the JAX package.

Sampling is greedy (serving) or stochastic (collection: Gumbel-max with
`prng.categorical`, the JAX key layout); `evaluate_actions` gives the
log-probs and normalised entropies the PPO update differentiates, with
the NodeEncoder's gradient from its own backward kernel
(`kernels.decima_encoder.DecimaNodeEncoderFn`).

Waiting for a later slice: `compute_dtype="bfloat16"` (ROADMAP A9b, with
bf16 variants of both NodeEncoder kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from .. import prng
from ..config import resolve_device
from ..env.observe import Observation
from ..kernels.decima_encoder import (
    DecimaNodeEncoderFn,
    EncoderWeights,
    decima_node_encoder,
    pack_weights,
)
from .base import TrainableScheduler

NUM_NODE_FEATURES = 5
NUM_DAG_FEATURES = 3
NEG_INF = -1e30

_i32 = torch.int32


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DecimaFeatures:
    """Padded model inputs derived from a raw Observation (`[B,...]`)."""

    x: torch.Tensor  # f32[B,J,S,5]
    node_mask: torch.Tensor  # bool[B,J,S]
    job_mask: torch.Tensor  # bool[B,J]
    stage_mask: torch.Tensor  # bool[B,J,S]
    exec_mask: torch.Tensor  # bool[B,J,N]
    adj: torch.Tensor  # bool[B,J,S,S]
    node_level: torch.Tensor  # i32[B,J,S]


def build_features(obs: Observation, num_executors: int,
                   num_tasks_scale: float = 200.0, work_scale: float = 1e5
                   ) -> DecimaFeatures:
    """The 5 normalized node features + masks: commit-cap/N, +-1
    source-job flag, exec-supply/N, tasks/200, work/1e5."""
    n = num_executors
    j_cap = obs.job_mask.shape[1]
    j_idx = torch.arange(j_cap, device=obs.job_mask.device)
    supplies = obs.exec_supplies
    committable = obs.num_committable[:, None]
    caps = torch.minimum(torch.clamp_min(n - supplies, 0), committable)
    is_src = (obs.source_job[:, None] >= 0) & (j_idx[None, :] == obs.source_job[:, None])
    caps = torch.where(is_src, committable, caps)
    # each read upcast to f32 (lossless from the bf16 observation layout),
    # so the arithmetic below and the NodeEncoder kernels stay float32
    remaining = obs.nodes[..., 0].to(torch.float32)
    duration = obs.nodes[..., 1].to(torch.float32)
    shape = remaining.shape
    x = torch.stack(
        [
            (caps / n)[:, :, None].expand(shape),
            torch.where(is_src, 1.0, -1.0)[:, :, None].expand(shape),
            (supplies / n)[:, :, None].expand(shape),
            remaining / num_tasks_scale,
            remaining * duration / work_scale,
        ],
        dim=-1,
    ).to(torch.float32)
    x = torch.where(obs.node_mask[..., None], x, 0.0)
    exec_mask = (
        torch.arange(n, device=caps.device)[None, None, :] < caps[:, :, None]
    ) & obs.job_mask[:, :, None]
    adj = obs.adj & obs.node_mask[..., :, None] & obs.node_mask[..., None, :]
    return DecimaFeatures(
        x=x.contiguous(), node_mask=obs.node_mask, job_mask=obs.job_mask,
        stage_mask=obs.schedulable, exec_mask=exec_mask,
        adj=adj.contiguous(), node_level=obs.node_level,
    )


def compact_features(f: DecimaFeatures, k: int
                     ) -> tuple[DecimaFeatures, torch.Tensor]:
    """Gather each lane's first `k` active jobs into a width-k view.
    Returns (compact features, ids[B,k]) with ids == J on empty rows.
    Only meaningful when every lane has <= k active jobs."""
    b, j_cap = f.job_mask.shape
    ar = torch.arange(j_cap, device=f.job_mask.device, dtype=_i32)
    ids = torch.sort(
        torch.where(f.job_mask, ar[None, :], j_cap), dim=1
    ).values[:, :k]
    valid = ids < j_cap
    idx = torch.clamp_max(ids, j_cap - 1).long()
    rows = torch.arange(b, device=ids.device)[:, None]
    vm = valid[:, :, None]
    node_mask = f.node_mask[rows, idx] & vm
    return DecimaFeatures(
        x=torch.where(node_mask[..., None], f.x[rows, idx], 0.0).contiguous(),
        node_mask=node_mask.contiguous(),
        job_mask=valid,
        stage_mask=f.stage_mask[rows, idx] & vm,
        exec_mask=f.exec_mask[rows, idx] & vm,
        adj=(f.adj[rows, idx] & vm[..., None]).contiguous(),
        node_level=f.node_level[rows, idx].contiguous(),
    ), ids


def scatter_job_scores(stage_k, exec_k, ids, j_cap: int):
    """Scatter compact [B,k,S]/[B,k,N] scores back to [B,J,S]/[B,J,N];
    empty compact rows (ids == J) are dropped."""
    b = ids.shape[0]
    rows = torch.arange(b, device=ids.device)[:, None]
    i = ids.long()
    stage = torch.zeros((b, j_cap + 1) + stage_k.shape[2:],
                        dtype=stage_k.dtype, device=stage_k.device)
    execs = torch.zeros((b, j_cap + 1) + exec_k.shape[2:],
                        dtype=exec_k.dtype, device=exec_k.device)
    stage[rows, i] = stage_k
    execs[rows, i] = exec_k
    return stage[:, :j_cap], execs[:, :j_cap]


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def make_act(name: str, kwargs: Any = None) -> Callable:
    """Activation factory (the JAX package's `make_act`)."""
    kwargs = dict(kwargs or {})
    name = name.lower()
    if name in ("leakyrelu", "leaky_relu"):
        slope = float(kwargs.get("negative_slope", 0.01))
        return lambda x: torch.where(x >= 0, x, slope * x)
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown activation {name!r}")


def _leaky_slope(name: str, kwargs: Any) -> float:
    """The GNN activation as the NodeEncoder kernel takes it: a leaky
    slope (0 for ReLU)."""
    name = name.lower()
    if name in ("leakyrelu", "leaky_relu"):
        return float(dict(kwargs or {}).get("negative_slope", 0.01))
    if name == "relu":
        return 0.0
    raise NotImplementedError(
        f"the NodeEncoder kernel takes LeakyReLU/ReLU GNN activations, not "
        f"{name!r}"
    )


class MLP(nn.Module):
    """Dense stack with layers `dense_0..dense_n` (the flax names)."""

    def __init__(self, in_dim: int, hid_dims, out_dim: int,
                 act: Callable) -> None:
        super().__init__()
        self.act = act
        dims = [in_dim, *hid_dims, out_dim]
        self.n = len(dims) - 1
        for i in range(self.n):
            lin = nn.Linear(dims[i], dims[i + 1])
            # lecun-normal weights, zero biases (flax Dense defaults)
            nn.init.normal_(lin.weight, std=dims[i] ** -0.5)
            nn.init.zeros_(lin.bias)
            setattr(self, f"dense_{i}", lin)

    def layers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [(getattr(self, f"dense_{i}").weight,
                 getattr(self, f"dense_{i}").bias) for i in range(self.n)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = self.act(x)
        return x


class DecimaNet(nn.Module):
    """Encoder + both policy heads: masked stage scores [B,J,S] and exec
    scores for every job [B,J,N]."""

    def __init__(self, num_executors: int, embed_dim: int = 16,
                 gnn_hid=(32, 16), policy_hid=(64, 64),
                 gnn_act: str = "LeakyReLU", gnn_act_kwargs: Any = None,
                 policy_act: str = "Tanh", policy_act_kwargs: Any = None,
                 num_levels: int = 0) -> None:
        super().__init__()
        self.num_executors = int(num_executors)
        self.embed_dim = d = int(embed_dim)
        self.num_levels = int(num_levels)
        self.slope = _leaky_slope(gnn_act, gnn_act_kwargs)
        g_act = make_act(gnn_act, gnn_act_kwargs)
        p_act = make_act(policy_act, policy_act_kwargs)
        f = NUM_NODE_FEATURES
        self.mlp_prep = MLP(f, gnn_hid, d, g_act)
        self.mlp_msg = MLP(d, gnn_hid, d, g_act)
        self.mlp_update = MLP(d, gnn_hid, d, g_act)
        self.mlp_dag = MLP(f + d, gnn_hid, d, g_act)
        self.mlp_glob = MLP(d, gnn_hid, d, g_act)
        self.mlp_stage = MLP(f + 3 * d, policy_hid, 1, p_act)
        self.mlp_exec = MLP(NUM_DAG_FEATURES + 2 * d + 1, policy_hid, 1, p_act)
        self._enc_key: tuple = ()
        self._enc_w: EncoderWeights | None = None

    def encoder_weights(self) -> EncoderWeights:
        """The NodeEncoder MLPs packed for the kernel, once per parameter
        version: packed anew only when a weight was changed in place
        (`load_state_dict`, hence `SessionStore.set_params`) or moved."""
        layers = (self.mlp_prep.layers(), self.mlp_msg.layers(),
                  self.mlp_update.layers())
        key = tuple((t.data_ptr(), t._version)
                    for ls in layers for pair in ls for t in pair)
        if key != self._enc_key:
            self._enc_w, self._enc_key = pack_weights(*layers), key
        return self._enc_w

    def encode(self, f: DecimaFeatures) -> torch.Tensor:
        """NodeEncoder h_node [B,J,S,D] through the kernel wrapper; with
        grad enabled through `DecimaNodeEncoderFn`, whose backward is the
        encoder's backward kernel (its plain version on the CPU)."""
        w = self.encoder_weights()
        if torch.is_grad_enabled() and any(
                t.requires_grad for ls in (w.prep, w.msg, w.update)
                for pair in ls for t in pair):
            return DecimaNodeEncoderFn.apply(
                f.x, f.adj, f.node_level, f.node_mask, w, self.num_levels,
                self.slope,
                *(t for ls in (w.prep, w.msg, w.update)
                  for pair in ls for t in pair),
            )
        return decima_node_encoder(
            f.x, f.adj, f.node_level, f.node_mask, w, self.num_levels,
            self.slope,
        )

    def forward(self, f: DecimaFeatures):
        x = f.x
        d = self.embed_dim
        h_node = self.encode(f)
        # DagEncoder
        z = self.mlp_dag(torch.cat([x, h_node], -1))
        h_dag = torch.where(f.node_mask[..., None], z, 0.0).sum(-2)
        # GlobalEncoder
        zg = self.mlp_glob(h_dag)
        h_glob = torch.where(f.job_mask[..., None], zg, 0.0).sum(-2)
        # StagePolicyNetwork
        b, j_cap, s_cap = x.shape[:3]
        stage_in = torch.cat([
            x, h_node,
            h_dag[:, :, None, :].expand(b, j_cap, s_cap, d),
            h_glob[:, None, None, :].expand(b, j_cap, s_cap, d),
        ], -1)
        stage_scores = self.mlp_stage(stage_in)[..., 0]
        # ExecPolicyNetwork
        first = torch.argmax(f.node_mask.to(torch.uint8), -1)
        x_dag = torch.gather(
            x, 2, first[:, :, None, None].expand(b, j_cap, 1, x.shape[-1])
        )[:, :, 0, :NUM_DAG_FEATURES]
        n = self.num_executors
        k_frac = (torch.arange(n, device=x.device) / n).to(x.dtype)
        per_job = torch.cat([x_dag, h_dag], -1)
        exec_in = torch.cat([
            per_job[:, :, None, :].expand(b, j_cap, n, per_job.shape[-1]),
            h_glob[:, None, None, :].expand(b, j_cap, n, d),
            k_frac[None, None, :, None].expand(b, j_cap, n, 1),
        ], -1)
        exec_scores = self.mlp_exec(exec_in)[..., 0]
        return stage_scores, exec_scores


# --------------------------------------------------------------------------
# masked heads
# --------------------------------------------------------------------------


def masked_log_softmax(scores: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    return torch.log_softmax(torch.where(mask, scores, NEG_INF), -1)


def masked_entropy(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return -torch.where(mask, torch.exp(logp) * logp, 0.0).sum(-1)


@dataclasses.dataclass
class DecimaAction:
    stage_idx: torch.Tensor  # i32[B] flat padded node index (-1 = none)
    job_idx: torch.Tensor  # i32[B]
    num_exec: torch.Tensor  # i32[B] 0-based parallelism choice


def sample_action(rng, stage_scores, exec_scores, f: DecimaFeatures,
                  deterministic: bool = False):
    """Autoregressive action per lane: the stage by a masked softmax over
    every schedulable node, then the executor count from the chosen
    job's exec head; both by Gumbel-max on the lane's key (`rng` [B, W],
    split into the stage and the exec key as the JAX package does, or
    those two keys already split, [B, 2, W]), or with `deterministic`
    both by the masked argmax (`rng` unused, may be None). Returns
    (DecimaAction, lgprob[B]), the log-probability of the chosen
    action."""
    b, j_cap, s_cap = f.stage_mask.shape
    rows = torch.arange(b, device=stage_scores.device)
    flat_mask = f.stage_mask.reshape(b, -1)
    flat_scores = stage_scores.reshape(b, -1)
    logp_stage = masked_log_softmax(flat_scores, flat_mask)
    valid = flat_mask.any(1)
    stage_logits = torch.where(flat_mask, flat_scores, NEG_INF)
    if deterministic:
        pick = torch.argmax(stage_logits, 1)
    else:
        keys = rng if rng.dim() == 3 else prng.split(rng)
        k_stage, k_exec = keys[:, 0], keys[:, 1]
        pick = prng.categorical(k_stage, stage_logits)
    stage_flat = torch.where(valid, pick, -1).to(_i32)
    job = torch.where(valid, stage_flat // s_cap, -1).to(_i32)
    jc = torch.clamp_min(job, 0).long()
    e_mask = f.exec_mask[rows, jc]
    e_scores = exec_scores[rows, jc]
    logp_exec = masked_log_softmax(e_scores, e_mask)
    exec_logits = torch.where(e_mask, e_scores, NEG_INF)
    if deterministic:
        exec_pick = torch.argmax(exec_logits, 1)
    else:
        exec_pick = prng.categorical(k_exec, exec_logits)
    k = torch.where(e_mask.any(1), exec_pick, 0).to(_i32)
    lgprob = torch.where(
        valid,
        logp_stage[rows, torch.clamp_min(stage_flat, 0).long()]
        + logp_exec[rows, k.long()],
        0.0,
    )
    return DecimaAction(stage_idx=stage_flat, job_idx=job, num_exec=k), lgprob


def evaluate_actions(stage_scores, exec_scores, f: DecimaFeatures,
                     action: DecimaAction, num_executors: int):
    """Log-prob and normalised entropy of one stored action per item
    ([B] leading): the entropy of both heads over
    `log(max(N * nodes, 2))`; both 0 where the action chose no stage."""
    b = f.stage_mask.shape[0]
    rows = torch.arange(b, device=stage_scores.device)
    flat_mask = f.stage_mask.reshape(b, -1)
    logp_stage = masked_log_softmax(stage_scores.reshape(b, -1), flat_mask)
    jc = torch.clamp_min(action.job_idx, 0).long()
    e_mask = f.exec_mask[rows, jc]
    logp_exec = masked_log_softmax(exec_scores[rows, jc], e_mask)
    lgprob = (logp_stage[rows, torch.clamp_min(action.stage_idx, 0).long()]
              + logp_exec[rows, action.num_exec.long()])
    ent = masked_entropy(logp_stage, flat_mask) + masked_entropy(
        logp_exec, e_mask)
    num_nodes = f.node_mask.sum((1, 2))
    ent = ent / torch.log(
        torch.clamp_min(num_executors * num_nodes, 2).to(torch.float32))
    valid = action.stage_idx >= 0
    return torch.where(valid, lgprob, 0.0), torch.where(valid, ent, 0.0)


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------


class DecimaScheduler(TrainableScheduler):
    """Decima scheduler over a `DecimaNet` on `device` (the card unless
    the caller asks for the CPU). Weights come from `torch.manual_seed(
    seed)`, from a model file (`state_dict_path`: the JAX package's
    flax-msgpack `model.msgpack` or a reference torch `.pt`, see
    `load_state_dict_file`) or, through `load_params`, from a state
    dict."""

    def __init__(self, num_executors: int, embed_dim: int = 16,
                 gnn_mlp_kwargs: dict[str, Any] | None = None,
                 policy_mlp_kwargs: dict[str, Any] | None = None,
                 state_dict_path: str | None = None, seed: int = 42,
                 num_tasks_scale: float = 200.0, work_scale: float = 1e5,
                 compute_dtype: str | None = None, num_levels: int = 0,
                 job_bucket: int = 0, device: str | torch.device = "cuda",
                 **_: Any) -> None:
        self.device = resolve_device(device)
        if compute_dtype not in (None, "float32"):
            raise NotImplementedError(
                "compute_dtype=bfloat16 is not ported yet (ROADMAP A9b: "
                "bf16 variants of both NodeEncoder kernels)"
            )
        self.name = "Decima"
        self.num_executors = int(num_executors)
        self.num_tasks_scale = num_tasks_scale
        self.work_scale = work_scale
        self.job_bucket = int(job_bucket)
        g = gnn_mlp_kwargs or {}
        p = policy_mlp_kwargs or {}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = DecimaNet(
                num_executors=self.num_executors, embed_dim=embed_dim,
                gnn_hid=tuple(g.get("hid_dims", (32, 16))),
                policy_hid=tuple(p.get("hid_dims", (64, 64))),
                gnn_act=g.get("act_cls", "LeakyReLU"),
                gnn_act_kwargs=g.get("act_kwargs"),
                policy_act=p.get("act_cls", "Tanh"),
                policy_act_kwargs=p.get("act_kwargs"),
                num_levels=int(num_levels),
            )
        self.net = net.to(self.device).eval()
        self.net.requires_grad_(False)
        if state_dict_path:
            self.name += f":{state_dict_path}"
            self.load_params(load_state_dict_file(state_dict_path))

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_params(self, state_dict: dict[str, Any]) -> None:
        """Load a state dict (e.g. from `params_from_flax`); names and
        shapes must match exactly."""
        sd = {k: torch.as_tensor(v, dtype=torch.float32)
              for k, v in state_dict.items()}
        self.net.load_state_dict(sd, strict=True)

    def features(self, obs: Observation) -> DecimaFeatures:
        return build_features(obs, self.num_executors, self.num_tasks_scale,
                              self.work_scale)

    def score(self, f: DecimaFeatures):
        """Stage/exec scores with active-job compaction: with `job_bucket`
        K, when every lane has <= K active jobs the net runs at width K
        and the scores scatter back to [J]; otherwise it runs full width."""
        k = self.job_bucket
        j_cap = f.job_mask.shape[-1]
        if not k or k >= j_cap or bool((f.job_mask.sum(-1) > k).any()):
            return self.net(f)
        fk, ids = compact_features(f, k)
        ss, es = self.net(fk)
        return scatter_job_scores(ss, es, ids, j_cap)

    @torch.no_grad()
    def batch_policy(self, rng, obs: Observation,
                     deterministic: bool = False):
        """Policy over a [B] observation stack in ONE net evaluation;
        `rng` is one key, split into one per lane (None when
        `deterministic`). Returns (stage_idx[B], num_exec_1based[B],
        aux)."""
        keys = (None if deterministic
                else prng.split(rng, obs.job_mask.shape[0]))
        return self.lane_policy(keys, obs, deterministic)

    @torch.no_grad()
    def lane_policy(self, keys, obs: Observation,
                    deterministic: bool = False):
        """`batch_policy` with the lanes' keys given (`keys` [B, W], each
        lane's key as the JAX package's vmapped `policy` takes it, or
        [B, 2, W], its split as the collector derives it; None when
        `deterministic`)."""
        f = self.features(obs)
        stage_scores, exec_scores = self.score(f)
        action, lgprob = sample_action(keys, stage_scores, exec_scores, f,
                                       deterministic)
        return action.stage_idx, action.num_exec + 1, {
            "lgprob": lgprob,
            "job_idx": action.job_idx,
            "num_exec_k": action.num_exec,
        }

    def policy(self, rng, obs: Observation, deterministic: bool = False):
        """Single-session policy: `obs` has a leading axis of 1."""
        return self.batch_policy(rng, obs, deterministic)

    def serve_param_policies(self, deterministic: bool = True):
        """The `(policy_fn, batch_policy_fn)` pair the session store
        serves through, each `fn(keys, obs)` with one policy key per
        lane (`keys` [B,2]; unused when `deterministic`). The single
        path's lane takes the call's policy key itself, as the JAX
        package's unbatched `policy` does; the batched path's lanes take
        the K-way split of it (`serve/aot.py`). The weights are the
        module's live parameters: `SessionStore.set_params` swaps them
        in place."""
        fn = (lambda k, o: self.lane_policy(None, o, True)) if deterministic \
            else (lambda k, o: self.lane_policy(k, o, False))
        return fn, fn

    def evaluate_actions(self, feats: DecimaFeatures, actions: DecimaAction):
        """Log-probs and normalised entropies of stored actions over
        [B]-leading features, through the full-width net (the PPO
        update's evaluation; differentiable)."""
        stage_scores, exec_scores = self.net(feats)
        return evaluate_actions(stage_scores, exec_scores, feats, actions,
                                self.num_executors)

    def schedule(self, obs: Observation):
        si, ne, info = self.policy(None, obs, True)
        return ({"stage_idx": int(si[0]), "num_exec": int(ne[0])},
                {k: v[0].item() for k, v in info.items()})


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's flax params (nested
    dicts of arrays, with or without the top-level "params" key):
    `mlp_x/dense_i/{kernel,bias}` -> `mlp_x.dense_i.{weight,bias}`, the
    kernel transposed ([in,out] -> [out,in])."""
    import numpy as np

    if "params" in tree:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}
    for mlp_name, layers in tree.items():
        for dense_name, leaf in layers.items():
            key = f"{mlp_name}.{dense_name}"
            out[f"{key}.weight"] = torch.from_numpy(
                np.array(np.asarray(leaf["kernel"], np.float32).T))
            out[f"{key}.bias"] = torch.from_numpy(
                np.asarray(leaf["bias"], np.float32).copy())
    return out


# the reference torch checkpoint's module names -> the net's (the JAX
# package's `_TORCH_TO_FLAX`)
_TORCH_TO_PORT = {
    "encoder.node_encoder.mlp_prep": "mlp_prep",
    "encoder.node_encoder.mlp_msg": "mlp_msg",
    "encoder.node_encoder.mlp_update": "mlp_update",
    "encoder.dag_encoder.mlp": "mlp_dag",
    "encoder.global_encoder.mlp": "mlp_glob",
    "stage_policy_network.mlp_score": "mlp_stage",
    "exec_policy_network.mlp_score": "mlp_exec",
}


def state_dict_from_torch(sd: dict) -> dict[str, torch.Tensor]:
    """The port's state dict from a reference torch checkpoint's, as the
    JAX package's `load_torch_state_dict` maps it: the Linear layers of
    each `Sequential` (its even indices) become `dense_0, dense_1, ...`
    in index order. Torch and the port both keep weights as [out,in]."""
    out: dict[str, torch.Tensor] = {}
    for tname, pname in _TORCH_TO_PORT.items():
        seq = sorted({int(k[len(tname) + 1:].split(".")[0])
                      for k in sd if k.startswith(tname + ".")})
        for li, si in enumerate(seq):
            for kind in ("weight", "bias"):
                out[f"{pname}.dense_{li}.{kind}"] = torch.as_tensor(
                    sd[f"{tname}.{si}.{kind}"], dtype=torch.float32
                ).detach().cpu().clone()
    return out


def load_state_dict_file(path: str) -> dict[str, torch.Tensor]:
    """A model file as the port's state dict: a `.pt` reference torch
    checkpoint (loaded with `weights_only=True`, never unpickled), else
    a flax-msgpack file (`model.msgpack`) through the port's codec."""
    if path.endswith(".pt"):
        return state_dict_from_torch(
            torch.load(path, map_location="cpu", weights_only=True))
    from ..serialization import from_bytes

    with open(path, "rb") as fp:
        return params_from_flax(from_bytes(fp.read()))
