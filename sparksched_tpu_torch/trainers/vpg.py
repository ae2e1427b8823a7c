"""Vanilla Policy Gradient / REINFORCE with the critic-free baseline
(counterpart of `sparksched_tpu/trainers/vpg.py`).

Per lane, the advantages are standardised over the lane's valid decided
rows (weight w = 1; mean over n = max(sum w, 1), variance over
max(n - 1, 1)); the lane's policy loss is -sum(lgprob * adv * w) / n and
its entropy loss -sum(entropy * w) / n, at the entropy coefficient of the
iteration (`entropy_anneal`); the lanes' losses are summed and one
`ClippedAdam` step is taken. The JAX package differentiates the whole
[B, T] rollout at once; here only the rows with w > 0 go through the net,
in chunks of `ppo.UPDATE_CHUNK` observations with the gradients
accumulated before the one step (a row with w = 0 adds exactly 0 to the
loss and its gradient, given a finite log-prob). Like the JAX update, it
reports no health bits of its own.
"""

from __future__ import annotations

import torch

from ..obs.tracing import annotate
from ..schedulers.decima import DecimaAction
from .ppo import UPDATE_CHUNK
from .rollout import Rollout, stored_to_observation
from .trainer import CfgType, Trainer, TrainState

EPS = 1e-8


class VPG(Trainer):
    def __init__(self, agent_cfg: CfgType, env_cfg: CfgType,
                 train_cfg: CfgType, **kw) -> None:
        super().__init__(agent_cfg, env_cfg, train_cfg, **kw)
        self.entropy_coeff = float(train_cfg.get("entropy_coeff", 0.0))

    def _update(self, state: TrainState, ro: Rollout):
        returns, baselines, buf, avg_num_jobs = self._returns_and_baselines(
            state, ro)
        B, T = ro.reward.shape
        dev = ro.reward.device
        adv = returns - baselines
        w = (ro.valid & (ro.stage_idx >= 0)).to(torch.float32)
        n = torch.clamp_min(w.sum(-1, keepdim=True), 1.0)
        mean = (adv * w).sum(-1, keepdim=True) / n
        var = ((adv - mean) ** 2 * w).sum(-1, keepdim=True) / torch.clamp_min(
            n - 1, 1.0)
        adv = (adv - mean) / (torch.sqrt(var) + EPS)
        ent_coeff = self._entropy_coeff_at(self.entropy_coeff,
                                           state.iteration)
        rows = torch.nonzero(w.reshape(-1)).reshape(-1)  # the rows w > 0
        b_all, t_all = rows // T, rows % T
        n_all = n[:, 0][b_all]
        params = list(state.params.values())
        for p in params:
            p.grad = torch.zeros_like(p)
        sched = self.scheduler
        pl_sum = torch.zeros((), device=dev)
        ent_sum = torch.zeros((), device=dev)
        chunks = 0
        with annotate("train/vpg_update"):
            for c0 in range(0, rows.numel(), UPDATE_CHUNK):
                bb = b_all[c0:c0 + UPDATE_CHUNK]
                tt = t_all[c0:c0 + UPDATE_CHUNK]
                nn = n_all[c0:c0 + UPDATE_CHUNK]
                so = ro.obs.map(lambda a: a[bb, tt])
                feats = sched.features(stored_to_observation(self.bank, so))
                acts = DecimaAction(stage_idx=ro.stage_idx[bb, tt],
                                    job_idx=ro.job_idx[bb, tt],
                                    num_exec=ro.num_exec_k[bb, tt])
                lgp, ent = sched.evaluate_actions(feats, acts)
                pl = -(lgp * adv[bb, tt] / nn).sum()
                el = -(ent / nn).sum()
                (pl + ent_coeff * el).backward()
                pl_sum = pl_sum + pl.detach()
                ent_sum = ent_sum + el.detach()
                chunks += 1
            state.opt_state.step()
        for p in params:
            p.grad = None
        stats = {
            "policy_loss": float(pl_sum) / B,
            "entropy": float(ent_sum) / B,
            "avg_num_jobs_est": (None if avg_num_jobs is None
                                 else float(avg_num_jobs)),
            "update_chunks": float(chunks),
        }
        state.buf = buf
        return state, stats
