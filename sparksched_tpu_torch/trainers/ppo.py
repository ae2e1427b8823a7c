"""Proximal Policy Optimization (counterpart of
`sparksched_tpu/trainers/ppo.py`).

The update of the JAX package: epochs x minibatches drawn as per-lane
permutations of the time axis (`fold_in(rng, 13)`, one key per epoch by
`split`, one per lane by `fold_in(·, b)`, padded to `nb * mbs`), advantages
standardised per minibatch, the clipped surrogate with the entropy bonus,
the approximate-KL stop at 1.5 x `target_kl` and the `grad_health` skip
gate. What differs is how a minibatch is evaluated: only its rows with
weight w > 0 (a valid step inside the epoch's range) go through the net —
every other row's terms are exactly 0 in every sum, given finite values —
in chunks of `UPDATE_CHUNK` observations with the gradients accumulated.
The advantage mean and variance and the count n come first, over the
whole minibatch; the KL stop is decided from the accumulated KL before
`step()`. A minibatch not applied (the KL stop, the health gate) calls no
`step()`, so Adam's moments and count stay as they were. After the KL
stop the remaining minibatches are still evaluated, loss and gradients,
when the health gate is on: as in the JAX scan, their health bits join
the update's mask (a non-finite loss or gradient there makes the
trainer retry the iteration) and nothing else of them is kept. With the
gate off they are skipped.
"""

from __future__ import annotations

import functools

import torch

from .. import prng
from ..env.health import H_NONFINITE_GRAD, H_NONFINITE_LOSS, grad_health
from ..obs.tracing import annotate
from ..schedulers.decima import DecimaAction
from .rollout import Rollout, stored_to_observation
from .trainer import CfgType, Trainer, TrainState

EPS = 1e-8
# Observations evaluated at once in the update (full width: 200 jobs x 20
# stages at the flagship shape, ~25 MB of saved activations each), sized
# to stay well inside an 80 GB card.
UPDATE_CHUNK = 1024


@functools.lru_cache(maxsize=None)
def permutation_paths(E: int, B: int, device: torch.device) -> torch.Tensor:
    """The update's permutation keys' paths from the state key: epoch e,
    lane b at (13, e, b), [E, B, 3]."""
    rows = [(13, e, b) for e in range(E) for b in range(B)]
    return prng.path_table(rows, device, (E, B))


class PPO(Trainer):
    def __init__(self, agent_cfg: CfgType, env_cfg: CfgType,
                 train_cfg: CfgType, **kw) -> None:
        super().__init__(agent_cfg, env_cfg, train_cfg, **kw)
        self.entropy_coeff = float(train_cfg.get("entropy_coeff", 0.0))
        self.clip_range = float(train_cfg.get("clip_range", 0.2))
        tk = train_cfg.get("target_kl", 0.01)
        self.target_kl = None if tk is None else float(tk)
        self.num_epochs = int(train_cfg.get("num_epochs", 10))
        self.num_batches = int(train_cfg.get("num_batches", 3))

    def minibatch_indices(self, rng: torch.Tensor, B: int, T: int):
        """(mb_idx i64[E*nb, B, mbs], mb_ok bool[E*nb, mbs]): lane b of
        minibatch k takes steps mb_idx[k, b]; slots past T are padding."""
        E, nb = self.num_epochs, self.num_batches
        mbs = -(-T // nb)
        # fold_in(split(fold_in(rng, 13), E)[e], b): the path (13, e, b)
        lane_keys = prng.derive(rng, permutation_paths(E, B, rng.device))
        perms = prng.permutation(lane_keys, T)  # [E, B, T]
        pad = nb * mbs - T
        perms = torch.cat([perms, perms.new_zeros((E, B, pad))], -1)
        mb_idx = perms.reshape(E, B, nb, mbs).transpose(1, 2).reshape(
            E * nb, B, mbs)
        in_range = torch.arange(nb * mbs, device=rng.device) < T
        mb_ok = in_range.reshape(nb, mbs).repeat(E, 1)
        return mb_idx, mb_ok

    def _update(self, state: TrainState, ro: Rollout):
        with annotate("train/ppo_update"):
            return self._ppo_update(state, ro)

    def _ppo_update(self, state: TrainState, ro: Rollout):
        returns, baselines, buf, avg_num_jobs = self._returns_and_baselines(
            state, ro)
        B, T = ro.reward.shape
        dev = ro.reward.device
        ent_coeff = self._entropy_coeff_at(self.entropy_coeff,
                                           state.iteration)
        advantages = returns - baselines
        valid = ro.valid & (ro.stage_idx >= 0)
        mb_idx, mb_ok = self.minibatch_indices(state.rng, B, T)
        params = list(state.params.values())
        for p in params:
            p.grad = torch.zeros_like(p)
        opt = state.opt_state
        sched = self.scheduler
        stopped = False
        sums = {"policy_loss": 0.0, "entropy_loss": 0.0, "kl": 0.0,
                "count": 0.0}
        health = 0
        applied = chunks = 0
        for k in range(mb_idx.shape[0]):
            if stopped and not self.health_enabled:
                break
            idx = mb_idx[k]  # [B, mbs]
            mbs = idx.shape[1]
            w = (torch.gather(valid, 1, idx) & mb_ok[k][None, :]).reshape(-1)
            wf = w.to(torch.float32)
            n = torch.clamp_min(wf.sum(), 1.0)
            adv = torch.gather(advantages, 1, idx).reshape(-1)
            mean = (adv * wf).sum() / n
            var = ((adv - mean) ** 2 * wf).sum() / torch.clamp_min(n - 1, 1.0)
            adv = (adv - mean) / (torch.sqrt(var) + EPS)
            old = torch.gather(ro.lgprob, 1, idx).reshape(-1)
            rows = torch.nonzero(w).reshape(-1)  # the rows with w > 0
            b_of = rows // mbs
            t_of = idx[b_of, rows % mbs]
            for p in params:
                p.grad.zero_()
            pl_sum = torch.zeros((), device=dev)
            ent_sum = torch.zeros((), device=dev)
            kl_sum = torch.zeros((), device=dev)
            for c0 in range(0, rows.numel(), UPDATE_CHUNK):
                q = rows[c0:c0 + UPDATE_CHUNK]
                bb, tt = b_of[c0:c0 + UPDATE_CHUNK], t_of[c0:c0 + UPDATE_CHUNK]
                so = ro.obs.map(lambda a: a[bb, tt])
                feats = sched.features(stored_to_observation(self.bank, so))
                acts = DecimaAction(stage_idx=ro.stage_idx[bb, tt],
                                    job_idx=ro.job_idx[bb, tt],
                                    num_exec=ro.num_exec_k[bb, tt])
                lgp, ent = sched.evaluate_actions(feats, acts)
                log_ratio = lgp - old[q]
                ratio = torch.exp(log_ratio)
                a = adv[q]
                pl1 = a * ratio
                pl2 = a * torch.clamp(ratio, 1 - self.clip_range,
                                      1 + self.clip_range)
                pl = -torch.minimum(pl1, pl2).sum() / n
                el = -ent.sum() / n
                (pl + ent_coeff * el).backward()
                pl_sum = pl_sum + pl.detach()
                ent_sum = ent_sum + el.detach()
                kl_sum = kl_sum + (((ratio - 1) - log_ratio).sum() / n
                                   ).detach()
                chunks += 1
            loss = pl_sum + ent_coeff * ent_sum
            mb_mask = 0
            if self.health_enabled:
                mb_mask = int(grad_health(loss=loss, grads=[
                    p.grad for p in params]))
                if not bool(torch.isfinite(mean) & torch.isfinite(var)):
                    # every row's advantage is non-finite: the JAX loss
                    # (and its gradient) is, whatever rows have weight
                    mb_mask |= H_NONFINITE_LOSS | H_NONFINITE_GRAD
                health |= mb_mask
            if stopped:  # past the KL stop: only its health bits count
                continue
            kl = float(kl_sum)
            stopped = self.target_kl is not None and kl > 1.5 * self.target_kl
            if not stopped and mb_mask == 0:
                opt.step()
                applied += 1
            sums["policy_loss"] += float(pl_sum)
            sums["entropy_loss"] += float(ent_sum)
            sums["kl"] += kl
            sums["count"] += 1.0
        for p in params:
            p.grad = None
        n = max(sums["count"], 1.0)
        stats = {
            "policy_loss": abs(sums["policy_loss"] / n),
            "entropy": abs(sums["entropy_loss"] / n),
            "approx_kl_div": abs(sums["kl"] / n),
            "avg_num_jobs_est": (None if avg_num_jobs is None
                                 else float(avg_num_jobs)),
            "minibatches_applied": float(applied),
            "kl_stopped": float(stopped),
            "update_chunks": float(chunks),
        }
        if self.health_enabled:
            stats["health_mask"] = health | int(grad_health(params=params))
        state.buf = buf
        return state, stats
