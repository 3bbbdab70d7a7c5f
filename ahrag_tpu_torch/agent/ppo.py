"""PPO over batched episodes: clipped surrogate, GAE, on-device rollouts.

Port of ``ahrag_tpu/agent/ppo.py``: PPOConfig defaults (epochs 3, gamma
.99, clip .2, entropy .01, value .5, lr 3e-4, batch 256), GAE(lambda=.95)
with per-episode advantage normalisation, clipped surrogate + value MSE +
entropy bonus, global-norm clip 1.0 and Adam as optax computes them
(``agent/optim.py``), masked sampling at inference.

- ``PPOLearner``: the ``ActorCritic`` on one device with the minibatch
  ``update`` (the same ``np.random.default_rng(seed).permutation`` order as
  the JAX package), ``act_and_logp`` and checkpoints in the port's own
  format (``torch.save`` of CPU tensors and numbers, read back with
  ``weights_only=True``).
- ``ppo_train_device``: ``vec_env.rollout_batch`` + ``gae_device`` +
  ``update`` per batch of episodes; ``ppo_train_multi`` the same over
  ``graph/multi.rollout_multi`` with a terminal recall reward.
- ``make_train_step``: one rollout + GAE + full-batch update as a single
  function on one device (the JAX package's ``make_sharded_train_step``
  without the mesh).

Sampling draws from a ``torch.Generator``; JAX's key stream is not
reproduced. The host-gym loop ``ppo_train`` is not ported (it needs the
gym environment).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.agent.featurizer import OBS_DIM
from ahrag_tpu_torch.agent.optim import Adam
from ahrag_tpu_torch.agent.vec_env import N_ACTIONS, rollout_batch, sample_actions
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.policy.nets import ActorCritic


@dataclass
class PPOConfig:
    epochs: int = 3
    gamma: float = 0.99
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    lr: float = 3e-4
    batch_size: int = 256
    gae_lambda: float = 0.95


def compute_gae(rews: Sequence[float], vals: Sequence[float], dones: Sequence[bool],
                gamma: float = 0.99, lam: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
    """GAE of one episode on the host, with terminal bootstrapping and
    advantage normalisation."""
    n = len(rews)
    adv = np.zeros(n, dtype=np.float32)
    last = 0.0
    for t in reversed(range(n)):
        nonterminal = 0.0 if (t == n - 1 or dones[t]) else 1.0
        next_value = 0.0 if (t == n - 1 or dones[t]) else vals[t + 1]
        delta = rews[t] + gamma * next_value * nonterminal - vals[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
    returns = adv + np.asarray(vals, dtype=np.float32)
    if np.std(adv) > 1e-8:
        adv = (adv - np.mean(adv)) / (np.std(adv) + 1e-8)
    return adv.astype(np.float32), returns.astype(np.float32)


def gae_device(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
               mask: torch.Tensor, gamma: float = 0.99,
               lam: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over ``[B, T]`` trajectories with a live-step mask, on their
    device: ``compute_gae`` per row (bootstrapping ends at done steps and at
    the last live step; advantages normalised within each episode)."""
    B, T = rewards.shape
    nonterminal = torch.cat([mask[:, 1:] & ~dones[:, :-1],
                             torch.zeros_like(mask[:, :1])], dim=1).float()
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    deltas = rewards + gamma * next_values * nonterminal - values
    adv_t, carry = [], torch.zeros_like(rewards[:, 0])
    for t in reversed(range(T)):
        carry = deltas[:, t] + gamma * lam * nonterminal[:, t] * carry
        adv_t.append(carry)
    adv = torch.stack(adv_t[::-1], dim=1) * mask
    returns = adv + values * mask
    m = mask.float()
    denom = m.sum(dim=1, keepdim=True).clamp(min=1.0)
    mean = (adv * m).sum(dim=1, keepdim=True) / denom
    std = torch.sqrt((((adv - mean) ** 2) * m).sum(dim=1, keepdim=True) / denom)
    adv = torch.where(std > 1e-8, (adv - mean) / (std + 1e-8), adv) * mask
    return adv, returns


def _device_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)


def _average(x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return x.mean()
    return (x * weight).sum() / weight.sum().clamp(min=1.0)


def ppo_loss(model: ActorCritic, cfg: PPOConfig, obs: torch.Tensor,
             actions: torch.Tensor, old_logp: torch.Tensor, returns: torch.Tensor,
             adv: torch.Tensor, weight: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, [policy, value, entropy]): the clipped surrogate, value MSE and
    entropy bonus, as means over the rows or, given ``weight``, weighted by
    it (the full-batch step's live mask)."""
    logits, value = model(obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, actions.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    policy_loss = -_average(torch.minimum(ratio * adv, clipped), weight)
    value_loss = _average((value - returns) ** 2, weight)
    entropy = _average(-(torch.exp(logp_all) * logp_all).sum(dim=-1), weight)
    loss = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy
    return loss, torch.stack([policy_loss, value_loss, entropy]).detach()


class PPOLearner:
    """``ActorCritic`` + optax-equivalent Adam with a minibatch update."""

    def __init__(self, in_dim: int, n_actions: int, cfg: Optional[PPOConfig] = None,
                 seed: int = 0, device=None) -> None:
        self.cfg = cfg or PPOConfig()
        self.in_dim = in_dim
        self.n_actions = n_actions
        self.device = resolve_device(device)
        self.model = ActorCritic(in_dim, n_actions, seed=seed, device=self.device)
        self.opt = Adam(self.model.parameters(), self.cfg.lr, max_norm=1.0)

    # -------------------------------------------------------------- update
    def update(self, obs, actions, old_logp, returns, adv, seed: int = 0) -> Dict[str, float]:
        """``cfg.epochs`` passes over the rows (numpy arrays or tensors) in
        minibatches of ``cfg.batch_size``, shuffled by
        ``np.random.default_rng(seed)``; returns the row-weighted mean
        losses."""
        obs, old_logp, returns, adv = (_device_tensor(x, self.device, torch.float32)
                                       for x in (obs, old_logp, returns, adv))
        actions = _device_tensor(actions, self.device, torch.int64)
        n = obs.shape[0]
        rng = np.random.default_rng(seed)
        total = torch.zeros(3, device=self.device)
        for _ in range(self.cfg.epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for i in range(0, n, self.cfg.batch_size):
                b = perm[i:i + self.cfg.batch_size]
                self.opt.zero_grad()
                loss, aux = ppo_loss(self.model, self.cfg, obs[b], actions[b],
                                     old_logp[b], returns[b], adv[b])
                loss.backward()
                self.opt.step()
                total += aux * b.shape[0]
        pl, vl, ent = (total / max(1, n * self.cfg.epochs)).tolist()
        return {"policy": pl, "value": vl, "entropy": ent}

    # -------------------------------------------------------------- sampling
    @torch.no_grad()
    def act_and_logp(self, obs_vec, mask=None, seed: int = 0) -> Tuple[int, float, float]:
        obs = _device_tensor(obs_vec, self.device, torch.float32).reshape(1, -1)
        logits, value = self.model(obs)
        if mask is not None:
            keep = _device_tensor(mask, self.device, torch.float32).reshape(1, -1) > 0.5
            logits = torch.where(keep, logits, -1e9)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        a = int(sample_actions(logits, gen)[0])
        return a, float(torch.log_softmax(logits[0], dim=-1)[a]), float(value[0])

    # ------------------------------------------------------------ checkpoint
    def _params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({"params": self._params(), "in_dim": self.in_dim,
                    "n_actions": self.n_actions}, path)

    @classmethod
    def load(cls, path: str, cfg: Optional[PPOConfig] = None, device=None) -> "PPOLearner":
        payload = torch.load(path, map_location="cpu", weights_only=True)
        learner = cls(int(payload["in_dim"]), int(payload["n_actions"]), cfg, device=device)
        learner.model.load_state_dict(payload["params"])
        return learner

    def save_training_state(self, path: str, progress: Dict[str, Any]) -> None:
        """Params, optimizer state and loop progress, for a mid-training resume."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({"params": self._params(), "opt_state": self.opt.state_dict(),
                    "in_dim": self.in_dim, "n_actions": self.n_actions,
                    "progress": progress}, path)

    def restore_training_state(self, path: str) -> Dict[str, Any]:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if int(payload["in_dim"]) != self.in_dim:
            raise ValueError(f"checkpoint in_dim {payload['in_dim']} != {self.in_dim}")
        self.model.load_state_dict(payload["params"])
        self.opt.load_state_dict(payload["opt_state"])
        return dict(payload.get("progress") or {})


def load_ppo(path: str, device=None) -> PPOLearner:
    return PPOLearner.load(path, device=device)


def act_ppo(learner: PPOLearner, obs_vec, mask=None, seed: int = 0) -> int:
    """Masked inference-time sampling."""
    return learner.act_and_logp(obs_vec, mask=mask, seed=seed)[0]


# --------------------------------------------------------------------- train
def make_train_step(learner: PPOLearner, w, max_steps: int = 6, top_k: int = 5,
                    member_top_m: int = 5) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(gt, q_embs, generator=None) -> metrics``: batched
    rollouts, device GAE and ONE full-batch clipped-surrogate update of
    ``learner`` (losses weighted by the live-step mask). The metrics stay on
    the device; nothing waits for it."""
    cfg = learner.cfg

    def train_step(gt, q_embs: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        traj, _ = rollout_batch(gt, q_embs, learner.model, w, max_steps=max_steps,
                                top_k=top_k, member_top_m=member_top_m,
                                generator=generator)
        adv, ret = gae_device(traj.rewards, traj.values, traj.dones, traj.mask,
                              cfg.gamma, cfg.gae_lambda)
        learner.opt.zero_grad()
        loss, aux = ppo_loss(learner.model, cfg, traj.obs.reshape(-1, traj.obs.shape[-1]),
                             traj.actions.reshape(-1), traj.logps.reshape(-1),
                             ret.reshape(-1), adv.reshape(-1),
                             weight=traj.mask.reshape(-1).float())
        loss.backward()
        learner.opt.step()
        mean_reward = (traj.rewards * traj.mask).sum() / traj.mask.any(dim=1).sum().clamp(min=1)
        return {"policy_loss": aux[0], "value_loss": aux[1], "entropy": aux[2],
                "mean_ep_reward": mean_reward}

    return train_step


def _update_live(learner: PPOLearner, traj, adv: torch.Tensor, ret: torch.Tensor,
                 seed: int) -> Optional[Dict[str, float]]:
    """``learner.update`` over the live steps of a trajectory batch, or None
    when no step was live."""
    live = traj.mask.reshape(-1)
    if not bool(live.any()):
        return None
    return learner.update(traj.obs.reshape(-1, traj.obs.shape[-1])[live],
                          traj.actions.reshape(-1)[live], traj.logps.reshape(-1)[live],
                          ret.reshape(-1)[live], adv.reshape(-1)[live], seed=seed)


def _write_curve(path: str, curve: List[Dict[str, Any]], **meta) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    first = float(np.mean([c["mean_ep_reward"] for c in curve[:3]])) if curve else 0.0
    last = float(np.mean([c["mean_ep_reward"] for c in curve[-3:]])) if curve else 0.0
    with open(path, "w") as f:
        json.dump({"n_updates": len(curve), **meta, "first3_mean_ep_reward": first,
                   "last3_mean_ep_reward": last, "improvement": last - first,
                   "curve": curve}, f, indent=1)


def ppo_train_device(gt, q_embs, search_weights, n_updates: int = 10,
                     max_steps: int = 6, batch_size: int = 16,
                     ppo_cfg: Optional[PPOConfig] = None,
                     save_path: Optional[str] = None, top_k: int = 5,
                     member_top_m: int = 5, seed: int = 0,
                     log: Callable[[str], None] = print,
                     curve_out: Optional[str] = None) -> PPOLearner:
    """PPO on the graph's device: each update draws ``batch_size`` of the
    pre-encoded ``q_embs [N, D]``, rolls those episodes out with
    ``rollout_batch`` and updates on their live steps. ``curve_out`` writes
    the per-update learning curve as JSON."""
    cfg = ppo_cfg or PPOConfig()
    dev = gt.device
    learner = PPOLearner(OBS_DIM, N_ACTIONS, cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q_all = _device_tensor(q_embs, dev, torch.float32)
    curve: List[Dict[str, Any]] = []
    for u in range(n_updates):
        idx = torch.randint(0, q_all.shape[0], (batch_size,), generator=gen, device=dev)
        traj, _ = rollout_batch(gt, q_all[idx], learner.model, search_weights,
                                max_steps=max_steps, top_k=top_k,
                                member_top_m=member_top_m, generator=gen)
        adv, ret = gae_device(traj.rewards, traj.values, traj.dones, traj.mask,
                              cfg.gamma, cfg.gae_lambda)
        losses = _update_live(learner, traj, adv, ret, seed + u)
        if losses is None:
            continue
        ep_reward = float((traj.rewards * traj.mask).sum()
                          / traj.mask.any(dim=1).sum().clamp(min=1))
        log(f"[PPO/device] update={u} mavg_ep_reward={ep_reward:.3f} loss={losses}")
        curve.append({"update": u, "mean_ep_reward": ep_reward, **losses})
    if curve_out:
        _write_curve(curve_out, curve, batch_size=batch_size, max_steps=max_steps,
                     seed=seed)
    if save_path:
        learner.save(save_path)
    return learner


def ppo_train_multi(bgts, q_embs, search_weights, gold_masks=None,
                    n_updates: int = 30, max_steps: int = 6,
                    ppo_cfg: Optional[PPOConfig] = None,
                    save_path: Optional[str] = None, top_k: int = 5,
                    member_top_m: int = 5, seed: int = 0,
                    final_reward_weight: float = 4.0,
                    log: Callable[[str], None] = print,
                    curve_out: Optional[str] = None) -> PPOLearner:
    """PPO across a stack of per-question graphs: each update runs one
    episode per graph through ``rollout_multi``. ``gold_masks [G, N_pad]``
    adds a terminal reward on each episode's last live step,
    ``final_reward_weight * recall(final selection, gold nodes)``."""
    from ahrag_tpu_torch.graph.multi import rollout_multi

    cfg = ppo_cfg or PPOConfig()
    dev = bgts.device
    learner = PPOLearner(OBS_DIM, N_ACTIONS, cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gold = None if gold_masks is None else _device_tensor(gold_masks, dev, torch.bool)
    q_dev = _device_tensor(q_embs, dev, torch.float32)
    G = q_dev.shape[0]
    curve: List[Dict[str, Any]] = []
    for u in range(n_updates):
        traj, final = rollout_multi(bgts, q_dev, learner.model, search_weights,
                                    max_steps=max_steps, top_k=top_k,
                                    member_top_m=member_top_m, generator=gen)
        rewards, recall = traj.rewards, None
        if gold is not None:
            n_gold = gold.sum(dim=1)
            hit = (final.selection & gold).sum(dim=1)
            recall = torch.where(n_gold > 0, hit / n_gold.clamp(min=1), 0.0)
            # credit the last live step of each episode
            t_last = (traj.mask.sum(dim=1) - 1).clamp(min=0)
            bonus = torch.zeros_like(rewards).scatter(
                1, t_last[:, None], (final_reward_weight * recall)[:, None])
            rewards = rewards + bonus * traj.mask
        adv, ret = gae_device(rewards, traj.values, traj.dones, traj.mask,
                              cfg.gamma, cfg.gae_lambda)
        losses = _update_live(learner, traj, adv, ret, seed + u)
        if losses is None:
            continue
        entry = {"update": u,
                 "mean_ep_reward": float((rewards * traj.mask).sum() / max(1, G)),
                 **losses}
        if recall is not None:
            entry["mean_final_recall"] = float(recall.mean())
        curve.append(entry)
        log(f"[PPO/multi] update={u} ep_reward={entry['mean_ep_reward']:.3f} "
            f"recall={entry.get('mean_final_recall', float('nan')):.3f}")
    if curve_out:
        _write_curve(curve_out, curve, n_graphs=G, max_steps=max_steps, seed=seed,
                     final_reward_weight=final_reward_weight)
    if save_path:
        learner.save(save_path)
    return learner
