"""Retrieval-knob policy: a per-question choice among knob configs that
change what ``InferenceEngine.run_inference(knobs=...)`` retrieves
(rescue-pool width, evidence caps, hop budget).

The port's copy of ``ahrag_tpu/agent/knob_policy.py``. The pipeline is
deterministic given (question, graph, knobs), so one sweep per item per
config is complete bandit feedback (a ``knob_rewards_*`` matrix), and the
policy trains with the clipped-PPO objective over single-step episodes:
state = question features, action = config id, reward = the item's F1 under
that config, advantage = reward - V(state), normalised over the batch.

- ``train_knob_policy``: the port's ``ActorCritic(hidden=32)`` and ``Adam``
  (``optax.adam`` as optax computes it, no clipping); each step samples one
  config per item from a ``torch.Generator`` (``knob_policy_step`` also takes
  the actions from its caller). The checkpoint is the port's own
  (``torch.save``).
- ``load_knob_policy``: a predictor from either that file or the JAX
  package's flax msgpack file (``checkpoints/knob_policy_v6.msgpack``),
  chosen by the file's leading bytes; the choice is the argmax of the logits.
- ``evaluate_policy``: ``ppo_minus_rule`` on a held-out matrix with a
  bootstrap CI, as the JAX package computes it.
"""
from __future__ import annotations

import functools
import io
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.agent.optim import Adam
from ahrag_tpu_torch.agent.ppo import PPOConfig
from ahrag_tpu_torch.agent.vec_env import sample_actions
from ahrag_tpu_torch.convert import policy_params_from_numpy
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.policy.nets import ActorCritic
from ahrag_tpu_torch.utils import flax_msgpack

#: index-aligned with the configs of the knob_rewards matrices
CONFIG_KNOBS: List[Dict[str, int]] = [
    {},
    {"rescue_top_n": 0, "rescue_clause_top_n": 0},
    {"rescue_top_n": 6, "rescue_clause_top_n": 3},
    {"max_entities": 9, "max_summaries": 4},
    {"max_entities": 3, "max_summaries": 2, "hops": 1},
    {"rescue_top_n": 6, "rescue_clause_top_n": 3, "max_entities": 9,
     "hops": 3},
]
N_CONFIGS = len(CONFIG_KNOBS)
N_FEATURES = 16
HIDDEN = 32

_TOKEN_RE = re.compile(r"[A-Za-z0-9][\w']*")
_CAP_RUN_RE = re.compile(r"\b[A-Z][\w']*(?:\s+[A-Z][\w']*)+\b")
_YEAR_WORD_RE = re.compile(r"\b(?:year|when)\b", re.IGNORECASE)


def featurize_question(q: str) -> np.ndarray:
    """Question-shape features: generic structure, no relation vocabulary."""
    toks = _TOKEN_RE.findall(q)
    low = [t.lower() for t in toks]
    caps = [t for t in toks if t[:1].isupper()]
    cap_runs = _CAP_RUN_RE.findall(q)
    n = max(1, len(toks))
    f = np.zeros(N_FEATURES, np.float32)
    f[0] = min(len(toks), 24) / 24.0
    f[1] = len(caps) / n
    f[2] = min(len(cap_runs), 3) / 3.0
    f[3] = float(low[0] in ("who", "whom") if low else 0.0)
    f[4] = float(bool(_YEAR_WORD_RE.search(q)))
    f[5] = float(low[0] in ("what", "which") if low else 0.0)
    f[6] = float(low[0] in ("where",) if low else 0.0)
    f[7] = float(low[0] in ("how",) if low else 0.0)
    f[8] = float("?" in q)
    f[9] = float(any(t in ("of", "by") for t in low))
    f[10] = float(any(t == "the" for t in low[:3]))  # descriptor-led subject
    f[11] = min(sum(1 for t in low if len(t) > 7), 4) / 4.0
    f[12] = float(len(cap_runs) == 0)   # no named anchor at all
    f[13] = float(len(cap_runs) >= 2)   # multi-anchor (comparison/bridge)
    f[14] = min(len(q), 120) / 120.0
    f[15] = 1.0                         # bias
    return f


def knob_policy_step(model: ActorCritic, opt: Adam, x: torch.Tensor,
                     rewards: torch.Tensor, cfg: PPOConfig,
                     actions: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One clipped-surrogate update over every item: ``actions [N]`` (one
    config per item, drawn from the current policy with ``generator`` unless
    given), advantage = reward - V normalised over the batch, Adam on the
    mean losses. Returns (actions, mean reward of the actions)."""
    rows = torch.arange(x.shape[0], device=x.device)
    with torch.no_grad():
        logits, values = model(x)
        if actions is None:
            actions = sample_actions(logits, generator)
        actions = actions.to(x.device).long()
        logp_old = torch.log_softmax(logits, dim=-1)[rows, actions]
        rew = rewards[rows, actions]
        adv = rew - values
        adv_n = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    opt.zero_grad()
    lg, v = model(x)
    lp_all = torch.log_softmax(lg, dim=-1)
    ratio = torch.exp(lp_all[rows, actions] - logp_old)
    s1 = ratio * adv_n
    s2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pol = -torch.minimum(s1, s2).mean()
    vloss = ((v - rew) ** 2).mean()
    ent = -(torch.softmax(lg, dim=-1) * lp_all).sum(dim=1).mean()
    (pol + cfg.value_coef * vloss - cfg.entropy_coef * ent).backward()
    opt.step()
    return actions, rew.mean()


def train_knob_policy(matrix_path: str, out_path: str, seed: int = 7,
                      steps: int = 400, lr: float = 0.05, device=None) -> Dict[str, float]:
    """Fit the config policy on a knob reward matrix (train split) on
    ``device`` (``cuda`` unless named): ``steps`` updates of
    ``knob_policy_step``. Returns the greedy policy's, the default config's
    and the oracle's mean train F1."""
    dev = resolve_device(device)
    with open(matrix_path, encoding="utf-8") as fh:
        items = json.load(fh)["items"]
    feats = np.stack([featurize_question(r["question"]) for r in items])
    rewards = np.asarray([[c["f1"] / 100.0 for c in r["configs"]] for r in items],
                         np.float32)                    # [N, C]
    model = ActorCritic(N_FEATURES, N_CONFIGS, hidden=HIDDEN, seed=seed, device=dev)
    cfg = PPOConfig(lr=lr, entropy_coef=0.02, epochs=1)
    opt = Adam(model.parameters(), cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.from_numpy(feats).to(dev)
    r_all = torch.from_numpy(rewards).to(dev)
    for _ in range(steps):
        knob_policy_step(model, opt, x, r_all, cfg, generator=gen)
    with torch.no_grad():
        greedy = torch.argmax(model(x)[0], dim=1).cpu().numpy()
    train_f1 = float(np.mean(rewards[np.arange(len(items)), greedy]) * 100)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "n_features": N_FEATURES, "n_configs": N_CONFIGS, "hidden": HIDDEN},
               out_path)
    return {"train_policy_f1": round(train_f1, 2),
            "train_default_f1": round(float(rewards[:, 0].mean() * 100), 2),
            "train_oracle_f1": round(float(rewards.max(axis=1).mean() * 100), 2)}


def _policy_params(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The ``ActorCritic`` state dict of a knob-policy file: the JAX
    package's flax msgpack (``{"params": {layer: {kernel, bias}}}``) or the
    port's ``torch.save``."""
    with open(ckpt_path, "rb") as f:
        data = f.read()
    if flax_msgpack.is_msgpack_map(data[:1]):
        return policy_params_from_numpy(flax_msgpack.restore(data)["params"])
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)["params"]


@functools.lru_cache(maxsize=4)
def _load(ckpt_path: str, device: str) -> Callable[[str], Dict[str, int]]:
    dev = torch.device(device)
    model = ActorCritic(N_FEATURES, N_CONFIGS, hidden=HIDDEN, device=dev)
    model.load_state_dict(_policy_params(ckpt_path))

    @torch.no_grad()
    def predict(question: str) -> Dict[str, int]:
        x = torch.from_numpy(featurize_question(question)[None]).to(dev)
        return CONFIG_KNOBS[int(torch.argmax(model(x)[0][0]))]

    return predict


def load_knob_policy(ckpt_path: str, device=None) -> Callable[[str], Dict[str, int]]:
    """``predict(question) -> knobs dict`` from a trained checkpoint, on
    ``device`` (``cuda`` unless named); cached per (path, device)."""
    return _load(ckpt_path, str(resolve_device(device)))


def evaluate_policy(matrix_path: str, ckpt_path: str, n_boot: int = 2000,
                    seed: int = 3, device=None) -> Dict[str, object]:
    """ppo_minus_rule on a held-out matrix, with a bootstrap CI."""
    predict = load_knob_policy(ckpt_path, device=device)
    with open(matrix_path, encoding="utf-8") as fh:
        items = json.load(fh)["items"]
    deltas = []
    pol_f1, def_f1 = [], []
    for r in items:
        ci = CONFIG_KNOBS.index(predict(r["question"]))
        pol_f1.append(r["configs"][ci]["f1"])
        def_f1.append(r["configs"][0]["f1"])
        deltas.append(pol_f1[-1] - def_f1[-1])
    deltas = np.asarray(deltas)
    rng = np.random.default_rng(seed)
    boots = [float(deltas[rng.integers(0, len(deltas), len(deltas))].mean())
             for _ in range(n_boot)]
    lo, hi = np.percentile(boots, [2.5, 97.5])
    return {"n": len(items),
            "policy_f1": round(float(np.mean(pol_f1)), 2),
            "default_f1": round(float(np.mean(def_f1)), 2),
            "ppo_minus_rule": round(float(deltas.mean()), 3),
            "ci95": [round(float(lo), 3), round(float(hi), 3)]}
