"""Behaviour cloning on trajectory JSONL (port of ``ahrag_tpu/agent/bc.py``).

Trains the 2 x 128 MLP policy with cross-entropy on (obs_vec, action) pairs
and ``optax.adam(lr)`` as optax computes it (``agent/optim.py``), minibatches
in ``np.random.default_rng(seed).permutation`` order as in the JAX package.
Checkpoints are the port's own: ``torch.save`` of ``{params, in_dim,
n_actions}`` with CPU tensors, read back with ``weights_only=True``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.agent.optim import Adam
from ahrag_tpu_torch.agent.vec_env import sample_actions
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.policy.nets import MLPPolicy
from ahrag_tpu_torch.utils.parse import json_or_none


def load_trajectories(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, OBS_DIM] float32, y [n] int64) from the steps of every
    trajectory line; lines that do not parse are skipped."""
    X: List[List[float]] = []
    y: List[int] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            obj = json_or_none(line)
            if not isinstance(obj, dict):
                continue
            for s in obj.get("steps", []):
                vec = s.get("obs_vec") or []
                act = s.get("action")
                if isinstance(act, int) and vec:
                    X.append([float(v) for v in vec])
                    y.append(int(act))
    if not X:
        raise RuntimeError("No (obs_vec, action) pairs found in trajectories")
    return np.asarray(X, dtype=np.float32), np.asarray(y, dtype=np.int64)


def bc_step(model: MLPPolicy, opt: Adam, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """One update on a minibatch; returns its mean cross-entropy."""
    opt.zero_grad()
    loss = torch.nn.functional.cross_entropy(model(xb), yb)
    loss.backward()
    opt.step()
    return loss.detach()


def train_bc(traj_path: str, out_path: str, epochs: int = 5, lr: float = 1e-3,
             n_actions: int = 6, batch_size: int = 256, seed: int = 0,
             device=None) -> dict:
    dev = resolve_device(device)         # refuse before reading anything
    X, y = load_trajectories(traj_path)
    in_dim = X.shape[1]
    model = MLPPolicy(in_dim, n_actions, seed=seed, device=dev)
    opt = Adam(model.parameters(), lr)
    xs, ys = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    history = []
    for _ in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        total = torch.zeros((), device=dev)
        for i in range(0, n, batch_size):
            b = perm[i:i + batch_size]
            total += bc_step(model, opt, xs[b], ys[b]) * b.shape[0]
        history.append(float(total) / max(1, n))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "in_dim": in_dim, "n_actions": n_actions}, out_path)
    return {"epochs": epochs, "final_loss": history[-1], "history": history,
            "n_samples": int(n)}


def load_bc(path: str, device=None) -> Tuple[Callable, Dict[str, int]]:
    """Returns (apply_fn(obs [B, D]) -> logits on the model's device, meta)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = {"in_dim": int(payload["in_dim"]), "n_actions": int(payload["n_actions"])}
    dev = resolve_device(device)
    model = MLPPolicy(meta["in_dim"], meta["n_actions"], device=dev)
    model.load_state_dict(payload["params"])

    @torch.no_grad()
    def apply_fn(obs) -> torch.Tensor:
        if not isinstance(obs, torch.Tensor):
            obs = torch.from_numpy(np.asarray(obs, np.float32))
        return model(obs.to(dev))

    return apply_fn, meta


def act_bc(apply_fn, obs_vec, seed: int = 0) -> int:
    logits = apply_fn(np.asarray(obs_vec, np.float32).reshape(1, -1))
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    return int(sample_actions(logits, gen)[0])
