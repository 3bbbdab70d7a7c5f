"""The optimizer the JAX package's agents train with, as optax computes it.

``Adam(params, lr, max_norm=1.0)`` is ``optax.chain(clip_by_global_norm(1.0),
adam(lr))`` (PPO); ``max_norm=None`` is ``optax.adam(lr)`` (BC). Written
out rather than ``torch.optim.Adam`` + ``clip_grad_norm_``: torch's clip
divides by ``norm + 1e-6`` and scales whenever the norm exceeds the limit,
optax divides by the norm itself and leaves gradients alone when the norm is
below it. Adam is optax's ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 added
outside the square root, bias-corrected moments) followed by ``-lr``.
With ``weight_decay`` and a schedule for ``lr`` it is ``optax.adamw(schedule,
weight_decay)`` (the span reader's trainer): ``weight_decay * param`` is added
to the Adam update, and the schedule is read at the count of updates made
before this one (so optax's first step takes ``schedule(0)``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class Adam:
    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Callable[[int], float]],
                 max_norm: Optional[float] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0) -> None:
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``; no host sync."""
        grads = [p.grad for p in self.params]
        if self.max_norm is not None:
            g_norm = global_norm(grads)
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm) for g in grads]
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(-lr * update)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": [m.cpu() for m in self.mu],
                "nu": [n.cpu() for n in self.nu]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps``, held there."""
    alpha = end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)
    return schedule
