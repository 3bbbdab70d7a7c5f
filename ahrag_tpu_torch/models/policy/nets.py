"""Policy networks for BC and PPO (port of ``ahrag_tpu/models/policy/nets.py``).

BC is a 2 x 128 ReLU MLP to 6 logits; PPO an actor (2 x 128) and a critic
(1 x 128) that share nothing. Layer names are the flax modules' own
(``Dense_0..2``; ``actor_fc1``, ``actor_fc2``, ``actor_out``, ``critic_fc1``,
``critic_out``), so a flax param tree maps onto the ``state_dict`` by name
(``convert.policy_params_from_numpy``).

Initialisation is flax's: kernels ``lecun_normal`` (a normal truncated to
two standard deviations, scaled so that the variance is 1/fan_in), biases
zero, drawn from an explicit CPU ``torch.Generator`` seeded by ``seed`` and
then moved to the device, so the card and the CPU start from the same
weights. torch's default ``Linear`` init is another distribution.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ahrag_tpu_torch.device import resolve_device

# stddev of a standard normal truncated to (-2, 2) (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax's default Dense init in place: truncated-normal kernel with
    variance 1/fan_in, zero bias."""
    std = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        layer.bias.zero_()


def _init(module: nn.Module, seed: int, device) -> None:
    gen = torch.Generator().manual_seed(seed)
    for layer in module.children():
        lecun_normal_(layer, gen)
    module.to(resolve_device(device))


class MLPPolicy(nn.Module):
    def __init__(self, in_dim: int, n_actions: int = 6, hidden: int = 128,
                 seed: int = 0, device=None) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, n_actions)
        _init(self, seed, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


class ActorCritic(nn.Module):
    def __init__(self, in_dim: int, n_actions: int = 6, hidden: int = 128,
                 seed: int = 0, device=None) -> None:
        super().__init__()
        self.actor_fc1 = nn.Linear(in_dim, hidden)
        self.actor_fc2 = nn.Linear(hidden, hidden)
        self.actor_out = nn.Linear(hidden, n_actions)
        self.critic_fc1 = nn.Linear(in_dim, hidden)
        self.critic_out = nn.Linear(hidden, 1)
        _init(self, seed, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a = torch.relu(self.actor_fc1(x))
        a = torch.relu(self.actor_fc2(a))
        logits = self.actor_out(a)
        c = torch.relu(self.critic_fc1(x))
        return logits, self.critic_out(c).squeeze(-1)
