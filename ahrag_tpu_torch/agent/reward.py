"""Reward functions (port of ``ahrag_tpu/agent/reward.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch


def step_reward(prev_obs: Dict[str, Any] | None, cur_obs: Dict[str, Any]) -> float:
    """+1.0 per new selection, +0.05 per new frontier item (capped at 10), -0.05 step."""
    if prev_obs is None:
        return 0.0
    prev_state = prev_obs.get("state") or {}
    cur_state = cur_obs.get("state") or {}
    prev_sel = set(prev_state.get("selection_ids") or [])
    cur_sel = set(cur_state.get("selection_ids") or [])
    add_sel = len(cur_sel - prev_sel)
    add_frontier = max(0, len(cur_state.get("frontier_ids") or [])
                       - len(prev_state.get("frontier_ids") or []))
    return float(1.0 * add_sel + 0.05 * min(add_frontier, 10) - 0.05)


def step_reward_device(prev_sel_size: torch.Tensor, cur_sel_size: torch.Tensor,
                       prev_frontier_size: torch.Tensor,
                       cur_frontier_size: torch.Tensor) -> torch.Tensor:
    """Device variant over set sizes (selection only ever grows, so the size
    delta equals the new-unique count, matching the host formula)."""
    add_sel = (cur_sel_size - prev_sel_size).clamp(min=0).float()
    add_frontier = (cur_frontier_size - prev_frontier_size).clamp(min=0)
    return 1.0 * add_sel + 0.05 * add_frontier.clamp(max=10).float() - 0.05


def final_reward(metrics: Dict[str, float]) -> float:
    """0.4*f1 + 0.3*faithfulness + 0.2*answer_relevancy + 0.1*contextual_recall."""
    return (0.4 * float(metrics.get("f1", 0.0))
            + 0.3 * float(metrics.get("faithfulness", 0.0))
            + 0.2 * float(metrics.get("answer_relevancy", 0.0))
            + 0.1 * float(metrics.get("contextual_recall", 0.0)))
