"""Observation featurizer: the fixed 84-dim policy input vector.

Port of ``ahrag_tpu/agent/featurizer.py``: 4 globals (step, selection_size,
frontier_size, n_seeds) followed by 10 node blocks of 8 dims (entity /
summary / other one-hot, layer, score, semantic, judge, confidence),
zero-padded. ``featurize_observation`` reads a host observation dict (numpy);
``featurize_device`` builds the same layout from ``[B, K_NODES]`` tensors,
with the leading batch dimension the JAX version took from ``vmap``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

K_NODES = 10
NODE_FEATS = 8
OBS_DIM = 4 + K_NODES * NODE_FEATS  # 84


def _node_feats(n: Dict[str, Any]) -> List[float]:
    nt = str(n.get("node_type") or "")
    return [
        1.0 if nt == "entity" else 0.0,
        1.0 if nt == "summary" else 0.0,
        1.0 if nt not in {"entity", "summary"} else 0.0,
        float(n.get("layer") or 0),
        float(n.get("score") or 0.0),
        float(n.get("semantic") or 0.0),
        float(n.get("judge_overall") or 0.0),
        float(n.get("confidence") or 0.0),
    ]


def featurize_observation(obs: Dict[str, Any],
                          k_nodes: int = K_NODES) -> Tuple[np.ndarray, Dict[str, Any]]:
    state = obs.get("state") or {}
    feats: List[float] = [
        float(obs.get("step") or 0),
        float(len(state.get("selection_ids") or [])),
        float(len(state.get("frontier_ids") or [])),
        float(len(obs.get("seeds") or [])),
    ]
    sel = (obs.get("selection") or [])[:k_nodes]
    node_ids = []
    for n in sel:
        feats.extend(_node_feats(n))
        node_ids.append(str(n.get("node_id")))
    feats.extend([0.0] * (NODE_FEATS * (k_nodes - len(sel))))
    return np.asarray(feats, dtype=np.float32), {"top_node_ids": node_ids}


def featurize_device(step: torch.Tensor, selection_size: torch.Tensor,
                     frontier_size: torch.Tensor, n_seeds: torch.Tensor,
                     top_valid: torch.Tensor, top_type: torch.Tensor,
                     top_layer: torch.Tensor, top_score: torch.Tensor,
                     top_sem: torch.Tensor, top_judge: torch.Tensor,
                     top_conf: torch.Tensor) -> torch.Tensor:
    """``[B, OBS_DIM]`` observations from ``[B]`` globals and ``[B, K_NODES]``
    per-node tensors. ``top_type`` uses GraphTensors ids (0 entity / 1
    summary / 2 other); invalid slots (``top_valid`` false) contribute
    all-zero blocks, matching host padding."""
    v = top_valid.float()
    blocks = torch.stack([
        v * (top_type == 0), v * (top_type == 1), v * (top_type >= 2),
        v * top_layer.float(), v * top_score, v * top_sem,
        v * top_judge, v * top_conf,
    ], dim=2)  # [B, K_NODES, 8]
    head = torch.stack([step.float(), selection_size.float(),
                        frontier_size.float(), n_seeds.float()], dim=1)
    return torch.cat([head, blocks.reshape(blocks.shape[0], -1)], dim=1)
