"""Per-question KG fleets for multi-graph RL training.

The port's copy of ``ahrag_tpu/agent/fleet.py``: each graph is built by the
port's pipeline on ``device`` (``cuda`` unless told otherwise) and the stack
lives there.

The reference trains PPO by stepping n_envs Python environments sequentially
over ONE shared graph (policy_ppo.py:144-215). The TPU-native form (SURVEY
§7.3.7, VERDICT r1 item 8): build one small KG per training question — the
exact per-question-graph regime the benchmark evaluates in
(run_benchmark.py:68-104) — pad/stack them into BatchedGraphTensors, and run
one vmapped (graph, query) rollout per episode batch.

Also derives per-graph GOLD NODE MASKS from the items' ``gold_titles`` so
episode returns can carry a terminal retrieval-recall reward — the
device-computable analogue of ``reward.final_reward`` (reward.py:33; defined
but never wired into returns in either repo or reference).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.graph.multi import BatchedGraphTensors, stack_graph_tensors


def gold_node_mask(hg: Any, gold_titles: Sequence[str], n_pad: int) -> np.ndarray:
    """[n_pad] bool: nodes whose text matches any gold title (the same
    matching the recall@k metric uses — eval/retrieval.py)."""
    from ahrag_tpu_torch.eval.retrieval import _matches, node_texts

    mask = np.zeros(n_pad, dtype=bool)
    golds = [g for g in gold_titles if g]
    if not golds:
        return mask
    for nid in hg.nodes:
        idx = hg.id_to_idx(nid)
        if idx < 0 or idx >= n_pad:
            continue
        texts = node_texts(hg, nid)
        if any(_matches(g, t) for g in golds for t in texts):
            mask[idx] = True
    return mask


def build_question_fleet(items: Sequence[Dict[str, Any]],
                         encoder_name: Optional[str] = None,
                         workdir: Optional[str] = None,
                         log=print, device=None) -> Tuple[BatchedGraphTensors, np.ndarray,
                                                          np.ndarray, List[Dict[str, Any]]]:
    """One KG per item (built via the production pipeline), stacked.

    Returns (batched tensors [G, ...], query embeddings [G, D], gold masks
    [G, N_pad], metas). Items need ``question`` + ``context``; ``gold_titles``
    optional (empty mask when absent).
    """
    from ahrag_tpu_torch.cli.benchmark import build_question_graph

    device = resolve_device(device)
    gts, q_vecs, golds, metas = [], [], [], []
    hgs = []
    for i, item in enumerate(items):
        with tempfile.TemporaryDirectory(dir=workdir) as wd:
            hg = build_question_graph(item["context"], workdir=wd,
                                      encoder_name=encoder_name, device=device)
        gt = hg.tensors()
        hgs.append(hg)
        gts.append(gt)
        q_vecs.append(hg.encode_query([item["question"]])[0])
        metas.append({"id": item.get("id", i), "question": item["question"],
                      "n_nodes": hg.number_of_nodes()})
        if (i + 1) % 8 == 0:
            log(f"[fleet] built {i + 1}/{len(items)} KGs")
    b = stack_graph_tensors(gts)
    n_pad = b.n_pad
    for hg, item in zip(hgs, items):
        golds.append(gold_node_mask(hg, item.get("gold_titles") or [], n_pad))
    return (b, np.stack(q_vecs).astype(np.float32),
            np.stack(golds), metas)
