"""Many small graphs as one batch: stacked GraphTensors, search and rollouts.

Port of ``ahrag_tpu/graph/multi.py``. Per-question graphs are padded to a
common shape and stacked along a leading graph axis, and one query per graph
is searched, or one episode per graph rolled out, as one batch.

- ``hybrid_search_multi``: the seed stage takes one batched float32 product
  (``bmm``) where the stacked graphs have fewer than 4,096 rows, as the full
  float32 product the JAX package took there, and otherwise runs
  ``refined_masked_topk`` graph by graph (the kernel path of
  ``hybrid_search_batch`` on the card). Expansion, filter and rerank then
  run once for all graphs, over the stack viewed as one graph of G * N_pad
  nodes (adjacency ids offset by each graph's first row).
- ``rollout_multi``: the batched environment of ``agent/vec_env.py`` with
  one lane per graph, each lane reading its own graph.

Stacking only grows each graph's padding (extra rows are invalid and
unindexed), so each graph's results equal ``hybrid_search_batch`` on that
graph alone.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from ahrag_tpu_torch.agent.vec_env import (EnvState, Policy, Trajectory,
                                           reset_from_search, rollout_from)
from ahrag_tpu_torch.device import stable_topk
from ahrag_tpu_torch.graph.search import (SEM_FLUSH_EPS, SearchResult, SearchWeights,
                                          _post_seed)
from ahrag_tpu_torch.graph.tensors import GraphTensors, round_up
from ahrag_tpu_torch.ops.topk import NEG_INF, refined_masked_topk

_LEAVES = ("emb", "node_type", "level", "judge", "has_judge", "conf",
           "has_conf", "indexed", "valid", "parents", "children", "related",
           "hyperedges", "members")
_ELL = ("parents", "children", "related", "hyperedges", "members")
# below this many rows per graph the seed stage is one batched float32 product
_FULL_PRODUCT_ROWS = 4096


@dataclass(frozen=True)
class BatchedGraphTensors:
    """GraphTensors' tables with a leading ``[G]`` graph axis."""
    emb: torch.Tensor            # [G, N_pad, D]
    node_type: torch.Tensor      # [G, N_pad]
    level: torch.Tensor
    judge: torch.Tensor
    has_judge: torch.Tensor
    conf: torch.Tensor
    has_conf: torch.Tensor
    indexed: torch.Tensor
    valid: torch.Tensor
    parents: torch.Tensor        # [G, N_pad, K]
    children: torch.Tensor
    related: torch.Tensor
    hyperedges: torch.Tensor
    members: torch.Tensor
    n_nodes: Tuple[int, ...] = field(default=())

    @property
    def n_graphs(self) -> int:
        return int(self.emb.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.emb.shape[1])

    @property
    def device(self) -> torch.device:
        return self.emb.device


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def stack_graph_tensors(gts: Sequence[GraphTensors]) -> BatchedGraphTensors:
    """Pad every graph to the common (max) N_pad, rounded up to 128, and
    ELL widths, and stack. Extra node rows are invalid and unindexed (zero
    embedding, node_type -1), extra ELL columns -1."""
    if not gts:
        raise ValueError("need at least one graph")
    dims = {g.dim for g in gts}
    if len(dims) != 1:
        raise ValueError(f"mixed embedding dims {dims}")
    n_pad = round_up(max(g.n_pad for g in gts), 128)
    widths = {t: max(int(getattr(g, t).shape[1]) for g in gts) for t in _ELL}
    stacked = {}
    for name in _LEAVES:
        cols = []
        for g in gts:
            x = getattr(g, name)
            if name in _ELL:
                x = torch.cat([x, torch.full((x.shape[0], widths[name] - x.shape[1]), -1,
                                             dtype=x.dtype, device=x.device)], dim=1)
            if name in _ELL or name == "node_type":
                fill = -1
            else:
                fill = False if x.dtype == torch.bool else 0
            cols.append(_pad_rows(x, n_pad, fill))
        stacked[name] = torch.stack(cols)
    return BatchedGraphTensors(**stacked, n_nodes=tuple(g.n_nodes for g in gts))


def _as_one_graph(b: BatchedGraphTensors) -> GraphTensors:
    """The stack as one graph of G * N_pad nodes: graph g's node i is node
    g * N_pad + i, and its adjacency ids move by the same offset."""
    G, n = b.n_graphs, b.n_pad
    off = (torch.arange(G, dtype=torch.int32, device=b.device) * n).view(G, 1, 1)
    kw = {}
    for name in _LEAVES:
        x = getattr(b, name)
        if name in _ELL:
            x = torch.where(x >= 0, x + off, -1)
        kw[name] = x.reshape((G * n,) + tuple(x.shape[2:]))
    return GraphTensors(**kw, n_nodes=sum(b.n_nodes))


def hybrid_search_multi(b: BatchedGraphTensors, q_embs: torch.Tensor, w: SearchWeights,
                        top_k: int = 5, member_top_m: int = 5,
                        certify: bool = True) -> SearchResult:
    """One query per graph: ``q_embs [G, D]`` -> SearchResult with [G, ...]
    fields and per-graph node ids (N_pad = invalid). ``certify`` applies to
    the graph-by-graph seed stage (the batched product is exact)."""
    G, n = b.n_graphs, b.n_pad
    mask = b.indexed & b.valid
    q = q_embs.to(torch.bfloat16) if b.emb.dtype == torch.bfloat16 else q_embs
    if n < _FULL_PRODUCT_ROWS:
        scores = torch.bmm(b.emb.float(), q.float()[:, :, None])[..., 0]   # [G, N]
        scores = torch.where(scores.abs() < SEM_FLUSH_EPS, 0.0, scores)
        seed_sim, seed_idx = stable_topk(torch.where(mask, scores, NEG_INF), top_k)
    else:
        seeds = [refined_masked_topk(q[g:g + 1], b.emb[g], mask[g], top_k,
                                     margin=max(12, 2 * top_k + 2), certify=certify,
                                     flush_eps=SEM_FLUSH_EPS) for g in range(G)]
        seed_sim = torch.cat([s[0] for s in seeds])
        seed_idx = torch.cat([s[1] for s in seeds])
    off = (torch.arange(G, device=b.device) * n)[:, None]
    res = _post_seed(_as_one_graph(b), seed_sim, seed_idx + off, w, top_k,
                     member_top_m, q_emb=q_embs)

    def local(idx: torch.Tensor) -> torch.Tensor:
        return torch.where(idx < G * n, idx - off, n)

    return res._replace(seed_idx=local(res.seed_idx), reranked_idx=local(res.reranked_idx),
                        cand_idx=local(res.cand_idx))


def rollout_multi(b: BatchedGraphTensors, q_embs: torch.Tensor, policy: Policy,
                  w: SearchWeights, max_steps: int = 6, top_k: int = 5,
                  member_top_m: int = 5, generator: Optional[torch.Generator] = None
                  ) -> Tuple[Trajectory, EnvState]:
    """Policy-driven episodes, one per (graph, query) pair, with the step
    semantics of ``vec_env.rollout_batch``; lane g walks graph g.
    ``policy(obs [G, 84]) -> (logits [G, A], value [G])``."""
    res = hybrid_search_multi(b, q_embs, w, top_k=top_k, member_top_m=member_top_m,
                              certify=False)
    state = reset_from_search(res, b.n_pad,
                              graph=torch.arange(b.n_graphs, device=b.device))
    return rollout_from(b, state, policy, max_steps=max_steps, generator=generator)
