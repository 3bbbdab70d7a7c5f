"""Multi-level beam-search traversal.

Port of ``ahrag_tpu/graph/beam.py``. A fixed-width beam walks the typed
adjacency (parents, children, related_to) for ``depth`` rounds, so evidence
several ``belongs_to`` hops above a seed (an L2 community summary over an
entity) is reachable in one call:

- seeds: the top ``beam_width`` nodes by cosine over the indexed subset;
- each round, the beam's neighbours are marked in an ``[N_pad]`` reachability
  mask (which deduplicates them), unvisited ones are scored by the hybrid
  rerank formula over their true cosine, and the top ``beam_width`` form the
  next beam;
- the evidence is the top ``top_k`` visited nodes that pass the type, judge
  and confidence filters, which apply only here, so a summary-only filter
  still traverses through entities.

``lax.scan`` becomes a loop over ``depth`` and ``vmap`` a leading batch
dimension; ``lax.top_k`` becomes ``stable_topk`` (ties to the lowest index)
and ``emb @ q`` the float32 ``f32_matmul``, exact over bf16 storage.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ahrag_tpu_torch.device import f32_matmul, stable_topk
from ahrag_tpu_torch.graph.search import SearchWeights, filter_mask_at, rerank_scores_at
from ahrag_tpu_torch.graph.tensors import GraphTensors
from ahrag_tpu_torch.ops.topk import NEG_INF


class BeamResult(NamedTuple):
    """Leading dimension B on every field (absent for ``beam_search``)."""
    evidence_idx: torch.Tensor     # [B, top_k] int64 (n_pad when invalid)
    evidence_score: torch.Tensor   # [B, top_k] f32 rerank scores, descending
    evidence_sem: torch.Tensor     # [B, top_k] f32 raw cosine
    evidence_valid: torch.Tensor   # [B, top_k] bool
    visited_count: torch.Tensor    # [B] int64: nodes the beam touched (incl. seeds)


def _mark(visited: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``visited | one_hot(idx[ok])`` per row; entries not ok go to a dump
    column past the end."""
    n_pad = visited.shape[1]
    hit = torch.zeros((visited.shape[0], n_pad + 1), dtype=torch.bool,
                      device=visited.device)
    hit.scatter_(1, torch.where(ok, idx, n_pad), True)
    return visited | hit[:, :n_pad]


def beam_search_batch(gt: GraphTensors, q_embs: torch.Tensor, w: SearchWeights,
                      beam_width: int = 8, depth: int = 3,
                      top_k: int = 10) -> BeamResult:
    """Beam traversal for ``[B, D]`` float32 query embeddings on the graph's
    device."""
    n_pad = gt.n_pad
    B = q_embs.shape[0]
    idx_all = torch.arange(n_pad, device=gt.device)
    sem_all = f32_matmul(q_embs, gt.emb.T)                          # [B, N_pad]
    score_all = rerank_scores_at(gt, idx_all, sem_all, w)           # [B, N_pad]
    width = min(beam_width, n_pad)

    seed_pool = gt.indexed & gt.valid
    seed_score, beam = stable_topk(torch.where(seed_pool, sem_all, NEG_INF), width)
    beam_ok = seed_score > NEG_INF / 2
    visited = _mark(torch.zeros((B, n_pad), dtype=torch.bool, device=gt.device),
                    beam, beam_ok)

    def gather(table: torch.Tensor) -> torch.Tensor:
        rows = table[beam.clamp(0, n_pad - 1)].long()               # [B, W, K]
        good = (rows >= 0) & beam_ok[..., None]
        return torch.where(good, rows, n_pad).reshape(B, -1)

    for _ in range(depth):
        nbr = torch.cat([gather(gt.parents), gather(gt.children),
                         gather(gt.related)], dim=1)
        reach = _mark(torch.zeros((B, n_pad), dtype=torch.bool, device=gt.device),
                      nbr, nbr < n_pad)
        cand = reach & gt.valid & ~visited
        new_score, beam = stable_topk(torch.where(cand, score_all, NEG_INF), width)
        beam_ok = new_score > NEG_INF / 2
        visited = _mark(visited, beam, beam_ok)

    keep = visited & filter_mask_at(gt, idx_all, w)
    k = min(top_k, n_pad)
    ev_score, ev_idx = stable_topk(torch.where(keep, score_all, NEG_INF), k)
    if k < top_k:
        ev_score = torch.nn.functional.pad(ev_score, (0, top_k - k), value=NEG_INF)
        ev_idx = torch.nn.functional.pad(ev_idx, (0, top_k - k))
    ev_valid = ev_score > NEG_INF / 2
    return BeamResult(
        evidence_idx=torch.where(ev_valid, ev_idx, n_pad),
        evidence_score=torch.where(ev_valid, ev_score, NEG_INF),
        evidence_sem=torch.where(ev_valid, sem_all.gather(1, ev_idx.clamp(0, n_pad - 1)),
                                 0.0),
        evidence_valid=ev_valid,
        visited_count=(visited & gt.valid).sum(dim=1),
    )


def beam_search(gt: GraphTensors, q_emb: torch.Tensor, w: SearchWeights,
                beam_width: int = 8, depth: int = 3, top_k: int = 10) -> BeamResult:
    """Beam traversal for one query embedding ``q_emb [D]``; the result's
    fields have no batch dimension."""
    res = beam_search_batch(gt, q_emb[None, :], w, beam_width=beam_width,
                            depth=depth, top_k=top_k)
    return BeamResult(*(f[0] for f in res))
