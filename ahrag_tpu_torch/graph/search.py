"""Batched hybrid dense + graph search.

Port of ``ahrag_tpu/graph/search.py``. The stages are the same:

  1. seeds: certified exact top-k cosine over the indexed nodes
     (``ops/topk.py refined_masked_topk``);
  2. expansion: entity seeds pull their first 2 parents at 0.9x, summary seeds
     their ``member_top_m`` children (the most query-similar ones when a
     summary has more) at 0.85x, deduplicated in candidate space by an
     earlier-occurrence test;
  3. filter and rerank ``alpha*sem + beta*sigmoid(judge/10) + gamma*conf/10
     + delta*layer_boost[type]``;
  4. final top-k over the candidates, ties to the earliest candidate.

The JAX package ran stages 2-4 under ``vmap``; here every tensor carries an
explicit leading batch dimension.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ahrag_tpu_torch.device import resolve_device, stable_topk
from ahrag_tpu_torch.graph.tensors import MEMBER_SIM_CAP, NODE_TYPE_IDS, GraphTensors
from ahrag_tpu_torch.ops.topk import NEG_INF, refined_masked_topk

# |cosine| below this is "no relation": flushed to exact 0.0 before the
# top-k's so that the order among irrelevant nodes is the node order on every
# batch shape.
SEM_FLUSH_EPS = 1e-5

__all__ = ["MEMBER_SIM_CAP", "SEM_FLUSH_EPS", "SearchWeights", "SearchResult",
           "expand_candidates", "rerank_scores_at", "filter_mask_at",
           "hybrid_search", "hybrid_search_batch"]


@dataclass(frozen=True)
class SearchWeights:
    """Rerank parameters as device scalars (defaults as in the JAX package)."""
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    delta: torch.Tensor
    layer_boost: torch.Tensor       # [3] by node_type id (entity, summary, hyperedge)
    judge_min: torch.Tensor         # threshold (ignored unless use_judge_min > 0)
    use_judge_min: torch.Tensor     # 0/1 float32
    conf_min: torch.Tensor
    use_conf_min: torch.Tensor
    type_mask: torch.Tensor         # [3] bool, allowed node types

    @staticmethod
    def create(alpha=0.6, beta=0.2, gamma=0.1, delta=0.1,
               layer_boost=(0.0, 1.0, 0.0), judge_min=None, conf_min=None,
               type_filter=None, device=None) -> "SearchWeights":
        dev = resolve_device(device)
        tm = [True, True, True]
        if type_filter is not None:
            tm = [False, False, False]
            for t in type_filter:
                if t in NODE_TYPE_IDS:
                    tm[NODE_TYPE_IDS[t]] = True

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        return SearchWeights(
            alpha=f32(alpha), beta=f32(beta), gamma=f32(gamma), delta=f32(delta),
            layer_boost=f32(layer_boost),
            judge_min=f32(0.0 if judge_min is None else judge_min),
            use_judge_min=f32(0.0 if judge_min is None else 1.0),
            conf_min=f32(0.0 if conf_min is None else conf_min),
            use_conf_min=f32(0.0 if conf_min is None else 1.0),
            type_mask=torch.tensor(tm, dtype=torch.bool, device=dev),
        )


class SearchResult(NamedTuple):
    """Leading dimension B on every field (absent for ``hybrid_search``)."""
    seed_idx: torch.Tensor       # [B, top_k] int64 (n_pad when invalid)
    seed_sim: torch.Tensor       # [B, top_k] f32
    seed_valid: torch.Tensor     # [B, top_k] bool
    reranked_idx: torch.Tensor   # [B, top_k] int64
    reranked_score: torch.Tensor  # [B, top_k] f32
    reranked_sem: torch.Tensor   # [B, top_k] f32
    reranked_valid: torch.Tensor  # [B, top_k] bool
    cand_idx: torch.Tensor       # [B, C] int64, candidate node ids (n_pad = invalid)
    cand_sem: torch.Tensor       # [B, C] f32
    cand_win: torch.Tensor       # [B, C] bool, dedup winners


def expand_candidates(gt: GraphTensors, seed_idx: torch.Tensor,
                      seed_sim: torch.Tensor, seed_valid: torch.Tensor,
                      member_top_m: int, q_emb: torch.Tensor | None = None,
                      flush_eps: float = 0.0):
    """1-hop expansion with decay, in candidate space.

    seed_* are [B, K]; ``q_emb`` [B, D]. Returns (cand_idx [B, C], cand_sem
    [B, C], cand_win [B, C]) with C = K * (1 + 2 + member_top_m): all seed
    self-entries first, then per-seed expansion rows seed-major (parents, then
    children). A candidate wins when no earlier candidate has the same id.
    Summaries with more than ``member_top_m`` children expand the ones most
    similar to the query among their first ``MEMBER_SIM_CAP``, kept in
    insertion order.
    """
    n_pad = gt.n_pad
    dump = n_pad
    safe_seed = seed_idx.clamp(0, n_pad - 1)

    seed_type = torch.where(seed_valid, gt.node_type[safe_seed], -1)
    is_ent = seed_type == 0
    is_sum = seed_type == 1

    par = gt.parents[:, :2][safe_seed].long()                          # [B, K, 2]
    par_ok = (par >= 0) & is_ent[..., None] & seed_valid[..., None]
    par_sem = (seed_sim * 0.9)[..., None].expand(par.shape)

    packed = (gt.child_pack_emb is not None
              and gt.child_pack_ids.shape[1] <= MEMBER_SIM_CAP)
    if packed:
        # one contiguous [cap, D] row per seed: same ids, same values
        slot = torch.where(seed_valid, gt.child_pack_slot[safe_seed], -1)  # [B, K]
        slot_safe = slot.clamp(0, gt.child_pack_ids.shape[0] - 1).long()
        mem_all = torch.where(slot[..., None] >= 0,
                              gt.child_pack_ids[slot_safe], -1)           # [B, K, Kc]
    else:
        mem_all = gt.children[safe_seed][..., :MEMBER_SIM_CAP]
    mem_all = mem_all.long()
    if q_emb is not None and mem_all.shape[-1] > member_top_m:
        if packed:
            ce = gt.child_pack_emb[slot_safe]                              # [B, K, Kc, D]
        elif gt.shard is not None:
            # float32, from the rows' owners
            ce = gt.shard.gather_rows(gt.emb, mem_all.clamp(0, n_pad - 1))
        else:
            ce = gt.emb[mem_all.clamp(0, n_pad - 1)]
        qd = q_emb.to(gt.emb.dtype).float()
        msim = torch.einsum("bd,bkcd->bkc", qd, ce.float())
        if flush_eps:
            msim = torch.where(msim.abs() < flush_eps, 0.0, msim)
        msim = torch.where(mem_all >= 0, msim, NEG_INF)
        _, sel = stable_topk(msim, member_top_m)     # ties: lowest slot first
        sel, _ = torch.sort(sel, dim=-1)             # restore insertion order
        mem = mem_all.gather(-1, sel)                                      # [B, K, M]
    else:
        mem = mem_all[..., :member_top_m]
    mem_ok = (mem >= 0) & is_sum[..., None] & seed_valid[..., None]
    mem_sem = (seed_sim * 0.85)[..., None].expand(mem.shape)

    B = seed_idx.shape[0]
    exp_tgt = torch.cat([torch.where(par_ok, par, dump),
                         torch.where(mem_ok, mem, dump)], dim=-1).reshape(B, -1)
    exp_sem = torch.cat([par_sem, mem_sem], dim=-1).reshape(B, -1)

    tgt = torch.cat([torch.where(seed_valid, seed_idx, dump), exp_tgt], dim=1)
    sem = torch.cat([seed_sim, exp_sem], dim=1)
    valid = tgt < n_pad
    pos = torch.arange(tgt.shape[1], device=tgt.device)
    eq_earlier = ((tgt[:, :, None] == tgt[:, None, :])
                  & valid[:, :, None] & valid[:, None, :]
                  & (pos[None, :] < pos[:, None]))
    win = valid & ~eq_earlier.any(dim=2)
    return tgt, sem, win


def rerank_scores_at(gt: GraphTensors, idx: torch.Tensor, sem: torch.Tensor,
                     w: SearchWeights) -> torch.Tensor:
    """Rerank formula at candidate node ids."""
    safe = idx.clamp(0, gt.n_pad - 1)
    nt = gt.node_type[safe].clamp(0, 2).long()
    judge_term = torch.where(gt.has_judge[safe],
                             torch.sigmoid(gt.judge[safe] / 10.0), 0.0)
    conf_term = torch.where(gt.has_conf[safe], gt.conf[safe] / 10.0, 0.0)
    boost = w.layer_boost[nt]
    return w.alpha * sem + w.beta * judge_term + w.gamma * conf_term + w.delta * boost


def filter_mask_at(gt: GraphTensors, idx: torch.Tensor,
                   w: SearchWeights) -> torch.Tensor:
    """Type, judge and confidence filters at candidate ids; a null judge or
    confidence fails its threshold."""
    safe = idx.clamp(0, gt.n_pad - 1)
    nt = gt.node_type[safe].clamp(0, 2).long()
    keep = (idx < gt.n_pad) & gt.valid[safe] & w.type_mask[nt]
    keep &= torch.where(w.use_judge_min > 0,
                        gt.has_judge[safe] & (gt.judge[safe] >= w.judge_min), True)
    keep &= torch.where(w.use_conf_min > 0,
                        gt.has_conf[safe] & (gt.conf[safe] >= w.conf_min), True)
    return keep


def _post_seed(gt: GraphTensors, seed_sim: torch.Tensor, seed_idx: torch.Tensor,
               w: SearchWeights, top_k: int, member_top_m: int,
               q_emb: torch.Tensor | None = None) -> SearchResult:
    """Stages 2-4 (candidate space) given the seed top-k [B, K]."""
    n_pad = gt.n_pad
    seed_valid = seed_sim > NEG_INF / 2
    cand_idx, cand_sem, cand_win = expand_candidates(
        gt, seed_idx, seed_sim, seed_valid, member_top_m, q_emb=q_emb,
        flush_eps=SEM_FLUSH_EPS)
    keep = cand_win & filter_mask_at(gt, cand_idx, w)
    score = rerank_scores_at(gt, cand_idx, cand_sem, w)
    masked = torch.where(keep, score, NEG_INF)
    k = min(top_k, masked.shape[1])
    rr_score, rr_pos = stable_topk(masked, k)
    if k < top_k:
        rr_score = torch.nn.functional.pad(rr_score, (0, top_k - k), value=NEG_INF)
        rr_pos = torch.nn.functional.pad(rr_pos, (0, top_k - k))
    rr_valid = rr_score > NEG_INF / 2
    rr_idx = torch.where(rr_valid, cand_idx.gather(1, rr_pos), n_pad)
    return SearchResult(
        seed_idx=torch.where(seed_valid, seed_idx, n_pad),
        seed_sim=seed_sim, seed_valid=seed_valid,
        reranked_idx=rr_idx,
        reranked_score=rr_score,
        reranked_sem=torch.where(rr_valid, cand_sem.gather(1, rr_pos), 0.0),
        reranked_valid=rr_valid,
        cand_idx=cand_idx, cand_sem=cand_sem, cand_win=cand_win,
    )


def hybrid_search_batch(gt: GraphTensors, q_embs: torch.Tensor, w: SearchWeights,
                        top_k: int = 5, member_top_m: int = 5,
                        certify: bool = True) -> SearchResult:
    """Batched hybrid search over ``[B, D]`` float32 query embeddings on the
    graph's device. The seed stage scores all B queries against the corpus
    in one pass; stages 2-4 run in candidate space. On a corpus-sharded graph
    (``parallel/sharded.py``) every rank of the corpus group calls it with
    the same queries: the seeds come from the sharded certified top-k, exact
    whatever ``certify`` says, and the result is the same on every rank."""
    if gt.shard is not None:
        seed_sim, seed_idx = gt.shard.seed_topk(gt, q_embs, top_k, max(12, 2 * top_k + 2),
                                                SEM_FLUSH_EPS)
        return _post_seed(gt, seed_sim, seed_idx, w, top_k, member_top_m, q_emb=q_embs)
    seed_sim, seed_idx = refined_masked_topk(
        q_embs, gt.emb, gt.indexed & gt.valid, top_k,
        margin=max(12, 2 * top_k + 2), certify=certify,
        flush_eps=SEM_FLUSH_EPS, mask_trivial=gt.mask_trivial,
        emb_binpack=gt.emb_binpack)
    return _post_seed(gt, seed_sim, seed_idx, w, top_k, member_top_m,
                      q_emb=q_embs)


def hybrid_search(gt: GraphTensors, q_emb: torch.Tensor, w: SearchWeights,
                  top_k: int = 5, member_top_m: int = 5,
                  certify: bool = True) -> SearchResult:
    """Hybrid search for one query embedding ``q_emb [D]``; the result's
    fields have no batch dimension."""
    res = hybrid_search_batch(gt, q_emb[None, :], w, top_k=top_k,
                              member_top_m=member_top_m, certify=certify)
    return SearchResult(*(f[0] for f in res))
