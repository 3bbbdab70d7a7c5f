"""Synthetic bench corpus, its CPU reference search and the certificate audit.

The port's own copies of ``BenchArrays``, ``build_bench_arrays``,
``cpu_reference_search`` and ``certificate_audit`` from the repo's
``bench.py``, plus the query set and bf16 host rounding that ``bench.py``
builds inline. The corpus is the bench ladder's: entities clustered round
topics (64 per topic), topics under L2 communities (8 per community), a
related chain, judge and confidence on a deterministic subset.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ahrag_tpu_torch.graph.search import MEMBER_SIM_CAP, SearchResult
from ahrag_tpu_torch.graph.tensors import GraphTensors, build_graph_tensors
from ahrag_tpu_torch.ops.topk import _full_highest_topk


class BenchArrays:
    """Raw per-node arrays shared by the device build and the CPU reference."""

    def __init__(self, emb, node_type, level, judge, conf, parents_ell,
                 children_ell, related_ell, n_topics, n_l2):
        self.emb = emb                  # [N, D] f32 row-normalized
        self.node_type = node_type      # [N] i32 (0 entity, 1 summary)
        self.level = level              # [N] i32
        self.judge = judge              # [N] f64, NaN = none
        self.conf = conf                # [N] f64, NaN = none
        self.parents_ell = parents_ell  # [N, Kp] i32, -1 padded
        self.children_ell = children_ell
        self.related_ell = related_ell
        self.n_topics = n_topics
        self.n_l2 = n_l2

    @property
    def n(self):
        return self.emb.shape[0]

    @property
    def n_entities(self):
        return self.n - self.n_topics - self.n_l2


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def round_bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bf16 (nearest even) and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def build_bench_arrays(n_entities: int, n_topics: int, d: int = 384,
                       seed: int = 7) -> BenchArrays:
    """Vectorized synthetic hierarchy (identical to ``bench.py``'s for the
    same arguments): clustered unit embeddings and ELL adjacency."""
    rng = np.random.default_rng(seed)
    n_l2 = max(1, n_topics // 8)
    n_total = n_entities + n_topics + n_l2
    t0, t1 = n_entities, n_entities + n_topics   # topic/L2 index bases

    centers = _normalize(rng.standard_normal((n_topics, d), dtype=np.float32))
    ent_topic = (np.arange(n_entities) % n_topics).astype(np.int32)
    emb = np.empty((n_total, d), dtype=np.float32)
    # entity noise from two coprime pools (4096 * 4093 distinct sums), which
    # is fast and gives no two entities the same embedding
    pool_a = rng.standard_normal((4096, d), dtype=np.float32)
    pool_b = rng.standard_normal((4093, d), dtype=np.float32)
    for s in range(0, n_entities, 262144):
        e = min(s + 262144, n_entities)
        idx = np.arange(s, e)
        noise = pool_a[idx % 4096] + pool_b[idx % 4093]
        emb[s:e] = _normalize(centers[ent_topic[s:e]] + 0.39 * noise)
    emb[t0:t1] = _normalize(
        centers + 0.15 * rng.standard_normal((n_topics, d), dtype=np.float32))
    l2_of_topic = (np.arange(n_topics) % n_l2).astype(np.int32)
    l2c = np.zeros((n_l2, d), dtype=np.float32)
    np.add.at(l2c, l2_of_topic, centers)
    emb[t1:] = _normalize(
        l2c + 0.2 * rng.standard_normal((n_l2, d), dtype=np.float32))

    node_type = np.zeros(n_total, np.int32)
    node_type[t0:] = 1                           # topics + L2 are summaries
    level = np.zeros(n_total, np.int32)
    level[t0:t1] = 1
    level[t1:] = 2

    tt = np.arange(n_topics)
    judge = np.full(n_total, np.nan)
    judge[t0:t1] = np.where(tt % 3 == 0, 6.0 + (tt % 4), np.nan)
    conf = np.full(n_total, np.nan)
    conf[t0:t1] = 5.0 + (tt % 5)
    conf[t1:] = 7.0

    # parents (belongs_to out): entity -> its topic; topic -> its L2 community
    parents = np.full((n_total, 1), -1, np.int32)
    parents[:t0, 0] = t0 + ent_topic
    parents[t0:t1, 0] = t1 + l2_of_topic

    # children (belongs_to in, insertion order = ascending member index)
    k_ent = -(-n_entities // n_topics)           # ceil: members per topic
    k_top = -(-n_topics // n_l2)                 # topics per L2 community
    kc = max(k_ent, k_top)
    children = np.full((n_total, kc), -1, np.int32)
    cand = tt[:, None] + n_topics * np.arange(k_ent)[None, :]
    children[t0:t1, :k_ent] = np.where(cand < n_entities, cand, -1)
    cc = np.arange(n_l2)
    candt = cc[:, None] + n_l2 * np.arange(k_top)[None, :]
    children[t1:, :k_top] = np.where(candt < n_topics, t0 + candt, -1)

    # related (union of both directions): even t < n_topics-1 links t <-> t+1
    related = np.full((n_total, 1), -1, np.int32)
    ev = tt[(tt % 2 == 0) & (tt < n_topics - 1)]
    related[t0 + ev, 0] = t0 + ev + 1
    related[t0 + ev + 1, 0] = t0 + ev

    return BenchArrays(emb, node_type, level, judge, conf, parents,
                       children, related, n_topics, n_l2)


def bench_queries(arrs: BenchArrays, n_queries: int, seed: int = 11) -> np.ndarray:
    """Unit query vectors near a cycling topic embedding ([n_queries, D] f32)."""
    rng = np.random.default_rng(seed)
    q_topics = np.arange(n_queries) % arrs.n_topics
    return _normalize(arrs.emb[arrs.n_entities + q_topics]
                      + 0.35 * rng.standard_normal((n_queries, arrs.emb.shape[1]),
                                                   dtype=np.float32))


def bench_tensors(arrs: BenchArrays, emb_dtype: str, device=None) -> GraphTensors:
    n = arrs.n
    empty = np.empty((0, 0), np.int32)
    n_edges = int((arrs.parents_ell >= 0).sum() + (arrs.related_ell >= 0).sum())
    return build_graph_tensors(
        emb_dtype=emb_dtype,
        embeddings=arrs.emb,
        node_types=arrs.node_type,
        levels=arrs.level,
        judges=arrs.judge,
        confs=arrs.conf,
        indexed=np.ones(n, bool),
        parents=arrs.parents_ell,
        children=arrs.children_ell,
        related=arrs.related_ell,
        hyperedges=empty,
        members=empty,
        n_edges=n_edges,
        device=device,
    )


def cpu_reference_search(arrs: BenchArrays, q_vec, top_k=5, member_top_m=5):
    """Reference-shaped per-query search in numpy and Python: full cosine
    scan, dict expansion and a rerank loop. Returns [(node, score)]."""
    sims = arrs.emb @ q_vec
    order = np.argsort(-sims, kind="stable")[:top_k]
    expanded = {}
    for i in order:
        i = int(i)
        sem = float(sims[i])
        expanded[i] = sem
        if arrs.node_type[i] == 0:
            for parent in [int(p) for p in arrs.parents_ell[i] if p >= 0][:2]:
                if parent not in expanded:
                    expanded[parent] = sem * 0.9
        else:
            children = [int(c) for c in arrs.children_ell[i][:MEMBER_SIM_CAP]
                        if c >= 0]
            if len(children) > member_top_m:
                # big-fan summaries expand their m most query-similar children
                # (|sim| < 1e-5 flushed; ties by slot), in insertion order
                def _msim(c):
                    s = float(arrs.emb[c] @ q_vec)
                    return 0.0 if abs(s) < 1e-5 else s
                picked = sorted(range(len(children)),
                                key=lambda j: (-_msim(children[j]), j)
                                )[:member_top_m]
                children = [children[j] for j in sorted(picked)]
            for child in children:
                if child not in expanded:
                    expanded[child] = sem * 0.85
    results = []
    for i, sem in expanded.items():
        judge = arrs.judge[i]
        conf = arrs.conf[i]
        jt = 1.0 / (1.0 + math.exp(-(judge / 10.0))) if not math.isnan(judge) else 0.0
        ct = conf / 10.0 if not math.isnan(conf) else 0.0
        boost = 1.0 if arrs.node_type[i] == 1 else 0.0
        score = 0.6 * sem + 0.2 * jt + 0.1 * ct + 0.1 * boost
        results.append((i, score))
    results.sort(key=lambda x: -x[1])
    return results[:top_k]


def certificate_audit(gt: GraphTensors, q_dev: torch.Tensor, res: SearchResult,
                      n_audit: int = 64, k: int = 5) -> dict:
    """Exactness audit of the certified seeds against a full float32 top-k
    over the same (storage-type) corpus, on the graph's device. A position
    mismatch counts only when the score multisets differ too (tied scores
    may be ordered differently by the two computations)."""
    qa = q_dev[:n_audit]
    if gt.emb.dtype == torch.bfloat16:
        qa = qa.to(torch.bfloat16)
    gvals, gidx = _full_highest_topk(qa, gt.emb, gt.indexed & gt.valid, k)
    idx = res.seed_idx[:n_audit].cpu().numpy()
    vals = res.seed_sim[:n_audit].cpu().numpy()
    gidx, gvals = gidx.cpu().numpy(), gvals.cpu().numpy()
    mism = 0
    for b in range(idx.shape[0]):
        if list(idx[b]) != list(gidx[b]) and not np.allclose(
                vals[b], gvals[b], rtol=0, atol=1e-6):
            mism += 1
    return {"audited_queries": int(idx.shape[0]), "audit_mismatches": int(mism)}
