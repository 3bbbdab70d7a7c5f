"""Semantic aggregation: build-time hierarchy construction (L0 -> L1 -> L2).

The port's copy of ``ahrag_tpu/aggregate/aggregator.py``. The entity
embeddings (the hashed encoder, accumulated in float64) and spherical k-means
run on ``device``; the rest is the same numpy and Python on the host. The
model is asked through ``chat_or_none``, its JSON parsed through
``utils/parse.py`` and validated by the schema's validator (None where
pydantic raises), so no handler catches anything here.

Capability parity with the reference aggregator (aggregate/semantic_aggregator.py:
36-816), re-designed for TPU:

- entity dedup + batch embedding on device (the reference's COMPUTE HOT SPOT #1);
- topic clustering via device spherical k-means + temperature-softmax soft
  assignment (replaces BERTopic/UMAP/HDBSCAN; the artifact contract — soft parents
  with probs, l1_nodes with top_words/members/centroid — is preserved exactly);
- LLM topic/community summaries with deterministic heuristic fallbacks (the
  reference only produces heuristics on LLM *failure*; here the same heuristics
  also cover the LLM-disabled path so offline builds still get titled summaries);
- L1<->L1 ``related_summary`` edges from member overlap/Jaccard/centroid cosine
  with weight 0.5*jaccard + 0.5*cosine (:594-680);
- L2 via first-party greedy-modularity communities over the L1 graph (edge weight
  >= 0.15, min community size 3) with mean-of-member centroids (:462-592);
- LLM-as-judge sampling with neutral-6.0 fallback scores (:682-816);
- escalation metrics (compression/coverage/judge-improvement) with stop flag and
  thresholds {1.5, 0.9, 0.2} (:406-460).

Artifact files written (reference layout, SURVEY §1): embeddings.npy, topics.json,
l1_nodes.json, l1_summaries.json, l1_edges.json, l2_nodes.json, l1_to_l2.json,
l1_judge_nodes.json, l1_judge_edges.json, l2_judge_nodes.json, metrics.json.
"""
from __future__ import annotations

import json
import math
import os
import random
import re
import time
from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ahrag_tpu_torch.aggregate.community import greedy_modularity_communities
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.encoder import create_encoder
from ahrag_tpu_torch.ops.kmeans import spherical_kmeans
from ahrag_tpu_torch.schema import Entity, HypergraphExtraction, JudgeScore, TopicSummary
from ahrag_tpu_torch.utils.config import load_config
from ahrag_tpu_torch.utils.llm import LLMModule, get_llm_manager
from ahrag_tpu_torch.utils.parse import float_or_none, int_or_none, json_or_none

_JSON_RE = re.compile(r"\{[\s\S]*\}")
_WORD_RE = re.compile(r"[a-zA-Z]{3,}")
_STOPWORDS = {"the", "and", "for", "with", "that", "was", "his", "her", "are", "who",
              "from", "has", "had", "have", "this", "its", "also", "were", "been"}


class SemanticAggregator:
    def __init__(self, encoder_name: Optional[str] = None,
                 artifact_dir: str = "artifacts", device=None) -> None:
        """``device`` runs the entity embeddings and k-means: ``cuda`` unless
        the caller names another."""
        self.artifact_dir = artifact_dir
        self.device = resolve_device(device)
        self.encoder = create_encoder(load_config(), name=encoder_name, device=self.device)
        self.kmeans_s = 0.0       # seconds of the last spherical_kmeans call
        self.entities_map: Dict[str, Entity] = {}
        self.entity_names: List[str] = []
        self.entity_embeddings: Optional[np.ndarray] = None

    # ------------------------------------------------------------ utilities
    def _write(self, name: str, obj: Any) -> None:
        os.makedirs(self.artifact_dir, exist_ok=True)
        with open(os.path.join(self.artifact_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False, indent=2)

    def _llm(self):
        mgr = get_llm_manager()
        return mgr if mgr.is_enabled(LLMModule.SEMANTIC_AGGREGATION) else None

    def _llm_json(self, prompt: str, max_tokens: int = 600) -> Optional[Dict[str, Any]]:
        mgr = self._llm()
        if mgr is None:
            return None
        txt = mgr.chat_or_none(LLMModule.SEMANTIC_AGGREGATION,
                               [{"role": "user", "content": prompt}], max_tokens=max_tokens)
        m = _JSON_RE.search(txt or "")
        return json_or_none(m.group(0)) if m else None

    # ------------------------------------------------------------ L0 embed
    def embed_l0_entities(self, l0_extractions: List[HypergraphExtraction]) -> np.ndarray:
        for extraction in l0_extractions:
            for entity in extraction.entities:
                if entity.name not in self.entities_map:
                    self.entities_map[entity.name] = entity
        unique = list(self.entities_map.values())
        self.entity_names = [e.name for e in unique]
        if not unique:
            self.entity_embeddings = np.zeros((0, self.encoder.dim), np.float32)
            return self.entity_embeddings
        texts = [e.description or e.name for e in unique]
        self.entity_embeddings = self.encoder.encode(texts, dtype=torch.float64)
        os.makedirs(self.artifact_dir, exist_ok=True)
        np.save(os.path.join(self.artifact_dir, "embeddings.npy"),
                self.entity_embeddings)
        return self.entity_embeddings

    # ----------------------------------------------------------- clustering
    def cluster_entities(self, prob_threshold: float = 0.10, max_parents: int = 2,
                         min_topic_size: int = 2, n_topics: Optional[int] = None,
                         softmax_tau: float = 0.1, seed: int = 42,
                         merge_threshold: Optional[float] = 0.6,
                         outlier_sigma="auto",
                         outlier_abs: Optional[float] = 0.3,
                         min_outlier_cluster: int = 8,
                         min_noise_cluster: int = 5,
                         min_noise_corpus: int = 50,
                         oversplit: int = 1,
                         density_alpha: Optional[float] = None) -> Dict[str, Any]:
        """Device k-means + soft parent assignment; preserves the topics.json contract.

        Two density-style refinements recover the BERTopic/HDBSCAN semantics the
        reference got for free (semantic_aggregator.py:102-217) and that plain
        k-means lacks (VERDICT r1 item 7, validated in eval/clustering.py):

        - **merge** (adaptive cluster count): the sqrt(N/2) heuristic k
          over-clusters; clusters whose centroids' cosine exceeds
          ``merge_threshold`` are union-found together (measured on labeled
          synth corpora: same-topic splits sit at >=0.57 cosine, cross-topic
          pairs at <=0.28, so 0.6 separates cleanly). Skipped when the caller
          pins ``n_topics``. For corpora whose distinct topics share heavy
          vocabulary, ``oversplit=2`` + ``density_alpha~6`` enables the
          HDBSCAN-style leaf-split-then-density-merge mode (see
          ``_merge_clusters``); measured tradeoff on labeled corpora
          (reports/cluster_eval_10k_hier.json): higher purity under topic
          interference, slightly lower NMI and noise-F1 on clean corpora —
          hence opt-in, not default.
        - **outliers** (HDBSCAN's noise topic -1): an entity whose cosine to
          its own centroid falls ``outlier_sigma`` standard deviations below
          its cluster's mean is noise — excluded from members and given NO
          parents, exactly how the reference treats BERTopic topic -1
          (semantic_aggregator.py:136-141 -> ``entity_to_parents = []``).
          Applied only within clusters of >= ``min_outlier_cluster`` members
          (tiny clusters have no meaningful density statistics).
          ``outlier_sigma="auto"`` (default) resolves to 2.5 for adaptive k
          and to None (no cut) when the caller pins ``n_topics`` — mirroring
          how merge is skipped, so pinned-k callers keep every entity parented
          and ``n_topics`` keeps meaning "requested k" (ADVICE r2). Pass an
          explicit float to force the cut either way.

          The z-score is *relative* and blind to two noise shapes the cut
          also covers when active — both only at corpus scale
          (``n >= min_noise_corpus``; on toy corpora a low self-cosine or a
          small cluster is the norm, not a density signal):

          * ``outlier_abs``: an entity whose cosine to its own centroid is
            near zero is lexically adrift from every topic even when its
            host cluster is too diffuse for the z-statistic to fire
            (measured member floor ~0.37 on labeled corpora, noise median
            ~0.27 under the cgram-weighted encoder). Gated to clusters of
            >= ``min_outlier_cluster`` members like the z-cut.
          * ``min_noise_cluster``: HDBSCAN's ``min_cluster_size`` semantic —
            lexically-adrift entities that happen to SHARE their drift
            (mixed-vocabulary junk) conglomerate into small clusters where
            every per-entity statistic looks healthy; clusters with fewer
            members dissolve into noise wholesale. Applied only when some
            cluster reached ``min_outlier_cluster`` (the corpus has real
            density to contrast against).
        """
        if self.entity_embeddings is None or not self.entity_names:
            raise RuntimeError("Embeddings not available. Run embed_l0_entities first.")
        n = len(self.entity_names)
        # oversplit>1: k-means at exactly the sqrt(N/2) heuristic has no
        # headroom to separate correlated sibling topics (they fuse inside one
        # cluster and no post-pass can recover them); splitting finer and
        # density-merging the same-topic splits back recovers both (HDBSCAN
        # leaf-splitting analogue) — opt-in, see docstring
        if isinstance(outlier_sigma, str):  # "auto"
            outlier_sigma = None if n_topics is not None else 2.5
        osf = oversplit if (n_topics is None and merge_threshold is not None) else 1
        k = n_topics or max(1, min(n // max(1, min_topic_size),
                                   osf * (int(round(math.sqrt(n / 2))) or 1)))
        t0 = time.perf_counter()
        assign, cents = spherical_kmeans(self.entity_embeddings, k=int(k), seed=seed,
                                         device=self.device)
        assign = assign.cpu().numpy()
        cents = cents.cpu().numpy()
        self.kmeans_s = time.perf_counter() - t0

        if n_topics is None and merge_threshold is not None and k > 1:
            assign, cents = self._merge_clusters(
                assign, cents, merge_threshold,
                emb=(self.entity_embeddings if density_alpha is not None
                     else None),
                density_alpha=(density_alpha or 6.0))
        k_eff = cents.shape[0]

        # density outlier cut: per-cluster z-score of self-centroid cosine,
        # plus the adrift floor and junk-conglomerate dissolution (docstring)
        is_noise = np.zeros(n, dtype=bool)
        if outlier_sigma is not None:
            self_sim = np.einsum("nd,nd->n", self.entity_embeddings, cents[assign])
            sizes = np.bincount(assign, minlength=k_eff)
            at_scale = (n >= min_noise_corpus and k_eff > 0
                        and int(sizes.max()) >= min_outlier_cluster)
            for c in range(k_eff):
                m = assign == c
                if sizes[c] >= min_outlier_cluster:
                    mu, sd = float(self_sim[m].mean()), float(self_sim[m].std())
                    if sd > 0:
                        is_noise |= m & (self_sim < mu - outlier_sigma * sd)
                    if at_scale and outlier_abs is not None:
                        is_noise |= m & (self_sim < outlier_abs)
                elif at_scale and sizes[c] < min_noise_cluster:
                    is_noise |= m

        # soft probabilities from centroid cosines
        sims = self.entity_embeddings @ cents.T                   # [N, k_eff]
        logits = sims / max(softmax_tau, 1e-6)
        logits -= logits.max(axis=1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(axis=1, keepdims=True)

        entity_to_parents: Dict[str, List[Dict[str, Any]]] = {}
        for i, name in enumerate(self.entity_names):
            if is_noise[i]:
                entity_to_parents[name] = []  # noise: no parents (ref :136-141)
                continue
            order = np.argsort(-probs[i])
            selected = [{"topic_id": int(t), "prob": float(probs[i, t])}
                        for t in order[:max_parents] if probs[i, t] >= prob_threshold]
            if not selected:
                selected = [{"topic_id": int(assign[i]), "prob": 1.0}]
            entity_to_parents[name] = selected

        topic_to_members: Dict[int, List[int]] = {}
        for i, t in enumerate(assign):
            if not is_noise[i]:
                topic_to_members.setdefault(int(t), []).append(i)
        # soft parents may point at a cluster emptied by the outlier cut; such
        # topics have no L1 node, so drop those references
        for name, parents in entity_to_parents.items():
            kept = [p for p in parents if p["topic_id"] in topic_to_members]
            if kept != parents:
                entity_to_parents[name] = kept

        l1_nodes: List[Dict[str, Any]] = []
        for tid in sorted(topic_to_members):
            member_idx = topic_to_members[tid]
            members = [self.entity_names[i] for i in member_idx]
            texts = []
            for nm in members:
                ent = self.entities_map.get(nm)
                texts.append(f"{nm} {(ent.description if ent else '') or ''}")
            counts = Counter(w.lower() for t in texts for w in _WORD_RE.findall(t)
                             if w.lower() not in _STOPWORDS)
            l1_nodes.append({
                "topic_id": int(tid),
                "top_words": [w for w, _ in counts.most_common(10)],
                "members": members,
                "centroid": np.mean(self.entity_embeddings[member_idx],
                                    axis=0).tolist(),
            })

        self._write("topics.json", {"entity_to_parents": entity_to_parents,
                                    "l1_nodes": l1_nodes})
        self._write("l1_nodes.json", l1_nodes)
        return {"entity_to_parents": entity_to_parents, "l1_nodes": l1_nodes,
                "n_topics": len(l1_nodes), "n_outliers": int(is_noise.sum())}

    @staticmethod
    def _merge_clusters(assign: np.ndarray, cents: np.ndarray,
                        threshold: float, emb: Optional[np.ndarray] = None,
                        density_alpha: float = 6.0) -> tuple:
        """Union-find merge of over-split clusters; returns (reassigned labels,
        merged normalized centroids) with dense ids ordered by each group's
        smallest original id.

        A pair is a merge candidate when its centroid cosine exceeds
        ``threshold``. With ``emb`` given, the candidate must ALSO be mutually
        **density-connected**: cluster i's members must sit as close to
        centroid j as j's own members do (within ``density_alpha`` standard
        deviations), and vice versa. Same-topic splits pass (the halves share
        one density mode); genuinely distinct-but-correlated topics fail (each
        cluster's members are systematically farther from the other's core).
        Raw centroid cosine alone cannot tell these apart — measured on labeled
        corpora with 50% shared sibling vocabulary, cosine-only merging at 0.6
        collapses sibling topics (L1 purity 0.99 -> 0.25) while the density
        test keeps them separate (reports/cluster_eval_10k_hier.json).
        """
        k = cents.shape[0]
        parent = list(range(k))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        cc = cents @ cents.T
        if emb is not None:
            sims = emb @ cents.T                         # [N, k]
            mu = np.zeros(k)
            sd = np.zeros(k)
            cross = np.zeros((k, k))                     # cross[i, j] = mean sim of i's members to centroid j
            for c in range(k):
                m = assign == c
                if m.any():
                    mu[c] = float(sims[m, c].mean())
                    sd[c] = float(sims[m, c].std())
                    cross[c] = sims[m].mean(axis=0)
                else:
                    mu[c] = np.inf                       # empty: never connect
            sd = np.maximum(sd, 0.02)                    # singleton/degenerate floor

        def connected(i: int, j: int) -> bool:
            if cc[i, j] <= threshold:
                return False
            if emb is None:
                return True
            return bool(cross[i, j] >= mu[j] - density_alpha * sd[j]
                        and cross[j, i] >= mu[i] - density_alpha * sd[i])

        for i in range(k):
            for j in range(i + 1, k):
                if connected(i, j):
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[max(ri, rj)] = min(ri, rj)
        roots = sorted({find(i) for i in range(k)})
        remap = {r: d for d, r in enumerate(roots)}
        new_assign = np.array([remap[find(int(t))] for t in assign],
                              dtype=np.int64)
        new_cents = np.zeros((len(roots), cents.shape[1]), cents.dtype)
        for d in range(len(roots)):
            m = new_assign == d
            if m.any():
                v = cents[[i for i in range(k) if remap[find(i)] == d]].mean(axis=0)
            else:  # merged group lost every point to other argmaxes (degenerate)
                v = cents[roots[d]]
            new_cents[d] = v / max(float(np.linalg.norm(v)), 1e-9)
        return new_assign, new_cents

    # --------------------------------------------------------- summarization
    def _heuristic_topic_summary(self, node: Dict[str, Any]) -> TopicSummary:
        tw = node.get("top_words", [])
        title = " / ".join(tw[:3]) or f"Topic {node.get('topic_id')}"
        snippets = []
        for name in node.get("members", [])[:20]:
            ent = self.entities_map.get(name)
            if ent and (ent.description or ent.name):
                snippets.append((ent.description or ent.name)[:160])
        summary = " ".join(snippets[:3]) or "Cluster of semantically related entities."
        return TopicSummary(topic_id=int(node["topic_id"]), title=title,
                            summary=summary, confidence=5.0)

    def summarize_topics(self, l1_nodes: List[Dict[str, Any]],
                         max_members_per_topic: int = 20,
                         member_snippet_len: int = 160) -> List[TopicSummary]:
        if not l1_nodes:
            return []
        out: List[TopicSummary] = []
        for node in l1_nodes:
            texts = []
            for name in node.get("members", [])[:max_members_per_topic]:
                ent = self.entities_map.get(name)
                if ent and (ent.description or ent.name):
                    texts.append((ent.description or ent.name)[:member_snippet_len])
            prompt = (
                "You are a precision knowledge-aggregation assistant. Produce a JSON "
                "summary for this topic cluster.\n"
                f"- topic_id: {node.get('topic_id')}\n"
                f"- keywords: {', '.join(node.get('top_words', []))}\n"
                f"- member descriptions:\n- " + "\n- ".join(texts) + "\n\n"
                "Return ONLY one JSON object with fields topic_id (int), title "
                "(<= 20 words), summary (2-3 sentences synthesizing the common theme, "
                "no enumerations), confidence (1-10 float).")
            obj = self._llm_json(prompt)
            summary = (TopicSummary.model_validate({**obj, "topic_id": int(node["topic_id"])})
                       if isinstance(obj, dict) else None)
            out.append(summary or self._heuristic_topic_summary(node))

        self._write("l1_summaries.json", [s.model_dump() for s in out])
        tid_to_summary = {s.topic_id: s for s in out}
        for n in l1_nodes:
            s = tid_to_summary.get(int(n["topic_id"]))
            if s:
                n["title"], n["summary"], n["confidence"] = s.title, s.summary, s.confidence
        self._write("l1_nodes.json", l1_nodes)
        return out

    # -------------------------------------------------------------- relations
    def generate_l1_relations(self, l1_nodes: List[Dict[str, Any]],
                              min_overlap: int = 3, min_jaccard: float = 0.2,
                              min_cosine: float = 0.5,
                              top_k: Optional[int] = None,
                              out_edges_name: str = "l1_edges.json",
                              out_nodes_name: str = "l1_nodes.json"
                              ) -> List[Dict[str, Any]]:
        if not l1_nodes:
            return []
        tids = [int(n["topic_id"]) for n in l1_nodes]
        members = {int(n["topic_id"]): set(n.get("members", [])) for n in l1_nodes}
        confidences = {int(n["topic_id"]): float(n.get("confidence", 5.0))
                       for n in l1_nodes}
        cents = {}
        for n in l1_nodes:
            c = n.get("centroid")
            if c is not None:
                arr = np.asarray(c, dtype=np.float32)
                norm = np.linalg.norm(arr)
                cents[int(n["topic_id"])] = arr / norm if norm > 0 else arr
        edges: List[Dict[str, Any]] = []
        for i, a in enumerate(sorted(tids)):
            for b in sorted(tids)[i + 1:]:
                A, B = members.get(a, set()), members.get(b, set())
                if not A and not B:
                    continue
                inter, union = A & B, A | B
                overlap = len(inter)
                jaccard = len(inter) / len(union) if union else 0.0
                ca, cb = cents.get(a), cents.get(b)
                cosine = float(np.dot(ca, cb)) if ca is not None and cb is not None else 0.0
                if not (overlap >= min_overlap or jaccard >= min_jaccard
                        or cosine >= min_cosine):
                    continue
                edges.append({
                    "source": a, "target": b, "relation_type": "related_summary",
                    "weight": round(0.5 * jaccard + 0.5 * cosine, 4),
                    "overlap": overlap, "jaccard": round(jaccard, 4),
                    "cosine": round(cosine, 4),
                    "confidence": round((confidences.get(a, 5.0)
                                         + confidences.get(b, 5.0)) / 2.0, 2),
                })
        if top_k is not None and len(edges) > top_k:
            edges = sorted(edges, key=lambda e: e["weight"], reverse=True)[:top_k]
        self._write(out_edges_name, edges)

        adj: Dict[int, List] = {t: [] for t in tids}
        for e in edges:
            adj[e["source"]].append((e["target"], e["weight"]))
            adj[e["target"]].append((e["source"], e["weight"]))
        for n in l1_nodes:
            tid = int(n["topic_id"])
            n["neighbors"] = [{"topic_id": t, "weight": w} for t, w in
                              sorted(adj.get(tid, []), key=lambda x: -x[1])]
        self._write(out_nodes_name, l1_nodes)
        return edges

    # ------------------------------------------------------------------- L2
    def aggregate_level2_via_communities(self, l1_nodes: List[Dict[str, Any]],
                                         min_comm_size: int = 3,
                                         edge_weight_min: float = 0.15,
                                         level: int = 2,
                                         edges_name: str = "l1_edges.json",
                                         out_nodes_name: str = "l2_nodes.json",
                                         out_map_name: str = "l1_to_l2.json"
                                         ) -> List[Dict[str, Any]]:
        tid_to_node = {int(n["topic_id"]): n for n in l1_nodes}
        edges_path = os.path.join(self.artifact_dir, edges_name)
        raw_edges: List[Dict[str, Any]] = []
        if os.path.exists(edges_path):
            with open(edges_path, "r", encoding="utf-8") as f:
                raw_edges = json.load(f)
        weighted = [(int(e["source"]), int(e["target"]), float(e.get("weight", 0.0)))
                    for e in raw_edges
                    if float(e.get("weight", 0.0)) >= edge_weight_min
                    and int(e["source"]) in tid_to_node and int(e["target"]) in tid_to_node]
        if weighted:
            comms = greedy_modularity_communities(sorted(tid_to_node), weighted)
        else:
            comms = [sorted(tid_to_node)] if tid_to_node else []
        comms = [list(c) for c in comms if len(c) >= min_comm_size]
        if not comms:
            self._write(out_nodes_name, [])
            self._write(out_map_name, {})
            return []

        l2_nodes: List[Dict[str, Any]] = []
        l1_to_l2: Dict[str, int] = {}
        # L2 topic ids are namespaced past the L1 range. The reference numbers
        # communities from 0 (semantic_aggregator.py:533), which collides with L1
        # topic ids in the shared topic_id -> summary map and silently merges
        # sum:<cid> nodes across levels (self-loop belongs_to) — a latent reference
        # bug, fixed here (the loader also defends against colliding artifacts).
        base = (max(int(n["topic_id"]) for n in l1_nodes) + 1) if l1_nodes else 0
        for cid, tids in enumerate(comms):
            cid = base + cid
            member_names, centroids, top_words, bodies = [], [], [], []
            for tid in tids:
                n = tid_to_node.get(int(tid))
                if not n:
                    continue
                member_names.append(f"sum:{int(tid)}")
                if n.get("centroid"):
                    centroids.append(np.asarray(n["centroid"], dtype=float))
                top_words.extend((n.get("top_words") or [])[:5])
                bodies.append(f"- {n.get('title') or ''}: "
                              f"{n.get('summary') or n.get('summary_text') or ''}")
            title, summary_txt, conf = f"Community {cid}", \
                "Community of related L1 topic summaries.", 7.0
            obj = self._llm_json(
                "Summarize this community of L1 topic summaries. Return ONLY one JSON "
                "object with fields topic_id (int), title (one line), summary (2-3 "
                "sentences covering the shared theme and its variation), confidence "
                f"(1-10 float).\ncommunity_id: {cid}\nmember summaries:\n"
                + "\n".join(bodies), max_tokens=800)
            if obj:
                title = obj.get("title", title)
                summary_txt = obj.get("summary", summary_txt)
                parsed = float_or_none(obj.get("confidence", conf))
                conf = conf if parsed is None else parsed
            elif top_words:
                title = " / ".join(list(dict.fromkeys(top_words))[:3])
                summary_txt = ("Community spanning topics: "
                               + "; ".join(b.lstrip("- ") for b in bodies[:3]))
            l2_nodes.append({
                "topic_id": int(cid), "title": title, "summary": summary_txt,
                "confidence": conf,
                "top_words": list(dict.fromkeys(top_words))[:10],
                "members": member_names,
                "centroid": (np.mean(centroids, axis=0).tolist()
                             if centroids else None),
                "level": level,
            })
            for tid in tids:
                l1_to_l2[str(int(tid))] = int(cid)
        self._write(out_nodes_name, l2_nodes)
        self._write(out_map_name, l1_to_l2)
        return l2_nodes

    # ----------------------------------------------------------------- judge
    def _judge_one(self, meta: Dict[str, Any], subject: str,
                   fallback_id: int) -> JudgeScore:
        prompt = (
            f"You are a strict reviewer. Score this {subject} 1-10 (decimals allowed) "
            "on consistency, accuracy, informativeness, and overall.\n"
            f"metadata:\n{json.dumps(meta, ensure_ascii=False, indent=2)}\n"
            "Return ONLY one JSON object with fields id/consistency/accuracy/"
            "informativeness/overall/comments.")
        obj = self._llm_json(prompt)
        if isinstance(obj, dict):
            got = int_or_none(obj.get("id", fallback_id))
            score = (None if got is None
                     else JudgeScore.model_validate({**obj, "id": got}))
            if score is not None:
                return score
        return JudgeScore(id=fallback_id, consistency=6.0, accuracy=6.0,
                          informativeness=6.0, overall=6.0, comments="fallback")

    def judge_samples(self, l1_nodes: List[Dict[str, Any]],
                      l1_edges: List[Dict[str, Any]], node_sample_size: int = 5,
                      edge_sample_size: int = 5,
                      seed: int = 42) -> Dict[str, List[JudgeScore]]:
        if (not l1_nodes and not l1_edges) or self._llm() is None:
            return {"nodes": [], "edges": []}
        rng = random.Random(seed)
        node_samples = rng.sample(l1_nodes, k=min(node_sample_size, len(l1_nodes))) \
            if l1_nodes else []
        edge_samples = rng.sample(l1_edges, k=min(edge_sample_size, len(l1_edges))) \
            if l1_edges else []
        node_scores = [self._judge_one(
            {"topic_id": int(n["topic_id"]), "title": n.get("title"),
             "summary": n.get("summary"), "top_words": n.get("top_words", []),
             "members": n.get("members", [])[:10]},
            "topic node", int(n["topic_id"])) for n in node_samples]
        edge_scores = [self._judge_one(
            {"source": e.get("source"), "target": e.get("target"),
             "relation_type": e.get("relation_type"),
             "diagnostics": {k: e.get(k) for k in ("overlap", "jaccard", "cosine",
                                                   "weight")}},
            "topic relation", int(e.get("source", 0))) for e in edge_samples]
        self._write("l1_judge_nodes.json", [s.model_dump() for s in node_scores])
        self._write("l1_judge_edges.json", [s.model_dump() for s in edge_scores])
        return {"nodes": node_scores, "edges": edge_scores}

    def judge_level_nodes(self, nodes: List[Dict[str, Any]], node_sample_size: int = 2,
                          out_name: str = "l2_judge_nodes.json",
                          seed: int = 42) -> List[Dict[str, Any]]:
        if not nodes or self._llm() is None:
            return []
        rng = random.Random(seed)
        samples = rng.sample(nodes, k=min(node_sample_size, len(nodes)))
        results = [self._judge_one(
            {"topic_id": int(n["topic_id"]), "title": n.get("title"),
             "summary": n.get("summary") or n.get("summary_text"),
             "top_words": n.get("top_words", [])[:10],
             "members": n.get("members", [])[:10]},
            "L2 topic node", int(n["topic_id"])).model_dump() for n in samples]
        self._write(out_name, results)
        return results

    # ------------------------------------------------------------ escalation
    def escalate(self, l1_nodes: List[Dict[str, Any]], max_levels: int = 4,
                 min_comm_size: int = 3,
                 judge_sample_size: int = 2) -> List[List[Dict[str, Any]]]:
        """Build L3, L4, ... by re-applying community aggregation until the
        escalation metrics raise ``should_stop_escalation``.

        The reference computes the stop flag (semantic_aggregator.py:406-460) but
        never loops on it — L2 is always its last level. This driver completes the
        design: each round clusters the previous level's nodes by member overlap /
        centroid cosine, summarizes the communities, judges a sample, recomputes
        the metrics, and stops when the thresholds say so. Artifacts per level:
        l<k>_nodes.json, l<k-1>_to_l<k>.json, l<k>_judge_nodes.json.

        Returns the list of node-lists per built level (starting at L2).
        """
        built: List[List[Dict[str, Any]]] = []
        prev = l1_nodes
        for level in range(2, max_levels + 1):
            edges_name = "l1_edges.json" if level == 2 else f"l{level - 1}_edges.json"
            if level > 2:
                # relations among the previous (summary) level feed its communities
                self.generate_l1_relations(
                    prev, min_overlap=1, min_jaccard=0.05, min_cosine=0.3,
                    out_edges_name=edges_name,
                    out_nodes_name=f"l{level - 1}_nodes.json")
            nodes = self.aggregate_level2_via_communities(
                prev, min_comm_size=min_comm_size, level=level,
                edges_name=edges_name,
                out_nodes_name=f"l{level}_nodes.json",
                out_map_name=f"l{level - 1}_to_l{level}.json")
            if not nodes:
                break
            self.judge_level_nodes(nodes, node_sample_size=judge_sample_size,
                                   out_name=f"l{level}_judge_nodes.json")
            metrics = self.compute_escalation_metrics(
                prev, nodes,
                l1_to_l2_name=f"l{level - 1}_to_l{level}.json",
                l2_judge_name=f"l{level}_judge_nodes.json")
            built.append(nodes)
            if metrics.get("should_stop_escalation"):
                break
            prev = nodes
        return built

    def compute_escalation_metrics(self, l1_nodes: List[Dict[str, Any]],
                                   l2_nodes: List[Dict[str, Any]],
                                   thresholds: Optional[Dict[str, float]] = None,
                                   l1_to_l2_name: str = "l1_to_l2.json",
                                   l1_judge_name: str = "l1_judge_nodes.json",
                                   l2_judge_name: str = "l2_judge_nodes.json"
                                   ) -> Dict[str, Any]:
        thresholds = thresholds or {"compression": 1.5, "improvement": 0.2,
                                    "coverage": 0.9}
        c_ratio = (len(l1_nodes) / max(1, len(l2_nodes))) if l2_nodes else 0.0
        l1_to_l2_path = os.path.join(self.artifact_dir, l1_to_l2_name)
        l1_to_l2 = {}
        if os.path.exists(l1_to_l2_path):
            with open(l1_to_l2_path, "r", encoding="utf-8") as f:
                l1_to_l2 = json.load(f)
        covered = sum(1 for n in l1_nodes if str(int(n["topic_id"])) in l1_to_l2)
        coverage = covered / len(l1_nodes) if l1_nodes else 0.0

        def mean_overall(name: str) -> Optional[float]:
            p = os.path.join(self.artifact_dir, name)
            if not os.path.exists(p):
                return None
            with open(p, "r", encoding="utf-8") as f:
                arr = json_or_none(f.read())
            if not (isinstance(arr, list) and all(isinstance(x, dict) for x in arr)):
                return None
            vals = [float_or_none(x["overall"]) for x in arr
                    if isinstance(x.get("overall"), (int, float))]
            if None in vals:
                return None
            return sum(vals) / len(vals) if vals else None

        mean_l1 = mean_overall(l1_judge_name)
        mean_l2 = mean_overall(l2_judge_name)
        improvement = (mean_l2 - mean_l1) if (mean_l1 is not None
                                              and mean_l2 is not None) else None
        if not l2_nodes:
            should_stop = True
        else:
            should_stop = not (c_ratio >= thresholds["compression"]
                               and improvement is not None
                               and improvement >= thresholds["improvement"]
                               and coverage >= thresholds["coverage"])
        metrics = {
            "compression_ratio_l1_over_l2": round(c_ratio, 4),
            "coverage_l1_to_l2": round(coverage, 4),
            "mean_judge_overall_l1": mean_l1,
            "mean_judge_overall_l2": mean_l2,
            "improvement_overall": None if improvement is None else round(improvement, 4),
            "thresholds": thresholds,
            "should_stop_escalation": should_stop,
        }
        self._write("metrics.json", metrics)
        return metrics
