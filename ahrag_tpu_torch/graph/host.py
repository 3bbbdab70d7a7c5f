"""Host-facing HierarchicalGraph: build, persist, validate and search.

Port of ``ahrag_tpu/graph/host.py``. Node and edge data live in plain host
dicts (insertion-ordered) and compile on demand into ``GraphTensors`` on the
graph's device for the batched hybrid search. The contracts are the JAX
package's:

- stable content-hash ids ``ent:<sha1[:10]>`` / ``hedge:<uid>`` /
  ``sum:<topic_id>``;
- entity merge on re-add (a description fills only if empty);
- artifact assembly from the pipeline's JSON files, with the L1/L2 topic-id
  remap and the levels above L2;
- snapshots of ``structure.json`` (node-link, ``links``; the loader takes
  ``edges`` too), ``meta.json`` and ``embeddings.npz`` that either package
  loads;
- incremental vector indexing keyed by per-node content hash;
- ``search()`` with its parameters resolved from the stored
  ``search_params`` and the reference's result and cluster dict shapes.

Query projection. A graph indexed with the default ``fit_lsa=True`` stores its
LSA basis, and queries are projected through it in either package. Without
one, the documents were projected through the hashed encoder's Gaussian,
which the JAX package draws from ``jax.random`` and the port reproduces
without JAX only to within 6e-6 relatively (``utils/jax_random.normal``).
``load`` therefore refuses a saved graph with embeddings but no ``lsa``
unless the caller passes the projection the documents were built with
(``convert.projection_from_numpy``); a graph the port indexed itself is
consistent with its own Gaussian.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.graph.search import SearchWeights, hybrid_search
from ahrag_tpu_torch.graph.tensors import NODE_TYPE_IDS, GraphTensors, build_graph_tensors
from ahrag_tpu_torch.models.encoder import create_encoder
from ahrag_tpu_torch.utils.config import load_config
from ahrag_tpu_torch.utils.parse import float_or_none, int_or_none, json_or_none

DEFAULT_SEARCH_PARAMS: Dict[str, Any] = {
    "alpha": 0.6, "beta": 0.2, "gamma": 0.1, "delta": 0.1,
    "judge_overall_min": None, "confidence_min": None,
    "member_top_m": 5, "type_filter": None,
    "layer_boost": {"entity": 0.0, "summary": 1.0, "hyperedge": 0.0},
}


def _sha1(text: str, length: int = 10) -> str:
    return hashlib.sha1(text.encode("utf-8")).hexdigest()[:length]


def _as_obj(value: Any) -> Any:
    """Decode reference-style JSON-string attributes; a string that is not
    JSON stays as it is."""
    if isinstance(value, str):
        obj = json_or_none(value)
        if obj is None and value.strip(" \t\n\r") != "null":
            return value
        return obj
    return value


class HierarchicalGraph:
    def __init__(self, encoder_name: Optional[str] = None, device=None) -> None:
        """``device`` holds the compiled tensors and runs the encoder and the
        search: ``cuda`` unless the caller names another."""
        self.device = resolve_device(device)
        self.nodes: Dict[str, Dict[str, Any]] = {}          # insertion-ordered
        self._edge_set: set[Tuple[str, str, str]] = set()
        self.n_edges_total = 0
        # per-direction adjacency, append order == edge insertion order
        self._parents: Dict[str, List[str]] = {}            # belongs_to out
        self._children: Dict[str, List[str]] = {}           # belongs_to in
        self._rel_out: Dict[str, List[str]] = {}
        self._rel_in: Dict[str, List[str]] = {}
        self._hedges_of: Dict[str, List[str]] = {}          # participates_in out
        self._members_of: Dict[str, List[str]] = {}         # participates_in in
        self._edge_attrs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.name_to_entity_id: Dict[str, str] = {}
        self.topic_to_summary_id: Dict[int, str] = {}
        self.search_params: Dict[str, Any] = dict(DEFAULT_SEARCH_PARAMS)
        self.dirty = False
        self.judge_edges: List[Dict[str, Any]] = []
        # vector index state
        self._encoder_name = encoder_name
        self.vector_index: Dict[str, Any] = {"model": None, "indexed_nodes": 0,
                                             "indexed_meta": {}}
        self._embeddings: Dict[str, np.ndarray] = {}        # node_id -> [D]
        self._idf: Optional[np.ndarray] = None              # [buckets] corpus weights
        self._assoc = None   # (idx [B, m], w [B, m]) query-expansion associations
        self._lsa: Optional[np.ndarray] = None  # [buckets, D] corpus-fitted basis
        # the Gaussian the stored documents were projected with, where it is
        # not the encoder's own (a JAX-built graph without an lsa basis);
        # it stands wherever the JAX package uses its encoder's Gaussian
        self._projection: Optional[torch.Tensor] = None
        self._basis_dev: Optional[torch.Tensor] = None      # device copy of _lsa
        # compiled tensors cache
        self._compile_lock = threading.Lock()
        self._tensors: Optional[GraphTensors] = None
        self._idx_to_id: List[str] = []
        self._id_to_idx: Dict[str, int] = {}

    # ------------------------------------------------------------------ ids
    @staticmethod
    def make_entity_id(name: str) -> str:
        return f"ent:{_sha1(name)}"

    @staticmethod
    def make_hyperedge_id(uid: str) -> str:
        return f"hedge:{uid}"

    @staticmethod
    def make_summary_id(topic_id: int) -> str:
        return f"sum:{int(topic_id)}"

    # --------------------------------------------------------------- mutation
    def _touch(self) -> None:
        self.dirty = True
        self._tensors = None

    def add_entity(self, name: str, description: Optional[str] = None,
                   entity_type: Optional[str] = None,
                   l1_parents: Optional[Dict[str, float]] = None) -> str:
        node_id = self.name_to_entity_id.get(name)
        if node_id is None:
            node_id = self.make_entity_id(name)
            self.nodes[node_id] = {
                "node_type": "entity", "name": name, "description": description,
                "entity_type": entity_type, "l1_parents": l1_parents,
            }
            self.name_to_entity_id[name] = node_id
        else:
            d = self.nodes[node_id]
            if description is not None and not d.get("description"):
                d["description"] = description
            if entity_type is not None and not d.get("entity_type"):
                d["entity_type"] = entity_type
            if l1_parents is not None:
                d["l1_parents"] = l1_parents
        self._touch()
        return node_id

    def add_hyperedge(self, uid: str, description: str, relation_type: str,
                      confidence_score: Optional[float] = None,
                      source_text_ref: Optional[str] = None) -> str:
        node_id = self.make_hyperedge_id(uid)
        if node_id not in self.nodes:
            self.nodes[node_id] = {
                "node_type": "hyperedge", "description": description,
                "relation_type": relation_type, "confidence_score": confidence_score,
                "source_text_ref": source_text_ref,
            }
        self._touch()
        return node_id

    def add_summary(self, topic_id: int, title: Optional[str] = None,
                    summary_text: Optional[str] = None, confidence: Optional[float] = None,
                    top_words: Optional[List[str]] = None, members: Optional[List[str]] = None,
                    judge_scores: Optional[Dict[str, Any]] = None,
                    centroid: Optional[List[float]] = None, level: Optional[int] = None) -> str:
        node_id = self.topic_to_summary_id.get(int(topic_id))
        if node_id is None:
            node_id = self.make_summary_id(topic_id)
            self.nodes[node_id] = {"node_type": "summary", "topic_id": int(topic_id)}
            self.topic_to_summary_id[int(topic_id)] = node_id
        d = self.nodes[node_id]
        for key, val in (("title", title), ("summary_text", summary_text),
                         ("confidence", confidence), ("top_words", top_words),
                         ("members", members), ("judge_scores", judge_scores),
                         ("centroid", centroid), ("level", level)):
            if val is not None:
                d[key] = val
        self._touch()
        return node_id

    def _add_edge(self, u: str, v: str, edge_type: str, **attrs: Any) -> bool:
        key = (u, v, edge_type)
        self._edge_attrs[(u, v)] = {"edge_type": edge_type, **attrs}
        if key in self._edge_set:
            return False
        self._edge_set.add(key)
        self.n_edges_total += 1
        return True

    def add_participation(self, entity_id: str, hyperedge_id: str,
                          role: Optional[str] = None) -> None:
        if self._add_edge(entity_id, hyperedge_id, "participates_in", role=role):
            self._hedges_of.setdefault(entity_id, []).append(hyperedge_id)
            self._members_of.setdefault(hyperedge_id, []).append(entity_id)
        self._touch()

    def add_belongs_to(self, child_id: str, parent_id: str,
                       prob: Optional[float] = None) -> None:
        if self._add_edge(child_id, parent_id, "belongs_to", prob=prob):
            self._parents.setdefault(child_id, []).append(parent_id)
            self._children.setdefault(parent_id, []).append(child_id)
        self._touch()

    def add_related(self, summary_a: str, summary_b: str, weight: Optional[float] = None,
                    jaccard: Optional[float] = None, cosine: Optional[float] = None,
                    overlap: Optional[int] = None, confidence: Optional[float] = None) -> None:
        if self._add_edge(summary_a, summary_b, "related_to", weight=weight,
                          jaccard=jaccard, cosine=cosine, overlap=overlap,
                          confidence=confidence):
            self._rel_out.setdefault(summary_a, []).append(summary_b)
            self._rel_in.setdefault(summary_b, []).append(summary_a)
        self._touch()

    # ---------------------------------------------------------------- queries
    def get_belongs_to(self, node_id: str) -> List[str]:
        return list(self._parents.get(node_id, []))

    def get_summary_members(self, summary_id: str) -> List[str]:
        return list(self._children.get(summary_id, []))

    def get_parents(self, node_id: str) -> List[str]:
        """All out-neighbours regardless of edge type."""
        out = list(self._parents.get(node_id, [])) + list(self._hedges_of.get(node_id, []))
        return out + list(self._rel_out.get(node_id, []))

    def get_children(self, node_id: str) -> List[str]:
        out = list(self._children.get(node_id, [])) + list(self._members_of.get(node_id, []))
        return out + list(self._rel_in.get(node_id, []))

    def get_hyperedge_participants(self, hyperedge_id: str) -> List[str]:
        return list(self._members_of.get(hyperedge_id, []))

    def get_entity_hyperedges(self, entity_id: str) -> List[str]:
        return list(self._hedges_of.get(entity_id, []))

    def get_related(self, node_id: str) -> List[str]:
        """related_to neighbours, out-edges first, then in-edges."""
        return list(self._rel_out.get(node_id, [])) + list(self._rel_in.get(node_id, []))

    def get_siblings(self, node_id: str) -> List[str]:
        sibs: Dict[str, None] = {}
        for p in self.get_belongs_to(node_id):
            for child in self.get_summary_members(p):
                if child != node_id:
                    sibs[child] = None
        return list(sibs)

    def find_entity(self, name: str) -> Optional[str]:
        return self.name_to_entity_id.get(name)

    def find_summary(self, topic_id: int) -> Optional[str]:
        return self.topic_to_summary_id.get(int(topic_id))

    def search_by_name_or_title(self, q: str, limit: int = 20) -> List[Tuple[str, Dict[str, Any]]]:
        ql = q.lower()
        out = []
        for nid, d in self.nodes.items():
            if ql in str(d.get("name") or "").lower() or ql in str(d.get("title") or "").lower():
                out.append((nid, d))
            if len(out) >= limit:
                break
        return out

    def summaries_with_top_word(self, word: str, limit: int = 50) -> List[str]:
        w = word.lower()
        out = []
        for nid, d in self.nodes.items():
            if d.get("node_type") != "summary":
                continue
            tw = _as_obj(d.get("top_words")) or []
            if any(w in str(x).lower() for x in tw):
                out.append(nid)
            if len(out) >= limit:
                break
        return out

    # ------------------------------------------------------------- validators
    def validate_belongs_to_dag(self) -> bool:
        """Kahn's algorithm over belongs_to edges."""
        indeg: Dict[str, int] = {}
        for child, pars in self._parents.items():
            indeg.setdefault(child, 0)
            for p in pars:
                indeg[p] = indeg.get(p, 0) + 1
        queue = [n for n, dcount in indeg.items() if dcount == 0]
        seen = 0
        while queue:
            n = queue.pop()
            seen += 1
            for p in self._parents.get(n, []):
                indeg[p] -= 1
                if indeg[p] == 0:
                    queue.append(p)
        return seen == len(indeg)

    def validate_required_attributes(self) -> Dict[str, List[str]]:
        problems: Dict[str, List[str]] = {"entity": [], "hyperedge": [], "summary": []}
        for nid, d in self.nodes.items():
            nt = d.get("node_type")
            if nt == "entity" and not d.get("name"):
                problems["entity"].append(nid)
            elif nt == "hyperedge" and (not d.get("description") or not d.get("relation_type")):
                problems["hyperedge"].append(nid)
            elif nt == "summary" and d.get("topic_id") is None:
                problems["summary"].append(nid)
        return problems

    def stats(self) -> Dict[str, Any]:
        counts = {"entity": 0, "hyperedge": 0, "summary": 0}
        for d in self.nodes.values():
            t = d.get("node_type")
            if t in counts:
                counts[t] += 1
        edge_counts = {"participates_in": 0, "belongs_to": 0, "related_to": 0}
        for (_, _, et) in self._edge_set:
            if et in edge_counts:
                edge_counts[et] += 1
        return {"nodes": counts, "edges": edge_counts,
                "n_nodes": len(self.nodes), "n_edges": self.n_edges_total}

    # ------------------------------------------------------------ attr access
    def node_judge_overall(self, node_id: str) -> Optional[float]:
        js = _as_obj(self.nodes.get(node_id, {}).get("judge_scores"))
        if isinstance(js, dict):
            return float_or_none(js.get("overall", 0.0))
        return None

    def node_confidence(self, node_id: str) -> Optional[float]:
        d = self.nodes.get(node_id, {})
        c = d.get("confidence", d.get("confidence_score"))
        return None if c is None else float_or_none(c)

    def node_layer(self, node_id: str) -> int:
        """Level-aware layer: 0 for entities, else the stored level (1 for a
        summary without one)."""
        d = self.nodes.get(node_id, {})
        nt = d.get("node_type")
        if nt == "entity":
            return 0
        return int(d.get("level") or (1 if nt == "summary" else 0))

    # -------------------------------------------------------------- persistence
    def _graph_snapshot_hash(self) -> str:
        items = sorted(
            (nid, d.get("node_type"), d.get("name"), d.get("title"),
             d.get("summary_text"), d.get("description"))
            for nid, d in self.nodes.items())
        return hashlib.sha1(json.dumps(items, ensure_ascii=False).encode("utf-8")).hexdigest()

    def save(self, directory: str = "graph", meta: Optional[Dict[str, Any]] = None) -> None:
        os.makedirs(directory, exist_ok=True)
        structure = {
            "directed": True,
            "nodes": [{"id": nid, **d} for nid, d in self.nodes.items()],
            # "links", as node-link JSON has it; the loader accepts "edges" too
            "links": [{"source": u, "target": v,
                       **self._edge_attrs.get((u, v), {"edge_type": et})}
                      for (u, v, et) in self._iter_edges_in_order()],
        }
        with open(os.path.join(directory, "structure.json"), "w", encoding="utf-8") as f:
            json.dump(structure, f, ensure_ascii=False, indent=2)
        merged = dict(meta or {})
        merged["search_params"] = self.search_params
        merged["graph_hash"] = self._graph_snapshot_hash()
        merged["dirty"] = self.dirty
        merged["vector_index"] = dict(self.vector_index)
        with open(os.path.join(directory, "meta.json"), "w", encoding="utf-8") as f:
            json.dump(merged, f, ensure_ascii=False, indent=2)
        if self._embeddings:
            ids = list(self._embeddings.keys())
            mat = np.stack([self._embeddings[i] for i in ids])
            extra = {}
            if self._idf is not None:
                extra["idf"] = self._idf
            if self._assoc is not None:
                extra["assoc_idx"], extra["assoc_w"] = self._assoc
            if self._lsa is not None:
                extra["lsa"] = self._lsa
            np.savez_compressed(os.path.join(directory, "embeddings.npz"),
                                ids=np.asarray(ids), emb=mat, **extra)

    def _iter_edges_in_order(self):
        """Edges in insertion order per type (rebuilt from the adjacency)."""
        for child, pars in self._parents.items():
            for p in pars:
                yield (child, p, "belongs_to")
        for a, outs in self._rel_out.items():
            for b in outs:
                yield (a, b, "related_to")
        for e, hs in self._hedges_of.items():
            for h in hs:
                yield (e, h, "participates_in")

    @classmethod
    def load(cls, directory: str = "graph", device=None,
             projection=None) -> "HierarchicalGraph":
        """Load a snapshot saved by either package onto ``device``.

        ``projection`` ([buckets, dim]) is the projection the stored
        embeddings were built with; it is needed, and required, only when
        ``embeddings.npz`` holds embeddings but no ``lsa`` basis."""
        hg = cls(device=device)
        with open(os.path.join(directory, "structure.json"), "r", encoding="utf-8") as f:
            data = json.load(f)
        for nd in data.get("nodes", []):
            nid = nd.get("id")
            attrs = {k: v for k, v in nd.items() if k != "id"}
            # decode reference-style JSON-string attrs
            for key in ("l1_parents", "top_words", "members", "judge_scores", "centroid"):
                if key in attrs:
                    attrs[key] = _as_obj(attrs[key])
            hg.nodes[nid] = attrs
            if attrs.get("node_type") == "entity" and attrs.get("name"):
                hg.name_to_entity_id[attrs["name"]] = nid
            if attrs.get("node_type") == "summary" and attrs.get("topic_id") is not None:
                hg.topic_to_summary_id[int(attrs["topic_id"])] = nid
        edges = data.get("edges", data.get("links", []))
        for e in edges:
            u, v, et = e.get("source"), e.get("target"), e.get("edge_type")
            attrs = {k: val for k, val in e.items() if k not in {"source", "target", "edge_type"}}
            if et == "belongs_to":
                hg.add_belongs_to(u, v, prob=attrs.get("prob"))
            elif et == "related_to":
                hg.add_related(u, v, **{k: attrs.get(k) for k in
                                        ("weight", "jaccard", "cosine", "overlap", "confidence")})
            elif et == "participates_in":
                hg.add_participation(u, v, role=attrs.get("role"))
        meta_path = os.path.join(directory, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path, "r", encoding="utf-8") as f:
                meta = json_or_none(f.read())
            if isinstance(meta, dict):
                if isinstance(meta.get("search_params"), dict):
                    hg.search_params = {**hg.search_params, **meta["search_params"]}
                if isinstance(meta.get("vector_index"), dict):
                    hg.vector_index.update(meta["vector_index"])
                if isinstance(meta.get("dirty"), bool):
                    hg.dirty = meta["dirty"]
        emb_path = os.path.join(directory, "embeddings.npz")
        if os.path.exists(emb_path):
            z = np.load(emb_path, allow_pickle=False)
            for nid, row in zip(z["ids"].tolist(), z["emb"]):
                hg._embeddings[str(nid)] = np.asarray(row, dtype=np.float32)
            if "idf" in z:
                hg._idf = np.asarray(z["idf"], dtype=np.float32)
            if "assoc_idx" in z and "assoc_w" in z:
                hg._assoc = (np.asarray(z["assoc_idx"], dtype=np.int32),
                             np.asarray(z["assoc_w"], dtype=np.float32))
            if "lsa" in z:
                hg._lsa = np.asarray(z["lsa"], dtype=np.float32)
            elif hg._embeddings and projection is None:
                raise ValueError(
                    f"{emb_path} holds embeddings but no 'lsa' basis: its documents "
                    "were projected through the encoder's Gaussian, which the JAX "
                    "package draws from jax.random and this package reproduces only "
                    "to within 6e-6 relatively, so queries would not rank exactly as "
                    "the documents were built. Pass "
                    "the documents' projection (projection=..., e.g. from "
                    "convert.projection_from_numpy), or rebuild the index "
                    "(build_vector_index(reset=True)) after loading without "
                    "embeddings.npz")
            if projection is not None and hg._lsa is None:
                if not isinstance(projection, torch.Tensor):
                    projection = torch.from_numpy(np.array(projection, np.float32))
                hg._projection = projection.to(hg.device, torch.float32)
        else:
            hg.dirty = True  # needs (re)indexing before search
        hg._tensors = None
        return hg

    # ------------------------------------------------------- artifact assembly
    def build_from_artifacts(self, artifacts_dir: str = "artifacts") -> None:
        """Assemble the graph from the pipeline's JSON artifacts."""

        def _load(name, default):
            p = os.path.join(artifacts_dir, name)
            if os.path.exists(p):
                with open(p, "r", encoding="utf-8") as f:
                    return json.load(f)
            return default

        topics = _load("topics.json", {})
        entity_to_parents: Dict[str, List[Dict[str, Any]]] = topics.get("entity_to_parents", {})
        l1_nodes = _load("l1_nodes.json", topics.get("l1_nodes", []))
        l1_edges = _load("l1_edges.json", [])
        judge_nodes = _load("l1_judge_nodes.json", [])
        judge_edges = _load("l1_judge_edges.json", [])
        hyperedges = _load("extractions.json", [])
        l2_nodes = _load("l2_nodes.json", [])
        l1_to_l2 = _load("l1_to_l2.json", {})

        # entity info across hyperedges (multi-description merge)
        entity_info: Dict[str, Dict[str, Any]] = {}
        for h in hyperedges:
            for ent in h.get("entities", []):
                name = ent.get("name")
                if not name:
                    continue
                info = entity_info.setdefault(name, {"descriptions": [],
                                                     "entity_type": ent.get("type")})
                desc = ent.get("description")
                if desc and desc not in info["descriptions"]:
                    info["descriptions"].append(desc)

        for name, parents in entity_to_parents.items():
            info = entity_info.get(name, {})
            descs = info.get("descriptions", [])
            self.add_entity(
                name=name,
                description="; ".join(descs) if descs else None,
                entity_type=info.get("entity_type"),
                l1_parents={str(p.get("topic_id")): p.get("prob") for p in parents})
        for name, info in entity_info.items():
            if name not in entity_to_parents:
                descs = info.get("descriptions", [])
                self.add_entity(name=name, description="; ".join(descs) if descs else None,
                                entity_type=info.get("entity_type"))

        for node in l1_nodes:
            self.add_summary(
                topic_id=int(node["topic_id"]), title=node.get("title"),
                summary_text=node.get("summary") or node.get("summary_text"),
                confidence=node.get("confidence"), top_words=node.get("top_words") or [],
                members=node.get("members") or [], centroid=node.get("centroid"))

        for name, parents in entity_to_parents.items():
            ent_id = self.name_to_entity_id.get(name)
            if not ent_id:
                continue
            for p in parents:
                sid = self.topic_to_summary_id.get(int(p["topic_id"]))
                if sid:
                    self.add_belongs_to(ent_id, sid, prob=p.get("prob"))

        for e in l1_edges:
            a = self.topic_to_summary_id.get(int(e["source"]))
            b = self.topic_to_summary_id.get(int(e["target"]))
            if a and b:
                self.add_related(a, b, weight=e.get("weight"), jaccard=e.get("jaccard"),
                                 cosine=e.get("cosine"), overlap=e.get("overlap"),
                                 confidence=e.get("confidence"))

        for i, h in enumerate(hyperedges):
            uid = h.get("id") or f"hedge_{i}_{h.get('relation_type', 'unknown')}"
            hid = self.add_hyperedge(uid=str(uid), description=h.get("hyperedge"),
                                     relation_type=h.get("relation_type"),
                                     confidence_score=h.get("confidence_score"))
            for ent in h.get("entities", []):
                eid = self.name_to_entity_id.get(ent.get("name"))
                if eid:
                    self.add_participation(eid, hid, role=ent.get("role"))

        # L2 communities numbered from 0 collide with L1 topic ids: remap them
        # past the L1 range so that no sum:<id> node merges across levels
        next_free = max(self.topic_to_summary_id, default=-1) + 1
        l2_remap: Dict[int, int] = {}
        for n in l2_nodes:
            tid = int(n["topic_id"])
            if tid in self.topic_to_summary_id:
                l2_remap[tid] = next_free
                next_free += 1
        for n in l2_nodes:
            tid = int(n["topic_id"])
            self.add_summary(topic_id=l2_remap.get(tid, tid), title=n.get("title"),
                             summary_text=n.get("summary"), confidence=n.get("confidence"),
                             top_words=n.get("top_words"), members=n.get("members"),
                             centroid=n.get("centroid"), level=2)
        for l1_tid, l2_tid in (l1_to_l2 or {}).items():
            a_t, b_t = int_or_none(l1_tid), int_or_none(l2_tid)
            if a_t is None or b_t is None:
                continue
            a = self.topic_to_summary_id.get(a_t)
            b = self.topic_to_summary_id.get(l2_remap.get(b_t, b_t))
            if a and b and a != b:
                self.add_belongs_to(a, b, prob=1.0)

        # escalated levels beyond L2
        level = 3
        while True:
            lvl_nodes = _load(f"l{level}_nodes.json", None)
            if not lvl_nodes:
                break
            lvl_map = _load(f"l{level - 1}_to_l{level}.json", {})
            for n in lvl_nodes:
                self.add_summary(topic_id=int(n["topic_id"]), title=n.get("title"),
                                 summary_text=n.get("summary"),
                                 confidence=n.get("confidence"),
                                 top_words=n.get("top_words"),
                                 members=n.get("members"),
                                 centroid=n.get("centroid"), level=level)
            for child_tid, parent_tid in (lvl_map or {}).items():
                a_t, b_t = int_or_none(child_tid), int_or_none(parent_tid)
                if a_t is None or b_t is None:
                    continue
                a = self.topic_to_summary_id.get(a_t)
                b = self.topic_to_summary_id.get(b_t)
                if a and b and a != b:
                    self.add_belongs_to(a, b, prob=1.0)
            level += 1

        for s in judge_nodes:
            nid = self.topic_to_summary_id.get(int(s.get("id", -1)))
            if nid:
                self.nodes[nid]["judge_scores"] = s
        self.judge_edges = judge_edges
        self._touch()

    # ----------------------------------------------------------- vector index
    def _embedding_text(self, node_id: str) -> str:
        """Per-type embedding text template."""
        d = self.nodes[node_id]
        nt = d.get("node_type")
        if nt == "entity":
            return f"Entity: {d.get('name') or ''}. {d.get('description') or ''}"
        if nt == "summary":
            tw = _as_obj(d.get("top_words")) or []
            return (f"Summary: {d.get('title') or ''}. "
                    f"{d.get('summary_text') or d.get('summary') or ''}. "
                    f"Keywords: {', '.join(str(x) for x in tw[:10])}")
        return f"Relation: {d.get('relation_type') or ''}. {d.get('description') or ''}"

    def _index_key(self, nid: str) -> str:
        d = self.nodes[nid]
        blob = "|".join([str(d.get("node_type")), str(d.get("name") or d.get("title") or ""),
                         str(d.get("summary_text") or ""), str(d.get("description") or "")])
        return hashlib.sha1(blob.encode("utf-8")).hexdigest()

    def _encoder(self):
        cfg = load_config()
        if self._encoder_name:
            return create_encoder(cfg, name=self._encoder_name, device=self.device)
        if self.vector_index.get("model"):
            # re-use the model recorded in the snapshot meta
            name = str(self.vector_index["model"])
            base = name.split("-b")[0] if name.startswith("hashed-ngram") else name
            return create_encoder(cfg, name="hashed" if "hashed" in base else base,
                                  device=self.device)
        return create_encoder(cfg, device=self.device)

    def query_basis(self) -> Optional[torch.Tensor]:
        """The projection of documents and queries on the graph's device: the
        LSA basis, else a projection given to ``load``, else None (the
        encoder's own Gaussian)."""
        if self._lsa is None:
            return self._projection
        if self._basis_dev is None:
            self._basis_dev = torch.from_numpy(self._lsa).to(self.device)
        return self._basis_dev

    def build_vector_index(self, layers: Sequence[int] = (0, 1),
                           include_hyperedges: bool = False,
                           upsert_only: bool = True, reset: bool = False,
                           use_idf: bool = True,
                           train_expansion: bool = True,
                           fit_lsa: bool = True) -> int:
        """(Re)encode node texts into the embedding table, incrementally by
        content hash. A full (re)build computes corpus IDF weights
        ln((1+N)/(1+df))+1 per hash bucket, used for documents and queries
        alike; ``train_expansion`` learns the query-side co-occurrence
        associations and ``fit_lsa`` the corpus-fitted projection.
        Incremental upserts reuse the stored weights."""
        enc = self._encoder()
        if reset:
            self.vector_index["indexed_meta"] = {}
            self._embeddings.clear()
            self._idf = None
            self._assoc = None
            self._lsa = None
            self._projection = None
        prev: Dict[str, str] = dict(self.vector_index.get("indexed_meta") or {})
        eligible_ids: List[str] = []
        for nid, d in self.nodes.items():
            nt = d.get("node_type")
            if ((nt == "entity" and 0 in layers) or
                    (nt == "summary" and (1 in layers or 2 in layers)) or
                    (nt == "hyperedge" and include_hyperedges)):
                eligible_ids.append(nid)

        full_build = use_idf and (self._idf is None or not upsert_only)
        if full_build and len(eligible_ids) >= 2:
            texts = [self._embedding_text(nid) for nid in eligible_ids]
            df = enc.document_frequencies(texts)
            n_docs = len(texts)
            self._idf = (np.log((1.0 + n_docs) / (1.0 + df)) + 1.0).astype(np.float32)
            if train_expansion:
                self._assoc = enc.train_associations(texts)
            if fit_lsa:
                self._lsa = enc.fit_projection(texts, idf=self._idf)
                self._basis_dev = None
            todo_ids, todo_texts = eligible_ids, texts
        else:
            todo_ids, todo_texts = [], []
            for nid in eligible_ids:
                key = self._index_key(nid)
                if upsert_only and prev.get(nid) == key and nid in self._embeddings:
                    continue
                todo_ids.append(nid)
                todo_texts.append(self._embedding_text(nid))
        if todo_ids:
            if use_idf:
                mat = enc.encode(todo_texts, idf=self._idf, basis=self.query_basis())
            else:
                mat = enc.encode(todo_texts, basis=self._projection)
            for nid, row in zip(todo_ids, mat):
                self._embeddings[nid] = np.asarray(row, dtype=np.float32)
                prev[nid] = self._index_key(nid)
        self.vector_index = {"model": enc.name, "indexed_nodes": len(prev),
                             "indexed_meta": prev}
        self.dirty = False
        self._tensors = None
        return len(todo_ids)

    # ---------------------------------------------------------- tensor compile
    def tensors(self) -> GraphTensors:
        """Compile (and cache) the device representation. Thread-safe: of
        concurrent first callers one compiles, the others wait for it."""
        gt = self._tensors
        if gt is not None:
            return gt
        with self._compile_lock:
            if self._tensors is None:
                self._compile_tensors()
            return self._tensors

    def _compile_tensors(self) -> GraphTensors:
        ids = list(self.nodes.keys())
        self._idx_to_id = ids
        self._id_to_idx = {nid: i for i, nid in enumerate(ids)}
        idx = self._id_to_idx
        n = len(ids)
        dim = self._encoder().dim
        emb = np.zeros((n, dim), dtype=np.float32)
        node_types, levels, judges, confs, indexed = [], [], [], [], []
        for i, nid in enumerate(ids):
            d = self.nodes[nid]
            node_types.append(NODE_TYPE_IDS.get(d.get("node_type"), 0))
            levels.append(self.node_layer(nid))
            judges.append(self.node_judge_overall(nid))
            confs.append(self.node_confidence(nid))
            row = self._embeddings.get(nid)
            indexed.append(row is not None)
            if row is not None:
                emb[i, : len(row)] = row

        def _conv(adj: Dict[str, List[str]]) -> Dict[int, List[int]]:
            return {idx[u]: [idx[v] for v in vs if v in idx]
                    for u, vs in adj.items() if u in idx}

        related = {}
        for nid in ids:
            row = [idx[v] for v in self.get_related(nid) if v in idx]
            if row:
                related[idx[nid]] = row

        self._tensors = build_graph_tensors(
            embeddings=emb, node_types=node_types, levels=levels, judges=judges,
            confs=confs, indexed=indexed,
            parents=_conv(self._parents), children=_conv(self._children),
            related=related, hyperedges=_conv(self._hedges_of),
            members=_conv(self._members_of), n_edges=self.n_edges_total,
            device=self.device)
        return self._tensors

    def idx_to_id(self, i: int) -> Optional[str]:
        if 0 <= i < len(self._idx_to_id):
            return self._idx_to_id[i]
        return None

    def id_to_idx(self, nid: str) -> int:
        self.tensors()
        return self._id_to_idx.get(nid, -1)

    def query_assoc(self):
        """Query-expansion associations to apply at encode time, or None.

        Expansion is gated to corpora larger than the encoder's dim: there the
        LSA basis is truncated and expansion helps; on smaller corpora the
        basis reproduces exact lexical ranking and expansion only drifts it.
        With no LSA basis expansion applies unconditionally."""
        if self._assoc is None or self._lsa is None:
            return self._assoc
        return self._assoc if len(self._embeddings) > self._encoder().dim else None

    def encode_query_device(self, texts: List[str]) -> torch.Tensor:
        enc = self._encoder()
        if self._idf is not None:
            return enc.encode_device(texts, idf=self._idf, assoc=self.query_assoc(),
                                     basis=self.query_basis())
        return enc.encode_device(texts, basis=self._projection)

    def encode_query(self, texts: List[str]) -> np.ndarray:
        """Encode queries in the index's embedding space (the stored corpus
        IDF, the query-expansion associations and the documents' projection),
        as numpy. Use this, not the raw encoder, for anything that scores
        against ``tensors().emb``."""
        return self.encode_query_device(texts).cpu().numpy()

    # ----------------------------------------------------------------- search
    def _resolve_weights(self, alpha=None, beta=None, gamma=None, delta=None,
                         judge_overall_min=None, confidence_min=None,
                         type_filter=None) -> SearchWeights:
        sp = self.search_params
        lb = sp.get("layer_boost", DEFAULT_SEARCH_PARAMS["layer_boost"])
        tf = type_filter if type_filter is not None else sp.get("type_filter")
        if isinstance(tf, (set, tuple)):
            tf = list(tf)
        return SearchWeights.create(
            alpha=sp.get("alpha", 0.6) if alpha is None else alpha,
            beta=sp.get("beta", 0.2) if beta is None else beta,
            gamma=sp.get("gamma", 0.1) if gamma is None else gamma,
            delta=sp.get("delta", 0.1) if delta is None else delta,
            layer_boost=(lb.get("entity", 0.0), lb.get("summary", 1.0),
                         lb.get("hyperedge", 0.0)),
            judge_min=sp.get("judge_overall_min") if judge_overall_min is None
            else judge_overall_min,
            conf_min=sp.get("confidence_min") if confidence_min is None else confidence_min,
            type_filter=tf, device=self.device)

    def _result_entry(self, i: int, score: float, sem: float) -> Dict[str, Any]:
        nid = self._idx_to_id[i]
        d = self.nodes[nid]
        nt = d.get("node_type")
        return {
            "node_id": nid,
            "node_type": nt,
            "layer": 0 if nt == "entity" else (1 if nt == "summary" else 0),
            "semantic": round(float(sem), 4),
            "judge_overall": self.node_judge_overall(nid),
            "confidence": self.node_confidence(nid),
            "score": round(float(score), 4),
            "name": d.get("name"),
            "title": d.get("title"),
        }

    def search(self, query: str, top_k: int = 5, member_top_m: Optional[int] = 5,
               alpha=None, beta=None, gamma=None, delta=None,
               judge_overall_min=None, confidence_min=None, type_filter=None,
               return_cluster: bool = False):
        """Hybrid search on the graph's device; the result dicts have the
        JAX package's shapes."""
        if self.dirty or not self._embeddings:
            self.build_vector_index(layers=(0, 1, 2))
        sp = self.search_params
        member_top_m = sp.get("member_top_m", 5) if member_top_m is None else member_top_m
        weights = self._resolve_weights(alpha, beta, gamma, delta,
                                        judge_overall_min, confidence_min, type_filter)
        gt = self.tensors()
        q = self.encode_query_device([query])[0].to(gt.device)
        res = hybrid_search(gt, q, weights, top_k=int(top_k), member_top_m=int(member_top_m))

        seed_idx, seed_sim, seed_ok = (res.seed_idx.tolist(), res.seed_sim.tolist(),
                                       res.seed_valid.tolist())
        seeds = [{"node_id": self._idx_to_id[i], "semantic": round(float(s), 6),
                  "meta": {"node_id": self._idx_to_id[i]}}
                 for i, s, ok in zip(seed_idx, seed_sim, seed_ok) if ok]
        reranked = [self._result_entry(int(i), float(s), float(m))
                    for i, s, m, ok in zip(res.reranked_idx.tolist(),
                                           res.reranked_score.tolist(),
                                           res.reranked_sem.tolist(),
                                           res.reranked_valid.tolist()) if ok]
        if return_cluster:
            # candidate priority order == the reference's dict insertion order
            expanded = [{"node_id": self._idx_to_id[int(i)],
                         "semantic": round(float(s), 6),
                         "node_type": self.nodes[self._idx_to_id[int(i)]].get("node_type")}
                        for i, s, ok in zip(res.cand_idx.tolist(), res.cand_sem.tolist(),
                                            res.cand_win.tolist()) if ok]
            return {"seeds": seeds, "expanded": expanded, "reranked": reranked}
        return reranked

    # number-of helpers used by observations
    def number_of_nodes(self) -> int:
        return len(self.nodes)

    def number_of_edges(self) -> int:
        return self.n_edges_total
