"""Retrieval metrics: recall@k / hit-rate over retrieved node sets.

The port's copy of ``ahrag_tpu/eval/retrieval.py`` (pure Python).

BASELINE.md's headline metric is "recall@k ... on HotpotQA distractor". HotpotQA
gold evidence comes as supporting-fact *titles*; graph nodes carry entity names and
summary titles — so recall here is title/name matching between gold strings and the
retrieved nodes (substring containment either way, case-insensitive), the standard
evaluation for KG-node retrieval against passage-level gold.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Sequence


def _matches(gold: str, node_text: str) -> bool:
    g = gold.strip().lower()
    t = node_text.strip().lower()
    return bool(g) and bool(t) and (g in t or t in g)


def node_texts(hg: Any, node_id: str) -> List[str]:
    d = hg.nodes.get(node_id, {}) if hasattr(hg, "nodes") else {}
    return [x for x in (d.get("name"), d.get("title")) if x]


def recall_at_k(retrieved_ids: Sequence[str], gold_titles: Iterable[str], hg: Any,
                k: int | None = None) -> float:
    """Fraction of gold titles covered by the top-k retrieved nodes."""
    golds = [g for g in gold_titles if g]
    if not golds:
        return 0.0
    ids = list(retrieved_ids)[: k or len(retrieved_ids)]
    texts = [t for nid in ids for t in node_texts(hg, nid)]
    hit = sum(1 for g in golds if any(_matches(g, t) for t in texts))
    return hit / len(golds)


def hit_rate_at_k(retrieved_ids: Sequence[str], gold_titles: Iterable[str], hg: Any,
                  k: int | None = None) -> float:
    """1.0 if any gold title is covered by the top-k retrieved nodes."""
    return 1.0 if recall_at_k(retrieved_ids, gold_titles, hg, k) > 0 else 0.0
