"""NaiveRAG baseline: flat vector top-k + direct generation.

The port's copy of ``ahrag_tpu/baselines/naive.py``: the graph's hybrid
search (on the graph's device) as a flat top-k, ``[nid] title ::
summary[:200]`` lines as the context, and the shared ``AnswerGenerator``.
"""
from __future__ import annotations

from typing import Any, Dict, List


class NaiveRAG:
    def __init__(self, hg: Any, answer_generator: Any) -> None:
        self.hg = hg
        self.answer_generator = answer_generator

    def run(self, query: str, top_k: int = 5,
            gen_cfg: Dict[str, Any] | None = None) -> Dict[str, Any]:
        res = self.hg.search(query, top_k=top_k, return_cluster=False)
        ids: List[str] = [x["node_id"] for x in (res or []) if x.get("node_id")]
        skeleton = []
        for nid in ids:
            d = self.hg.nodes.get(nid, {})
            title = d.get("title") or d.get("name") or ""
            summary = (d.get("summary_text") or d.get("summary")
                       or d.get("description") or "")
            skeleton.append(f"- [{nid}] {title} :: {summary[:200]}")
        context = {"context_text": "\n".join(skeleton), "used_nodes": ids, "stats": {}}
        out = self.answer_generator.generate(query, context, gen_cfg or {})
        out["retrieved_nodes"] = ids
        out["context"] = context
        return out
