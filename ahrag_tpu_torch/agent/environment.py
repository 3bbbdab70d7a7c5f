"""GraphEnvironment — the agent-facing MDP over the hierarchical graph.

The port's copy of ``ahrag_tpu/agent/environment.py``, over the port's
``HierarchicalGraph``: state is a selection set + frontier set + dynamic
filters/weights + step counter; actions are ``reset`` / ``semantic_anchor`` /
``expand_to_lca`` / ``query_node_details`` / ``commit_selection`` /
``set_filters`` / ``set_search_weights`` / ``expand_children`` /
``expand_parents`` / ``expand_related`` / ``end_episode``. Every action logs to
the session's ``events.jsonl`` and accumulates ``stats.cumulative{steps,
queries,expansions,time_s}``; ``end_episode`` persists ``summary.json``.

The anchor's search (embed + seed + expand + rerank) runs on the graph's
device (``graph/search.py``, through the bin-max kernels on a large graph);
the local expansions here are list operations over the host adjacency. The
batched on-device episodes for RL live in ``agent/vec_env.py``.

Kept from the JAX package: ``expand_children``/``expand_parents`` check the
``limit`` only between input nodes; observations show at most 50 frontier
ids; ``set_search_weights(top_k=...)`` takes effect on later anchors.

Differences: ``GraphEnvironment(graph_dir=...)`` loads the graph onto
``device`` (``cuda`` unless the caller names another) and raises without a
card, before it writes any session file; a session file that cannot be
written raises, where the JAX package swallows the error.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Tuple

from ahrag_tpu_torch.graph import HierarchicalGraph
from ahrag_tpu_torch.utils.logging import get_logger


def _utcnow() -> str:
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


class GraphEnvironment:
    def __init__(self, graph_dir: str = "graph", hg: Optional[HierarchicalGraph] = None,
                 random_state: int = 42, logging_enabled: bool = True,
                 log_dir: str = "artifacts/sessions", session_id: Optional[str] = None,
                 debug: bool = False, log_level: str = "normal", redact: bool = True,
                 device=None) -> None:
        """``device`` is where a graph loaded from ``graph_dir`` lives (``cuda``
        unless named); a graph passed as ``hg`` keeps its own device."""
        self.graph_dir = graph_dir
        self.device = device
        self.random_state = random_state
        self.hg: Optional[HierarchicalGraph] = hg
        self.last_query: Optional[str] = None
        self.last_results: Optional[Dict[str, Any]] = None
        self.step_count = 0
        self.selection_set: set[str] = set()
        # commit order of selection_set (the set gives O(1) membership; the
        # list preserves the rank retrieval accounting needs — recall@k over
        # an alphabetical sort of content-hash ids is noise)
        self.selection_order: List[str] = []
        self.frontier_set: set[str] = set()
        self.current_filters: Dict[str, Any] = {
            "judge_overall_min": None, "confidence_min": None, "type_filter": None}
        self.current_weights: Dict[str, Any] = {
            "alpha": None, "beta": None, "gamma": None, "delta": None,
            "member_top_m": None, "top_k": 5}
        self.debug = debug
        self.logging_enabled = logging_enabled
        self.session_id = session_id or (
            datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%S") + "-" + uuid.uuid4().hex[:6])
        self.session_path = os.path.join(log_dir, self.session_id)
        self.stats: Dict[str, Any] = {
            "actions": [],
            "cumulative": {"steps": 0, "queries": 0, "expansions": 0, "time_s": 0.0},
        }
        self._ensure_graph_loaded()     # a graph that cannot load leaves no session behind
        self.logger = None
        if logging_enabled:
            self.logger = get_logger(self.session_path, self.session_id,
                                     level=log_level, redact=redact)
            os.makedirs(self.session_path, exist_ok=True)
            with open(os.path.join(self.session_path, "session.json"), "w",
                      encoding="utf-8") as f:
                json.dump({"session_id": self.session_id, "created_at": _utcnow()}, f)

    def _ensure_graph_loaded(self) -> None:
        if self.hg is None:
            self.hg = HierarchicalGraph.load(self.graph_dir, device=self.device)

    def _log(self, event: Dict[str, Any]) -> None:
        if self.logger is not None:
            self.logger.info(**{**event, "step": self.step_count})

    # ------------------------------------------------------------- observation
    def _node_brief(self, node_id: str) -> Dict[str, Any]:
        d = self.hg.nodes.get(node_id, {})
        return {
            "node_id": node_id,
            "node_type": d.get("node_type"),
            "entity_type": d.get("entity_type"),
            "layer": self.hg.node_layer(node_id),
            "title": d.get("title"),
            "name": d.get("name"),
            "judge_overall": self.hg.node_judge_overall(node_id),
            "confidence": self.hg.node_confidence(node_id),
        }

    def _observation(self, seeds: List[Dict[str, Any]],
                     reranked: List[Dict[str, Any]]) -> Dict[str, Any]:
        def brief(res: Dict[str, Any]) -> Dict[str, Any]:
            base = self._node_brief(res.get("node_id"))
            base.update({"score": res.get("score"), "semantic": res.get("semantic")})
            return base

        obs: Dict[str, Any] = {
            "selection": [brief(x) for x in reranked],
            "seeds": [brief(x) for x in seeds],
            "state": {
                "selection_ids": sorted(self.selection_set),
                "frontier_ids": sorted(self.frontier_set)[:50],
            },
            "counts": {"n_nodes": self.hg.number_of_nodes(),
                       "n_edges": self.hg.number_of_edges()},
            "step": self.step_count,
        }
        if self.debug:
            obs["diagnostics"] = {
                "filters": self.current_filters, "weights": self.current_weights,
                "last_query": self.last_query,
                "frontier_size": len(self.frontier_set),
                "selection_size": len(self.selection_set),
            }
        return obs

    # -------------------------------------------------------------- core API
    def reset(self, seed_query: Optional[str] = None,
              top_k: int = 5) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._ensure_graph_loaded()
        self.last_query = None
        self.last_results = None
        self.step_count = 0
        self.selection_set.clear()
        self.selection_order.clear()
        self.frontier_set.clear()
        if seed_query:
            return self.semantic_anchor(seed_query, top_k=top_k)
        obs = {"selection": [], "seeds": [],
               "counts": {"n_nodes": self.hg.number_of_nodes(),
                          "n_edges": self.hg.number_of_edges()},
               "step": self.step_count}
        self._log({"action": "reset", "message": "reset without seed_query"})
        return obs, {"message": "reset without seed_query"}

    def semantic_anchor(self, query: str, top_k: int = 5, member_top_m: int = 5,
                        judge_overall_min: Optional[float] = None,
                        confidence_min: Optional[float] = None,
                        type_filter: Optional[List[str]] = None
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._ensure_graph_loaded()
        self.step_count += 1
        self.last_query = query
        t0 = time.perf_counter()
        cluster = self.hg.search(
            query=query,
            top_k=self.current_weights.get("top_k") or top_k,
            member_top_m=(self.current_weights.get("member_top_m")
                          if member_top_m is None else member_top_m),
            judge_overall_min=(self.current_filters.get("judge_overall_min")
                               if judge_overall_min is None else judge_overall_min),
            confidence_min=(self.current_filters.get("confidence_min")
                            if confidence_min is None else confidence_min),
            type_filter=(self.current_filters.get("type_filter")
                         if type_filter is None else type_filter),
            alpha=self.current_weights.get("alpha"),
            beta=self.current_weights.get("beta"),
            gamma=self.current_weights.get("gamma"),
            delta=self.current_weights.get("delta"),
            return_cluster=True)
        dur = time.perf_counter() - t0
        seeds = cluster.get("seeds", [])
        reranked = cluster.get("reranked", [])
        self.frontier_set = {x["node_id"] for x in reranked if x.get("node_id")}
        obs = self._observation(seeds, reranked)
        info = {"action": "semantic_anchor", "query": query, "top_k": top_k,
                "returned": len(reranked), "time_s": round(dur, 4)}
        self.last_results = cluster
        self._log({**info, "filters": self.current_filters,
                   "weights": self.current_weights})
        self.stats["actions"].append(info)
        cum = self.stats["cumulative"]
        cum["steps"] += 1
        cum["queries"] += 1
        cum["time_s"] += dur
        return obs, info

    # ------------------------------------------------------------ LCA action
    def _ancestors(self, node_id: str) -> set[str]:
        seen = {node_id}
        stack = [node_id]
        while stack:
            n = stack.pop()
            for p in self.hg.get_belongs_to(n):
                if p not in seen:
                    seen.add(p)
                    stack.append(p)
        return seen

    def expand_to_lca(self, node_ids: List[str],
                      max_results: int = 5) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Lowest common ancestors over the belongs_to DAG (environment.py:243-299)."""
        self._ensure_graph_loaded()
        self.step_count += 1
        t0 = time.perf_counter()
        sets = [self._ancestors(nid) for nid in node_ids if nid in self.hg.nodes]
        inter = set.intersection(*sets) if sets else set()
        lcas = [n for n in inter
                if not (set(self.hg.get_belongs_to(n)) & inter)]
        lcas.sort(key=lambda x: (self.hg.nodes[x].get("level") or 1, x))
        lcas = lcas[:max_results]
        seeds = [{"node_id": nid, "semantic": 0.0} for nid in lcas]
        reranked = [{"node_id": nid, "score": 0.0, "semantic": 0.0} for nid in lcas]
        obs = self._observation(seeds, reranked)
        info = {"action": "expand_to_lca", "inputs": node_ids, "lca_count": len(lcas),
                "dag": self.hg.validate_belongs_to_dag(),
                "time_s": round(time.perf_counter() - t0, 4)}
        self._log(info)
        self.stats["actions"].append(info)
        self.stats["cumulative"]["steps"] += 1
        self.stats["cumulative"]["expansions"] += 1
        return obs, info

    def query_node_details(self, node_id: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._ensure_graph_loaded()
        self.step_count += 1
        if node_id not in self.hg.nodes:
            obs = {"selection": [], "seeds": [],
                   "counts": {"n_nodes": self.hg.number_of_nodes(),
                              "n_edges": self.hg.number_of_edges()},
                   "step": self.step_count}
            return obs, {"error": "node_not_found", "node_id": node_id}
        d = self.hg.nodes[node_id]
        details = {
            **self._node_brief(node_id),
            "title": d.get("title"),
            "name": d.get("name"),
            "summary_text": (d.get("summary_text") or d.get("summary") or "")[:500],
            "description": (d.get("description") or "")[:500],
            "top_words": d.get("top_words"),
            "members": d.get("members"),
        }
        obs = {"selection": [details], "seeds": [],
               "counts": {"n_nodes": self.hg.number_of_nodes(),
                          "n_edges": self.hg.number_of_edges()},
               "step": self.step_count}
        info = {"action": "query_node_details", "node_id": node_id}
        self._log(info)
        self.stats["actions"].append(info)
        self.stats["cumulative"]["steps"] += 1
        return obs, info

    # ----------------------------------------------------- state management
    def commit_selection(self, node_ids: List[str]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._ensure_graph_loaded()
        self.step_count += 1
        added = []
        for nid in node_ids:
            if nid in self.hg.nodes and nid not in self.selection_set:
                self.selection_set.add(nid)
                self.selection_order.append(nid)
                added.append(nid)
                self.frontier_set.discard(nid)
        obs = self._observation([], [{"node_id": n, "score": 0.0, "semantic": 0.0}
                                     for n in added])
        info = {"action": "commit_selection", "added": added,
                "total_selection": len(self.selection_set)}
        self._log(info)
        self.stats["actions"].append(info)
        self.stats["cumulative"]["steps"] += 1
        return obs, info

    def set_filters(self, judge_overall_min: Optional[float] = None,
                    confidence_min: Optional[float] = None,
                    type_filter: Optional[List[str]] = None) -> Dict[str, Any]:
        if judge_overall_min is not None:
            self.current_filters["judge_overall_min"] = judge_overall_min
        if confidence_min is not None:
            self.current_filters["confidence_min"] = confidence_min
        if type_filter is not None:
            self.current_filters["type_filter"] = list(type_filter)
        info = {"action": "set_filters", **self.current_filters}
        self._log(info)
        self.stats["actions"].append(info)
        return info

    def set_search_weights(self, alpha: Optional[float] = None, beta: Optional[float] = None,
                           gamma: Optional[float] = None, delta: Optional[float] = None,
                           member_top_m: Optional[int] = None,
                           top_k: Optional[int] = None) -> Dict[str, Any]:
        for key, val in (("alpha", alpha), ("beta", beta), ("gamma", gamma),
                         ("delta", delta), ("member_top_m", member_top_m),
                         ("top_k", top_k)):
            if val is not None:
                self.current_weights[key] = val
        info = {"action": "set_search_weights", **self.current_weights}
        self._log(info)
        self.stats["actions"].append(info)
        return info

    # ----------------------------------------------------------- expansions
    def _expansion_result(self, action: str, node_ids: List[str],
                          expanded: List[str], limit: int
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        expanded = list(dict.fromkeys(expanded))[:limit]
        seeds = [{"node_id": n, "semantic": 0.0} for n in expanded]
        obs = self._observation(seeds, [{"node_id": n, "score": 0.0, "semantic": 0.0}
                                        for n in expanded])
        info = {"action": action, "inputs": node_ids, "returned": len(expanded)}
        self.frontier_set.update(expanded)
        self._log(info)
        self.stats["actions"].append(info)
        self.stats["cumulative"]["steps"] += 1
        self.stats["cumulative"]["expansions"] += 1
        return obs, info

    def expand_children(self, node_ids: List[str],
                        limit: int = 10) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._ensure_graph_loaded()
        self.step_count += 1
        expanded: List[str] = []
        for nid in node_ids:
            if nid not in self.hg.nodes:
                continue
            expanded.extend(self.hg.get_summary_members(nid))
            if len(expanded) >= limit:
                break
        return self._expansion_result("expand_children", node_ids, expanded, limit)

    def expand_parents(self, node_ids: List[str],
                       limit: int = 10) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        self._ensure_graph_loaded()
        self.step_count += 1
        expanded: List[str] = []
        for nid in node_ids:
            if nid not in self.hg.nodes:
                continue
            expanded.extend(self.hg.get_belongs_to(nid))
            if len(expanded) >= limit:
                break
        return self._expansion_result("expand_parents", node_ids, expanded, limit)

    def expand_related(self, node_ids: List[str],
                       limit: int = 10) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """related_to neighbors both directions; entities additionally pull their
        hyperedges and co-participants (environment.py:440-480)."""
        self._ensure_graph_loaded()
        self.step_count += 1
        expanded: List[str] = []
        for nid in node_ids:
            if nid not in self.hg.nodes:
                continue
            expanded.extend(self.hg.get_related(nid))
            if self.hg.nodes[nid].get("node_type") == "entity":
                for hedge in self.hg.get_entity_hyperedges(nid):
                    expanded.append(hedge)
                    for other in self.hg.get_hyperedge_participants(hedge):
                        if other != nid:
                            expanded.append(other)
            if len(expanded) >= limit:
                break
        return self._expansion_result("expand_related", node_ids, expanded, limit)

    # --------------------------------------------------------------- closing
    def set_debug(self, enabled: bool = True) -> Dict[str, Any]:
        self.debug = enabled
        info = {"action": "set_debug", "debug": self.debug}
        self._log(info)
        self.stats["actions"].append(info)
        return info

    def end_episode(self) -> Dict[str, Any]:
        summary = {
            "session_id": self.session_id,
            "created_at": _utcnow(),
            "selection_size": len(self.selection_set),
            "frontier_size": len(self.frontier_set),
            "stats": self.stats,
            "filters": self.current_filters,
            "weights": self.current_weights,
            "last_query": self.last_query,
        }
        if self.logging_enabled:
            os.makedirs(self.session_path, exist_ok=True)
            with open(os.path.join(self.session_path, "summary.json"), "w",
                      encoding="utf-8") as f:
                json.dump(summary, f, ensure_ascii=False, indent=2)
        self._log({"action": "end_episode"})
        return summary
