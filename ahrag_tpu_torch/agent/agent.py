"""Heuristic/LLM action policy and the single-shot agent driver.

The port's copy of ``ahrag_tpu/agent/agent.py``: an LLM JSON decision over
the 7-verb action set with two attempts and regex JSON extraction, falling
back to the rule policy (expand_parents of the top selection ->
expand_related of the frontier head -> end_episode). The LLM is asked through
``chat_or_none``: a failed call or a reply that does not parse moves on to the
next attempt, as the JAX package's caught exception does.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional, Tuple

from ahrag_tpu_torch.agent.environment import GraphEnvironment
from ahrag_tpu_torch.utils.llm import LLMModule, get_llm_manager
from ahrag_tpu_torch.utils.parse import json_or_none

VERBS = ("semantic_anchor", "expand_parents", "expand_children", "expand_related",
         "commit_selection", "query_node_details", "end_episode")
_JSON_RE = re.compile(r"\{[\s\S]*\}")


class AHRAG_Agent:
    def __init__(self, env: GraphEnvironment, use_llm: bool = False) -> None:
        self.env = env
        self.use_llm = use_llm and get_llm_manager().is_enabled(LLMModule.AGENT_DECISION)

    def decide(self, observation: Dict[str, Any]) -> Dict[str, Any]:
        if self.use_llm:
            obj = self._llm_decide(observation)
            if obj is not None:
                return obj
        return self._rule_based(observation)

    # ----------------------------------------------------------------- rules
    def _rule_based(self, observation: Dict[str, Any]) -> Dict[str, Any]:
        selection = observation.get("selection") or []
        frontier_ids = (observation.get("state") or {}).get("frontier_ids") or []
        if selection and selection[0].get("node_id"):
            return {"action": "expand_parents",
                    "params": {"node_ids": [selection[0]["node_id"]]}}
        if frontier_ids:
            return {"action": "expand_related", "params": {"node_ids": frontier_ids[:1]}}
        return {"action": "end_episode", "params": {}}

    # ------------------------------------------------------------------- llm
    def _build_prompt(self, observation: Dict[str, Any],
                      include_thought: bool = False) -> str:
        trimmed = [{
            "node_id": s.get("node_id"), "node_type": s.get("node_type"),
            "layer": s.get("layer"), "title": (s.get("title") or "")[:120],
            "name": (s.get("name") or "")[:120], "score": s.get("score"),
        } for s in (observation.get("selection") or [])[:3]]
        state = observation.get("state") or {}
        brief = json.dumps({
            "selection": trimmed,
            "frontier_size": len(state.get("frontier_ids") or []),
            "selection_size": len(state.get("selection_ids") or []),
            "step": observation.get("step"),
        }, ensure_ascii=False, indent=2)
        schema = {"action": "|".join(VERBS),
                  "params": {"node_ids": ["id"], "query": "..."}}
        if include_thought:
            schema["thought"] = "one short sentence of motivation"
        guidance = (
            "Action guide: expand_parents rolls up to shared abstractions (preferred "
            "first); expand_related explores laterally; expand_children drills into "
            "members; semantic_anchor re-anchors from a new angle; commit_selection "
            "locks in key nodes; query_node_details fetches detail; end_episode stops "
            "when expansions yield no gain.")
        return ("You are a retrieval-strategy assistant. Choose the next action for "
                "the current observation and return EXACTLY one strict JSON object, "
                "nothing else.\n"
                f"{guidance}\nObservation (trimmed):\n{brief}\n\n"
                f"JSON schema:\n{json.dumps(schema, ensure_ascii=False, indent=2)}")

    def _sanitize(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        params = obj.get("params")
        return {"action": str(obj.get("action", "noop")),
                "params": params if isinstance(params, dict) else {}}

    def _llm_decide(self, observation: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        mgr = get_llm_manager()
        # attempt 1: full prompt; attempt 2: tighter prompt, no thought
        for include_thought, max_tokens in ((bool(self.env.debug), 200), (False, 160)):
            text = mgr.chat_or_none(LLMModule.AGENT_DECISION,
                                    [{"role": "user",
                                      "content": self._build_prompt(observation,
                                                                    include_thought)}],
                                    max_tokens=max_tokens)
            m = _JSON_RE.search(text or "")
            obj = json_or_none(m.group(0)) if m else None
            if isinstance(obj, dict):
                return self._sanitize(obj)
        return None


def run_agent_once(env: GraphEnvironment, agent: AHRAG_Agent, seed_query: str,
                   steps: int = 3) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Single-episode driver mapping decisions to env verbs (agent.py:150-178)."""
    obs, _ = env.reset(seed_query=seed_query)
    for _ in range(steps):
        decision = agent.decide(obs)
        action = decision.get("action")
        params = decision.get("params", {})
        node_ids = params.get("node_ids", [])
        if action == "semantic_anchor":
            obs, _ = env.semantic_anchor(params.get("query") or seed_query)
        elif action == "expand_parents":
            obs, _ = env.expand_parents(node_ids)
        elif action == "expand_children":
            obs, _ = env.expand_children(node_ids)
        elif action == "expand_related":
            obs, _ = env.expand_related(node_ids)
        elif action == "commit_selection":
            obs, _ = env.commit_selection(node_ids)
        elif action == "query_node_details":
            if node_ids:
                obs, _ = env.query_node_details(node_ids[0])
        else:
            break
    summary = env.end_episode()
    return obs, summary
