"""Gym-like discrete-action wrapper over the port's ``GraphEnvironment``.

The port's copy of ``ahrag_tpu/agent/gym.py``: a 6-action discrete space
(0 expand_parents(top2), 1 expand_children(top2), 2 expand_related(top1),
3 commit_top(top3), 4 query_details_top(1), 5 end_episode), with
``expand_to_lca(top2)`` as action 6 when ``include_lca_action`` is set; a
binary action mask (end-only when the observation has no selection); a
repeat-action penalty; and a cap of ``max_steps`` steps per episode.

Every ``reset`` anchors with one ``HierarchicalGraph.search`` on the graph's
device (through ``dense_binmax`` on a graph with n_pad >= 4,096); the steps
are list operations over the host adjacency.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ahrag_tpu_torch.agent.environment import GraphEnvironment
from ahrag_tpu_torch.agent.featurizer import featurize_observation
from ahrag_tpu_torch.agent.reward import step_reward

N_ACTIONS = 6
ACTION_NAMES = ("expand_parents", "expand_children", "expand_related",
                "commit_top", "query_details_top", "end_episode", "expand_to_lca")


class AHRAGGymEnv:
    """``include_lca_action=True`` exposes ``expand_to_lca`` as action 6; off
    by default to keep the 6-action contract. ``device`` is where a graph
    loaded from ``graph_dir`` lives (``cuda`` unless named); a graph passed
    as ``hg`` keeps its own."""

    def __init__(self, graph_dir: str = "graph", hg=None, max_steps: int = 6,
                 debug: bool = False, enable_action_mask: bool = True,
                 repeat_penalty: float = 0.02, include_lca_action: bool = False,
                 device=None) -> None:
        self.env = GraphEnvironment(graph_dir=graph_dir, hg=hg, debug=debug,
                                    log_level="off", redact=True, device=device)
        self.max_steps = max(1, int(max_steps))
        self._cur_step = 0
        self._last_raw_obs: Optional[Dict[str, Any]] = None
        self._query: Optional[str] = None
        self.enable_action_mask = bool(enable_action_mask)
        self.repeat_penalty = float(repeat_penalty)
        self._last_action: Optional[int] = None
        self.include_lca_action = bool(include_lca_action)

    @property
    def action_size(self) -> int:
        return N_ACTIONS + (1 if self.include_lca_action else 0)

    def reset(self, query: str) -> Tuple[Any, Dict[str, Any]]:
        self._query = query
        self._cur_step = 0
        raw_obs, _ = self.env.reset(seed_query=query)
        vec, aux = featurize_observation(raw_obs)
        self._last_raw_obs = raw_obs
        info: Dict[str, Any] = {"raw_obs": raw_obs, "aux": aux}
        if self.enable_action_mask:
            info["action_mask"] = self.get_action_mask()
        self._last_action = None
        return vec, info

    def get_action_mask(self) -> List[int]:
        """1 = valid. When the current observation has no selection, only
        end_episode (id 5) is allowed."""
        raw = self._last_raw_obs or {}
        n = self.action_size
        if not (raw.get("selection") or []):
            mask = [0] * n
            mask[5] = 1
            return mask
        return [1] * n

    def _pick_top_ids(self, raw_obs: Dict[str, Any], k: int = 2) -> List[str]:
        return [n["node_id"] for n in (raw_obs.get("selection") or [])[:k]
                if n.get("node_id")]

    def step(self, action: int) -> Tuple[Any, float, bool, Dict[str, Any]]:
        if self._last_raw_obs is None:
            raise RuntimeError("call reset() before step()")
        self._cur_step += 1
        prev_raw = self._last_raw_obs
        done = False
        info: Dict[str, Any] = {"action": int(action)}

        if action == 0:
            obs, _ = self.env.expand_parents(self._pick_top_ids(prev_raw, 2))
        elif action == 1:
            obs, _ = self.env.expand_children(self._pick_top_ids(prev_raw, 2))
        elif action == 2:
            obs, _ = self.env.expand_related(self._pick_top_ids(prev_raw, 1))
        elif action == 3:
            obs, _ = self.env.commit_selection(self._pick_top_ids(prev_raw, 3))
        elif action == 4:
            ids = self._pick_top_ids(prev_raw, 1)
            obs = self.env.query_node_details(ids[0])[0] if ids else prev_raw
        elif action == 6 and self.include_lca_action:
            obs, _ = self.env.expand_to_lca(self._pick_top_ids(prev_raw, 2))
        else:
            done = True
            obs = prev_raw

        r = 0.0 if done else step_reward(prev_raw, obs)
        if (not done and self._last_action is not None
                and int(action) == self._last_action and self.repeat_penalty > 0):
            r -= self.repeat_penalty
        done = done or (self._cur_step >= self.max_steps)

        vec, aux = featurize_observation(obs)
        self._last_raw_obs = obs
        if self.enable_action_mask:
            info["action_mask"] = self.get_action_mask()
        self._last_action = int(action)
        info.update({"raw_obs": obs, "aux": aux, "step": self._cur_step})
        return vec, float(r), bool(done), info
