"""RLPolicyAgent: a trained PPO policy as an InferenceEngine-compatible agent.

Port of ``ahrag_tpu/agent/rl_agent.py``: featurize the observation, sample
a masked discrete action, translate it to an environment verb with the
gym's top-id picks (table-driven). It needs only the port's
``PPOLearner`` checkpoint and featurizer, no environment module.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ahrag_tpu_torch.agent.featurizer import featurize_observation
from ahrag_tpu_torch.agent.ppo import PPOLearner, act_ppo

# action id -> (environment verb, how many top nodes it consumes)
_VERB_TABLE = {
    0: ("expand_parents", 2),
    1: ("expand_children", 2),
    2: ("expand_related", 1),
    3: ("commit_selection", 3),
    4: ("query_node_details", 1),
}


class RLPolicyAgent:
    def __init__(self, env: Any, model_path: str, seed: int = 0, device=None) -> None:
        self.env_like = env
        self.learner = PPOLearner.load(model_path, device=device)
        self._seed = seed

    def decide(self, observation: Dict[str, Any]) -> Dict[str, Any]:
        vec, _ = featurize_observation(observation)
        selection = observation.get("selection") or []
        mask = np.ones(self.learner.n_actions, dtype=np.float32)
        if not selection:
            mask[:-1] = 0.0  # end-only when the observation has no top nodes
        self._seed += 1
        action = act_ppo(self.learner, vec, mask=mask, seed=self._seed)
        verb, k = _VERB_TABLE.get(int(action), ("end_episode", 0))
        if verb == "end_episode":
            return {"action": verb, "params": {}}
        top_ids = [n["node_id"] for n in selection[:k] if n.get("node_id")]
        return {"action": verb, "params": {"node_ids": top_ids}}
