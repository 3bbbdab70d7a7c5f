"""Roll a policy through episodes and score retriever metrics on the
selection set: PPO checkpoint > BC checkpoint > action-prob JSON > random,
with action-mask repair; generation is skipped.

    python -m ahrag_tpu_torch.cli.eval_rl_policy --data FILE.jsonl [--limit 5]
        [--graph DIR] [--ppo-model FILE | --bc-model FILE | --policy FILE.json]
        [--out FILE] [--max-steps 6] [--seed 0] [--device cpu]

The port's copy of ``ahrag_tpu/cli/eval_rl_policy.py``; the graph and the
models are loaded onto ``--device`` (``cuda`` unless told otherwise). The
action-prob and random routes draw from ``random.Random(seed)``, which does
not depend on the device; the PPO and BC routes sample from a
``torch.Generator`` per step, whose stream does.
"""
from __future__ import annotations

import argparse
import json
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from ahrag_tpu_torch.agent.gym import AHRAGGymEnv
from ahrag_tpu_torch.cli.benchmark import load_dataset, load_local_jsonl
from ahrag_tpu_torch.eval.answer_eval import AnswerEvaluator


def sample_action(probs: Dict[int, float], n_actions: int, rng: random.Random) -> int:
    if not probs:
        return rng.randrange(n_actions)
    keys, ps = zip(*sorted(probs.items()))
    total = sum(ps)
    if total <= 0:
        return rng.randrange(n_actions)
    r = rng.random()
    acc = 0.0
    for k, p in zip(keys, ps):
        acc += p / total
        if r <= acc:
            return int(k)
    return int(keys[-1])


def evaluate_episodes(env: AHRAGGymEnv, items: List[Dict[str, Any]], ppo=None,
                      bc_apply=None, probs: Optional[Dict[int, float]] = None,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """One episode per item through ``env`` under the PPO learner, else the
    BC policy, else the action probabilities (uniform when empty); a masked
    choice is repaired to the first valid action. Returns ``{"id",
    "scores"}`` per item: the evaluator's scores of the final selection."""
    from ahrag_tpu_torch.agent.bc import act_bc
    from ahrag_tpu_torch.agent.ppo import act_ppo

    rng = random.Random(seed)
    evaluator = AnswerEvaluator(system_type="ah_rag")
    results: List[Dict[str, Any]] = []
    step_seed = seed
    for item in items:
        vec, _ = env.reset(item["question"])
        done = False
        while not done:
            mask = env.get_action_mask()
            step_seed += 1
            if ppo is not None:
                a = act_ppo(ppo, vec, mask=np.asarray(mask, np.float32), seed=step_seed)
            elif bc_apply is not None:
                a = act_bc(bc_apply, vec, seed=step_seed)
            else:
                a = sample_action(probs or {}, env.action_size, rng)
            if mask[a] == 0:
                valid = [i for i, v in enumerate(mask) if v == 1]
                a = valid[0] if valid else env.action_size - 1
            vec, _r, done, _info = env.step(a)

        answer_obj = {
            "query": item["question"], "answer": "",
            "gold_answers": item.get("answers", []),
            "evidence": {}, "context": {},
            "retrieved_nodes": sorted(env.env.selection_set),
            "session_data": {"stats": env.env.stats},
        }
        unified = evaluator.evaluate(answer_obj, graph=env.env.hg, config={})
        results.append({"id": item.get("id"), "scores": unified["scores"]})
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Evaluate an RL traversal policy")
    ap.add_argument("--dataset", default="hotpotqa")
    ap.add_argument("--data", default=None)
    ap.add_argument("--limit", type=int, default=5)
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--policy", default="artifacts/rl/policy.json")
    ap.add_argument("--bc-model", default=None)
    ap.add_argument("--ppo-model", default=None)
    ap.add_argument("--out", default="artifacts/rl/eval.json")
    ap.add_argument("--max-steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    items = (load_local_jsonl(args.data, limit=args.limit) if args.data
             else load_dataset(args.dataset, limit=args.limit))
    env = AHRAGGymEnv(graph_dir=args.graph, max_steps=args.max_steps, device=args.device)

    ppo = bc_apply = None
    probs: Dict[int, float] = {}
    if args.ppo_model and os.path.exists(args.ppo_model):
        from ahrag_tpu_torch.agent.ppo import PPOLearner
        ppo = PPOLearner.load(args.ppo_model, device=args.device)
    elif args.bc_model and os.path.exists(args.bc_model):
        from ahrag_tpu_torch.agent.bc import load_bc
        bc_apply, _ = load_bc(args.bc_model, device=args.device)
    elif os.path.exists(args.policy):
        with open(args.policy, "r", encoding="utf-8") as f:
            probs = {int(k): float(v)
                     for k, v in (json.load(f).get("action_probs") or {}).items()}

    results = evaluate_episodes(env, items, ppo=ppo, bc_apply=bc_apply, probs=probs,
                                seed=args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump({"items": results}, f, ensure_ascii=False, indent=2)
    print(f"Saved eval to {args.out}")


if __name__ == "__main__":
    main()
