"""Random-policy trajectory collection: roll the gym with random actions and
write JSONL trajectories for behaviour cloning.

    python -m ahrag_tpu_torch.cli.collect_trajectories --data FILE.jsonl
        [--limit N] [--graph DIR] [--out FILE] [--max-steps 6] [--seed 0]
        [--device] [--torch-device cpu]

The port's copy of ``ahrag_tpu/cli/collect_trajectories.py``. The graph is
loaded onto ``--torch-device`` (``cuda`` unless told otherwise). The gym
route draws its actions from ``random.Random(seed)``, which does not depend
on the device. ``--device`` keeps the JAX package's meaning: every episode
at once through ``vec_env.rollout_batch`` with a zero-logit policy, sampled
from a ``torch.Generator`` seeded by ``--seed`` (its stream depends on the
device, and is not JAX's).
"""
from __future__ import annotations

import argparse
import json
import os
import random
from typing import Any, Dict, List

import torch

from ahrag_tpu_torch.agent.gym import AHRAGGymEnv
from ahrag_tpu_torch.cli.benchmark import load_dataset, load_local_jsonl


def collect_gym(env: AHRAGGymEnv, items: List[Dict[str, Any]], out: str,
                seed: int) -> None:
    """One random-action episode per item through ``env``, written to ``out``."""
    rng = random.Random(seed)
    with open(out, "w", encoding="utf-8") as f:
        for it in items:
            vec, _info = env.reset(it["question"])
            traj: Dict[str, Any] = {"query": it["question"], "steps": []}
            done = False
            while not done:
                a = rng.randrange(env.action_size)
                nvec, r, done, step_info = env.step(a)
                traj["steps"].append({"action": a, "reward": r,
                                      "obs_vec": [float(v) for v in vec],
                                      "obs_aux": step_info.get("aux", {})})
                vec = nvec
            f.write(json.dumps(traj, ensure_ascii=False) + "\n")


def collect_device(items: List[Dict[str, Any]], hg, out: str, max_steps: int,
                   seed: int) -> None:
    """Every item's episode in one batched rollout on ``hg``'s device, with a
    zero-logit (uniform over the valid actions) policy."""
    from ahrag_tpu_torch.agent.vec_env import N_ACTIONS, rollout_batch
    from ahrag_tpu_torch.graph.search import SearchWeights

    dev = hg.device
    gt = hg.tensors()
    questions = [it["question"] for it in items]
    q_embs = hg.encode_query_device(questions)

    def random_policy(obs: torch.Tensor):
        return (torch.zeros(obs.shape[0], N_ACTIONS, device=obs.device),
                torch.zeros(obs.shape[0], device=obs.device))

    gen = torch.Generator(device=dev).manual_seed(seed)
    traj, _ = rollout_batch(gt, q_embs, random_policy, SearchWeights.create(device=dev),
                            max_steps=max_steps, generator=gen)
    obs, actions = traj.obs.cpu().numpy(), traj.actions.cpu().numpy()
    rewards, live = traj.rewards.cpu().numpy(), traj.mask.cpu().numpy()
    with open(out, "w", encoding="utf-8") as f:
        for b, q in enumerate(questions):
            steps = [{"action": int(actions[b, t]), "reward": float(rewards[b, t]),
                      "obs_vec": [float(v) for v in obs[b, t]], "obs_aux": {}}
                     for t in range(obs.shape[1]) if live[b, t]]
            f.write(json.dumps({"query": q, "steps": steps}, ensure_ascii=False) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Collect random trajectories")
    ap.add_argument("--dataset", default="hotpotqa")
    ap.add_argument("--data", default=None, help="local JSONL dataset path")
    ap.add_argument("--limit", type=int, default=10)
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--out", default="artifacts/rl/trajectories.jsonl")
    ap.add_argument("--max-steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", action="store_true",
                    help="batched on-device collection (vec_env)")
    ap.add_argument("--torch-device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    items = (load_local_jsonl(args.data, limit=args.limit) if args.data
             else load_dataset(args.dataset, limit=args.limit))
    if args.device:
        from ahrag_tpu_torch.graph import HierarchicalGraph
        hg = HierarchicalGraph.load(args.graph, device=args.torch_device)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        collect_device(items, hg, args.out, args.max_steps, args.seed)
    else:
        env = AHRAGGymEnv(graph_dir=args.graph, max_steps=args.max_steps,
                          device=args.torch_device)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        collect_gym(env, items, args.out, args.seed)
    print(f"Saved trajectories to {args.out}")


if __name__ == "__main__":
    main()
