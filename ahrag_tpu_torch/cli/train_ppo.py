"""PPO training CLI: the host gym loop, batched on-device rollouts
(``--device``) or a fleet of per-question graphs (``--multi``).

    python -m ahrag_tpu_torch.cli.train_ppo --data FILE.jsonl [--graph DIR]
        [--episodes 10] [--envs 4] [--epochs 2] [--max-steps 6] [--out FILE]
        [--device [--updates 10] [--batch 16]] [--multi [--graphs 32]]
        [--curve-out FILE] [--torch-device cpu]

The port's copy of ``ahrag_tpu/cli/train_ppo.py``: ``ppo_train`` over
``AHRAGGymEnv``s, ``ppo_train_device`` over ``vec_env`` or
``build_question_fleet`` + ``ppo_train_multi``, every graph and the learner
on ``--torch-device`` (``cuda`` unless told otherwise). ``--device`` keeps
the JAX package's meaning (the batched route). The host route loads the
graph once and gives it to every gym, where the JAX package loads it once
per gym; each gym keeps its own episode state either way. The policy file is
the port's own (``torch.save``).
"""
from __future__ import annotations

import argparse

from ahrag_tpu_torch.agent.gym import AHRAGGymEnv
from ahrag_tpu_torch.agent.ppo import PPOConfig, ppo_train, ppo_train_device
from ahrag_tpu_torch.cli.benchmark import load_dataset, load_local_jsonl


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train the PPO traversal policy")
    ap.add_argument("--dataset", default="hotpotqa")
    ap.add_argument("--data", default=None, help="local JSONL dataset path")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=6)
    ap.add_argument("--envs", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--out", default="artifacts/rl/ppo_policy.msgpack")
    ap.add_argument("--device", action="store_true",
                    help="batched on-device rollouts (vec_env) instead of host gym")
    ap.add_argument("--multi", action="store_true",
                    help="multi-graph fleet: one per-question KG per item, batched "
                         "(graph, query) rollouts, terminal retrieval-recall "
                         "reward from gold_titles")
    ap.add_argument("--graphs", type=int, default=32, help="multi-mode fleet size")
    ap.add_argument("--final-reward-weight", type=float, default=4.0)
    ap.add_argument("--updates", type=int, default=10, help="device-mode updates")
    ap.add_argument("--batch", type=int, default=16, help="device-mode batch size")
    ap.add_argument("--curve-out", default=None,
                    help="device-mode: write the per-update learning curve JSON")
    ap.add_argument("--torch-device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    limit = args.graphs if args.multi else args.episodes * args.envs
    items = (load_local_jsonl(args.data, limit=limit)
             if args.data else load_dataset(args.dataset, limit=limit))
    questions = [i["question"] for i in items]
    cfg = PPOConfig(epochs=args.epochs)
    dev = args.torch_device
    if args.multi:
        from ahrag_tpu_torch.agent.fleet import build_question_fleet
        from ahrag_tpu_torch.agent.ppo import ppo_train_multi
        from ahrag_tpu_torch.graph.search import SearchWeights
        bgts, q_embs, gold_masks, _metas = build_question_fleet(items, device=dev)
        ppo_train_multi(bgts, q_embs, SearchWeights.create(device=dev),
                        gold_masks=gold_masks, n_updates=args.updates,
                        max_steps=args.max_steps, ppo_cfg=cfg, save_path=args.out,
                        final_reward_weight=args.final_reward_weight,
                        curve_out=args.curve_out)
    elif args.device:
        from ahrag_tpu_torch.graph import HierarchicalGraph
        from ahrag_tpu_torch.graph.search import SearchWeights
        hg = HierarchicalGraph.load(args.graph, device=dev)
        ppo_train_device(hg.tensors(), hg.encode_query_device(questions),
                         SearchWeights.create(device=dev), n_updates=args.updates,
                         max_steps=args.max_steps, batch_size=args.batch,
                         ppo_cfg=cfg, save_path=args.out, curve_out=args.curve_out)
    else:
        from ahrag_tpu_torch.graph import HierarchicalGraph
        hg = HierarchicalGraph.load(args.graph, device=dev)
        ppo_train(lambda: AHRAGGymEnv(hg=hg, max_steps=args.max_steps),
                  questions, total_episodes=args.episodes, max_steps=args.max_steps,
                  ppo_cfg=cfg, save_path=args.out, n_envs=args.envs, device=dev)


if __name__ == "__main__":
    main()
