"""Agent CLI: run one rule/LLM agent episode over a saved graph.

    python -m ahrag_tpu_torch.cli.agent QUERY [--graph DIR] [--steps 3] [--device cpu]

Port of ``ahrag_tpu/cli/agent.py``; the graph is loaded onto ``--device``
(``cuda`` unless told otherwise).
"""
from __future__ import annotations

import argparse
import json

from ahrag_tpu_torch.agent.agent import AHRAG_Agent, run_agent_once
from ahrag_tpu_torch.agent.environment import GraphEnvironment


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Run the rule/LLM agent once")
    ap.add_argument("query")
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--llm", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    env = GraphEnvironment(graph_dir=args.graph, device=args.device)
    agent = AHRAG_Agent(env, use_llm=args.llm)
    obs, summary = run_agent_once(env, agent, args.query, steps=args.steps)
    print(json.dumps(summary, ensure_ascii=False, indent=2, default=str))


if __name__ == "__main__":
    main()
