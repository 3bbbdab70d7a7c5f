"""Standalone context-build + answer CLI: takes an evidence JSON and a query,
builds the budgeted context against the graph and generates the answer.

    python -m ahrag_tpu_torch.cli.answer QUERY --evidence FILE [--graph DIR] [--device cpu]

Port of ``ahrag_tpu/cli/answer.py``; the graph is loaded onto ``--device``
(``cuda`` unless told otherwise).
"""
from __future__ import annotations

import argparse
import json

from ahrag_tpu_torch.answer.context import ContextProcessor
from ahrag_tpu_torch.answer.generator import AnswerGenerator
from ahrag_tpu_torch.graph import HierarchicalGraph
from ahrag_tpu_torch.utils.config import load_config


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Build context and answer from evidence")
    ap.add_argument("query")
    ap.add_argument("--evidence", required=True, help="Evidence JSON path "
                    '({"summaries": [...], "entities": [...]})')
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--llm", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_config()
    answer_cfg = cfg.get("answer", {})
    with open(args.evidence, "r", encoding="utf-8") as f:
        evidence = json.load(f)
    hg = HierarchicalGraph.load(args.graph, device=args.device)
    budget = args.budget or int(answer_cfg.get("total_context_budget", 6000))
    context = ContextProcessor().build_context(evidence, hg, budget, {
        "skeleton_ratio": answer_cfg.get("skeleton_ratio", 0.2),
        "reserve_ratio": answer_cfg.get("reserve_ratio", 0.1),
        "enable_kept_spans": answer_cfg.get("enable_kept_spans", True),
        "summarizer_max_tokens": answer_cfg.get("summarizer_max_tokens", 256),
    })
    answer = AnswerGenerator(device=hg.device).generate(args.query, context, {
        "use_llm": args.llm or answer_cfg.get("use_llm", False),
        "temperature": answer_cfg.get("temperature", 0.1),
        "max_retries": answer_cfg.get("max_retries", 2),
    })
    print(json.dumps({"answer": answer, "context_stats": context["stats"]},
                     ensure_ascii=False, indent=2))


if __name__ == "__main__":
    main()
