"""CI-style quality gate: run the benchmark in-process and assert aggregate
F1 >= f1-min and faithfulness >= faith-min; exit 1 on failure.

    python -m ahrag_tpu_torch.cli.eval_gate --data FILE.jsonl [--limit N]
        [--f1-min F] [--faith-min F] [--device cpu]

The port's copy of ``ahrag_tpu/cli/eval_gate.py``; the benchmark runs on
``--device`` (``cuda`` unless told otherwise)."""
from __future__ import annotations

import argparse
import json
import sys

from typing import Any, Dict

from ahrag_tpu_torch.cli.benchmark import run_benchmark


def verdict(report: Dict[str, Any], f1_min: float, faith_min: float) -> Dict[str, Any]:
    """The gate over a ``run_benchmark`` report: its first system's aggregate
    F1 and faithfulness against the bars."""
    agg = (report.get("aggregate") or [{}])[0]
    f1 = float(agg.get("f1", 0.0))
    faith = float(agg.get("faithfulness", 0.0))
    return {"f1": f1, "faithfulness": faith,
            "passed": (f1 >= f1_min) and (faith >= faith_min)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Evaluation quality gate")
    ap.add_argument("--dataset", default="hotpotqa")
    ap.add_argument("--limit", type=int, default=5)
    ap.add_argument("--data", default=None)
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--out", default="reports/rl_gate.json")
    ap.add_argument("--f1-min", type=float, default=0.55)
    ap.add_argument("--faith-min", type=float, default=0.6)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    report = run_benchmark(args.dataset, system="ah_rag", limit=args.limit,
                           data_path=args.data, graph_dir=args.graph,
                           judge_sample=0.5, out=args.out, device=args.device)
    out = verdict(report, args.f1_min, args.faith_min)
    print(json.dumps(out, indent=2))
    if not out["passed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
