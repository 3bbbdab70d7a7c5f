"""RL-transfer evaluation: a trained PPO policy against the rule agent on
held-out data.

    python -m ahrag_tpu_torch.cli.rl_transfer --data FILE.jsonl [--model FILE]
        [--limit 100] [--qtypes no_name|A,B] [--graph DIR] [--strip-context]
        [--out FILE] [--device cpu]

The port's copy of ``ahrag_tpu/cli/rl_transfer.py``: the standard benchmark
runs twice on the held-out split, once with the rule agent and once with the
PPO policy driving the same ``InferenceEngine`` (``run_system``), on
``--device`` (``cuda`` unless told otherwise); it reports both and the
deltas. ``--qtypes no_name`` keeps ``eval.synth.NO_NAME_FAMILIES``;
``--strip-context`` drops the items' contexts so every question runs over
the shared ``--graph``. The filtered items go to a temporary directory,
removed afterwards. The PPO policy samples from a ``torch.Generator``, so its
run depends on the device.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
from typing import Any, Dict, Optional, Set


KEYS = ("f1", "em", "retrieval_recall_at_10", "contextual_recall", "overall_score")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="PPO policy against the rule agent")
    ap.add_argument("--data", required=True)
    ap.add_argument("--model", default="artifacts/rl/ppo_multi.msgpack")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--qtypes", default=None,
                    help="comma-separated question families to keep; 'no_name' "
                         "expands to eval.synth.NO_NAME_FAMILIES")
    ap.add_argument("--graph", default="graph",
                    help="shared graph dir (used with --strip-context)")
    ap.add_argument("--strip-context", action="store_true",
                    help="drop per-item contexts so every question runs against "
                         "the shared --graph corpus")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ahrag_tpu_torch.cli.benchmark import run_benchmark
    from ahrag_tpu_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        data_path = args.data
        if args.qtypes or args.strip_context:
            if args.qtypes and args.qtypes.strip() == "no_name":
                from ahrag_tpu_torch.eval.synth import NO_NAME_FAMILIES
                keep: Optional[Set[str]] = set(NO_NAME_FAMILIES)
            elif args.qtypes:
                keep = {q.strip() for q in args.qtypes.split(",") if q.strip()}
            else:
                keep = None
            rows = []
            with open(args.data, encoding="utf-8") as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    obj = json.loads(line)
                    if keep is not None and obj.get("qtype") not in keep:
                        continue
                    if args.strip_context:
                        obj.pop("context", None)
                    rows.append(json.dumps(obj, ensure_ascii=False) + "\n")
            data_path = os.path.join(tmp, "items.jsonl")
            with open(data_path, "w", encoding="utf-8") as fh:
                fh.writelines(rows)
            print(f"filtered {args.data} to {len(rows)} items "
                  f"(qtypes={sorted(keep) if keep else 'all'}, "
                  f"strip_context={args.strip_context})")

        base = load_config()
        runs: Dict[str, Any] = {}
        for label, use_ppo in (("rule", False), ("ppo", True)):
            cfg = copy.deepcopy(base)
            cfg.setdefault("rl", {}).setdefault("inference", {})
            cfg["rl"]["inference"]["use_ppo"] = use_ppo
            cfg["rl"]["inference"]["ppo_model_path"] = args.model
            rep = run_benchmark("local", system="ah_rag", limit=args.limit,
                                data_path=data_path, graph_dir=args.graph, config=cfg,
                                device=args.device)
            runs[label] = rep["aggregate"][0]

    delta = {k: round(runs["ppo"][k] - runs["rule"][k], 4) for k in KEYS}
    out = {"model": args.model, "data": args.data, "n": runs["rule"]["n"],
           "rule": runs["rule"], "ppo": runs["ppo"], "ppo_minus_rule": delta}
    print(json.dumps({"rule": {k: round(runs["rule"][k], 3) for k in KEYS},
                      "ppo": {k: round(runs["ppo"][k], 3) for k in KEYS},
                      "delta": delta}, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()
