"""Environment CLI: a seed query plus ``--filters judge>=x conf>=y type=a,b``,
``--weights alpha=0.7 top_k=5``, ``--expand children|parents|related``,
``--select ids``, ``--debug``, ``--end``.

    python -m ahrag_tpu_torch.cli.env QUERY [--graph DIR] [--device cpu] ...

Port of ``ahrag_tpu/cli/env.py``; the graph is loaded onto ``--device``
(``cuda`` unless told otherwise)."""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

from ahrag_tpu_torch.agent.environment import GraphEnvironment


def parse_filters(tokens: List[str]) -> Dict:
    out: Dict = {}
    for tok in tokens or []:
        if tok.startswith("judge>="):
            out["judge_overall_min"] = float(tok.split(">=", 1)[1])
        elif tok.startswith("conf>="):
            out["confidence_min"] = float(tok.split(">=", 1)[1])
        elif tok.startswith("type="):
            out["type_filter"] = tok.split("=", 1)[1].split(",")
    return out


def parse_weights(tokens: List[str]) -> Dict:
    out: Dict = {}
    for tok in tokens or []:
        if "=" in tok:
            key, val = tok.split("=", 1)
            if key in {"alpha", "beta", "gamma", "delta"}:
                out[key] = float(val)
            elif key in {"member_top_m", "top_k"}:
                out[key] = int(val)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Drive the graph environment")
    ap.add_argument("query")
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--filters", nargs="*", default=[])
    ap.add_argument("--weights", nargs="*", default=[])
    ap.add_argument("--expand", choices=["children", "parents", "related"])
    ap.add_argument("--select", nargs="*", default=[])
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--end", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    env = GraphEnvironment(graph_dir=args.graph, debug=args.debug, device=args.device)
    filters = parse_filters(args.filters)
    if filters:
        env.set_filters(**filters)
    weights = parse_weights(args.weights)
    if weights:
        env.set_search_weights(**weights)

    obs, info = env.reset(seed_query=args.query)
    print(json.dumps({"info": info, "selection": obs.get("selection")},
                     ensure_ascii=False, indent=2))
    if args.select:
        _, info = env.commit_selection(args.select)
        print(json.dumps(info, ensure_ascii=False))
    if args.expand:
        ids = [n["node_id"] for n in (obs.get("selection") or [])[:2]]
        fn = {"children": env.expand_children, "parents": env.expand_parents,
              "related": env.expand_related}[args.expand]
        obs, info = fn(ids)
        print(json.dumps({"info": info,
                          "expanded": [n["node_id"] for n in obs["selection"]]},
                         ensure_ascii=False, indent=2))
    if args.end:
        print(json.dumps(env.end_episode(), ensure_ascii=False, indent=2))


if __name__ == "__main__":
    main()
