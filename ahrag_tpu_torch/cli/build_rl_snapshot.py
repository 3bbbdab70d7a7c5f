"""Frozen RL training snapshot builder: sample N questions, aggregate their
contexts into one corpus with '=== title ===' sections, run the in-process
build pipeline, and write the graph to a versioned directory for frozen RL
training.

    python -m ahrag_tpu_torch.cli.build_rl_snapshot --data FILE.jsonl [--limit 10]
        [--out-graph DIR] [--artifacts DIR] [--device cpu]

The port's copy of ``ahrag_tpu/cli/build_rl_snapshot.py``; the graph is built
on ``--device`` (``cuda`` unless told otherwise). The corpus file lives in a
temporary directory, removed with it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from ahrag_tpu_torch.cli.benchmark import context_to_corpus, load_dataset, load_local_jsonl
from ahrag_tpu_torch.cli.demo import run_pipeline


def build_corpus(items) -> str:
    parts = []
    for it in items:
        if it.get("context"):
            parts.append(context_to_corpus(it["context"]))
    return "\n\n".join(p for p in parts if p)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Build a frozen RL training snapshot")
    ap.add_argument("--dataset", default="hotpotqa")
    ap.add_argument("--data", default=None)
    ap.add_argument("--limit", type=int, default=10)
    ap.add_argument("--out-graph", default="graph_rl")
    ap.add_argument("--artifacts", default="artifacts_rl")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    items = (load_local_jsonl(args.data, limit=args.limit) if args.data
             else load_dataset(args.dataset, limit=args.limit))
    corpus = build_corpus(items)
    if not corpus:
        raise SystemExit("No contexts available to build a corpus from")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(corpus)
        if os.path.exists(args.out_graph):
            shutil.rmtree(args.out_graph)
        hg = run_pipeline(path, artifacts_dir=args.artifacts, graph_dir=args.out_graph,
                          device=args.device)
    if hg is None:
        raise SystemExit(1)
    print(f"Frozen snapshot written to {args.out_graph} "
          f"(artifacts in {args.artifacts})")


if __name__ == "__main__":
    main()
