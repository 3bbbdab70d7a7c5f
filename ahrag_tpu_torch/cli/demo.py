"""Build-pipeline entry point: ingest a document, build the hierarchy, search.

    python -m ahrag_tpu_torch.cli.demo PATH [--artifacts DIR] [--graph DIR] [--no-repl]
                                       [--device cpu]

Port of ``ahrag_tpu/cli/demo.py``: 5 phases: extract -> aggregate (embed,
cluster, summaries, relations with the looser demo thresholds overlap>=1/jac>=.05/
cos>=.3, L2 communities) -> unified graph build -> vector index (layers {0,1,2},
reset) -> interactive search REPL. The embeddings, k-means, the index and the
searches run on ``device`` (``cuda`` unless told otherwise); the artifacts and
the saved graph are the same files on the card and on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

from ahrag_tpu_torch.aggregate.aggregator import SemanticAggregator
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.extract.chunking import smart_chunks
from ahrag_tpu_torch.extract.extractor import HypergraphExtractor
from ahrag_tpu_torch.graph import HierarchicalGraph


def run_pipeline(input_path: str, artifacts_dir: str = "artifacts",
                 graph_dir: str = "graph",
                 encoder_name: Optional[str] = None,
                 judge: bool = False, device=None,
                 timings: Optional[Dict[str, float]] = None) -> Optional[HierarchicalGraph]:
    """Build, index and save the graph of the document at ``input_path``.
    ``timings``, when given, receives each stage's seconds: ``extract_s``,
    ``aggregate_s`` (``kmeans_s`` of it), ``graph_s``, ``index_s``, ``save_s``."""
    device = resolve_device(device)      # refuse before anything is written
    clock = {} if timings is None else timings
    t0 = time.perf_counter()
    with open(input_path, "r", encoding="utf-8") as f:
        document = f.read()

    print("[1/5] Extracting L0 hyperedges...")
    extractor = HypergraphExtractor()
    all_extractions = []
    for i, chunk in enumerate(smart_chunks(document)):
        ex = extractor.extract(chunk)
        if ex:
            all_extractions.extend(ex)
        else:
            print(f"  [warn] chunk {i} produced no extractions; skipped")
    if not all_extractions:
        print("[fatal] no valid extractions produced; aborting.")
        return None
    os.makedirs(artifacts_dir, exist_ok=True)
    out = []
    for i, e in enumerate(all_extractions):
        d = e.model_dump()
        d["id"] = f"h{i}"
        out.append(d)
    with open(os.path.join(artifacts_dir, "extractions.json"), "w",
              encoding="utf-8") as f:
        json.dump(out, f, ensure_ascii=False, indent=2)
    t1 = time.perf_counter()
    clock["extract_s"] = t1 - t0

    print("[2/5] Aggregating to L1 (embeddings, topics, summaries, relations)...")
    agg = SemanticAggregator(encoder_name=encoder_name, artifact_dir=artifacts_dir,
                             device=device)
    agg.embed_l0_entities(all_extractions)
    clust = agg.cluster_entities()
    agg.summarize_topics(clust["l1_nodes"])
    edges = agg.generate_l1_relations(clust["l1_nodes"], min_overlap=1,
                                      min_jaccard=0.05, min_cosine=0.3)
    print("[2.5/5] Aggregating to L2 via communities...")
    l2 = agg.aggregate_level2_via_communities(clust["l1_nodes"])
    if judge:
        agg.judge_samples(clust["l1_nodes"], edges)
        agg.judge_level_nodes(l2)
    agg.compute_escalation_metrics(clust["l1_nodes"], l2)
    t2 = time.perf_counter()
    clock["aggregate_s"], clock["kmeans_s"] = t2 - t1, agg.kmeans_s

    print("[3/5] Building unified graph...")
    hg = HierarchicalGraph(encoder_name=encoder_name, device=device)
    hg.build_from_artifacts(artifacts_dir)
    t3 = time.perf_counter()
    clock["graph_s"] = t3 - t2
    print("[4/5] Building vector index...")
    hg.build_vector_index(layers=(0, 1, 2), reset=True)
    t4 = time.perf_counter()
    clock["index_s"] = t4 - t3
    hg.save(graph_dir, meta={"source": os.path.abspath(input_path)})
    clock["save_s"] = time.perf_counter() - t4
    print("[5/5] Ready.", json.dumps(hg.stats()))
    return hg


def interactive_search(hg: HierarchicalGraph) -> None:
    """Read queries from standard input until an empty line or its end."""
    print("Enter your queries (empty line to exit):")
    while True:
        print("query> ", end="", flush=True)
        line = sys.stdin.readline()
        if not line:
            print()
            break
        q = line.strip()
        if not q:
            break
        print(json.dumps(hg.search(q, top_k=5), ensure_ascii=False, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Ingest a document and run hybrid search")
    ap.add_argument("path", help="Path to a UTF-8 text file")
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--encoder", default=None, help="hashed (the only ported encoder)")
    ap.add_argument("--judge", action="store_true", help="run LLM judge sampling")
    ap.add_argument("--no-repl", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    hg = run_pipeline(args.path, artifacts_dir=args.artifacts, graph_dir=args.graph,
                      encoder_name=args.encoder, judge=args.judge, device=args.device)
    if hg is None:
        raise SystemExit(1)
    if not args.no_repl:
        interactive_search(hg)


if __name__ == "__main__":
    main()
