"""Hierarchy quality at scale against a known topic structure.

    python -m ahrag_tpu_torch.cli.cluster_eval [--n 10000] [--topics 48]
        [--super 0] [--super-frac 0.3] [--noise 0.05] [--seed 3]
        [--encoder hashed] [--out FILE] [--device cpu]

The port's copy of ``ahrag_tpu/cli/cluster_eval.py``: builds the L0 -> L1
-> L2 hierarchy over a synthetic corpus with ground-truth topics
(``eval/clustering.py``) through the port's ``SemanticAggregator`` on
``--device`` (``cuda`` unless told otherwise), and scores L1's purity, NMI
and noise detection, L2's escalation metrics and, with ``--super``, the
recovery of the super-topics. ``embed_s``, ``cluster_s`` and ``l2_s`` are
host-clock seconds of each stage.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict


def run(n: int, n_topics: int, noise_frac: float, seed: int,
        encoder_name: str = "hashed", n_super: int = 0,
        super_frac: float = 0.3, device=None) -> Dict[str, Any]:
    from ahrag_tpu_torch.aggregate.aggregator import SemanticAggregator
    from ahrag_tpu_torch.eval.clustering import (labeled_extractions,
                                                 make_labeled_entities, nmi, noise_prf,
                                                 predicted_labels, purity)

    entities, labels = make_labeled_entities(n, n_topics, seed=seed,
                                             noise_frac=noise_frac,
                                             n_super=n_super, super_frac=super_frac)
    extractions = labeled_extractions(entities)

    out: Dict[str, Any] = {"n_entities": n, "n_true_topics": n_topics,
                           "n_true_super": n_super, "super_frac": super_frac,
                           "noise_frac": noise_frac, "seed": seed,
                           "encoder": encoder_name}
    with tempfile.TemporaryDirectory() as tmp:
        agg = SemanticAggregator(encoder_name=encoder_name, artifact_dir=tmp,
                                 device=device)
        t0 = time.perf_counter()
        agg.embed_l0_entities(extractions)
        out["embed_s"] = round(time.perf_counter() - t0, 2)

        t0 = time.perf_counter()
        res = agg.cluster_entities()
        out["cluster_s"] = round(time.perf_counter() - t0, 2)

        pred = predicted_labels(res["l1_nodes"], entities)
        true = list(labels)
        out["l1"] = {"n_pred_topics": len(res["l1_nodes"]),
                     "n_outliers": res.get("n_outliers", 0),
                     "purity": round(purity(pred, true), 4),
                     "nmi": round(nmi(pred, true), 4),
                     "noise": {k: round(v, 4) for k, v in noise_prf(pred, true).items()}}

        # L2 build + escalation metrics at the build pipeline's thresholds
        # (cli/demo.py), not the stricter library defaults
        t0 = time.perf_counter()
        agg.summarize_topics(res["l1_nodes"])
        edges = agg.generate_l1_relations(res["l1_nodes"], min_overlap=1,
                                          min_jaccard=0.05, min_cosine=0.3)
        l2 = agg.aggregate_level2_via_communities(res["l1_nodes"], min_comm_size=2)
        metrics = agg.compute_escalation_metrics(res["l1_nodes"], l2)
        out["l2_s"] = round(time.perf_counter() - t0, 2)
        out["l2"] = {"n_l1_edges": len(edges), "n_l2_nodes": len(l2),
                     "escalation": metrics}

        # super-topic recovery: entity -> predicted L1 topic -> L2 community,
        # scored against the generator's ground-truth super label (label % S)
        if n_super > 0:
            with open(os.path.join(tmp, "l1_to_l2.json"), encoding="utf-8") as fh:
                l1_to_l2 = json.loads(fh.read() or "{}")
            sup_pred = [-1 if (p == -1 or str(p) not in l1_to_l2)
                        else int(l1_to_l2[str(p)]) for p in pred]
            sup_true = [-1 if t == -1 else t % n_super for t in true]
            scored = [(sp, st) for sp, st in zip(sup_pred, sup_true) if st != -1]
            out["super"] = {
                "purity": round(purity([s for s, _ in scored], [t for _, t in scored]), 4),
                "nmi": round(nmi([s for s, _ in scored], [t for _, t in scored]), 4),
                "frac_mapped": round(
                    sum(1 for s, _ in scored if s != -1) / max(len(scored), 1), 4),
            }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Hierarchy quality against known topics")
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--topics", type=int, default=48)
    ap.add_argument("--super", type=int, default=0, dest="n_super")
    ap.add_argument("--super-frac", type=float, default=0.3, dest="super_frac")
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--encoder", default="hashed")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.n, args.topics, args.noise, args.seed, args.encoder,
              n_super=args.n_super, super_frac=args.super_frac, device=args.device)
    print(json.dumps(res, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(res, fh, indent=2)


if __name__ == "__main__":
    main()
