"""Benchmark harness: datasets -> systems -> unified evaluation -> report.

    python -m ahrag_tpu_torch.cli.benchmark --dataset local --data FILE.jsonl
        [--system ah_rag|naive|both] [--limit N] [--graph DIR] [--out FILE] [--device cpu]

The port's copy of ``ahrag_tpu/cli/benchmark.py``: every graph is built, loaded
and searched on ``device`` (``cuda`` unless told otherwise). HotpotQA and
TriviaQA come only from local JSONL files here: the JAX package fetches them
through the ``datasets`` wheel, which needs the network, and the port refuses
those names without ``--data``. ``rl.inference.use_knob_policy`` picks each
question's knobs with ``agent/knob_policy.py`` (the JAX package's flax file or
the port's own). Capability parity
with the reference's benchmark runner, with two deliberate upgrades over it:

- per-question knowledge graphs build **in-process** (no subprocess-per-question —
  SURVEY §7.3.7 calls the reference's subprocess boundary the dominant wall-clock
  cost);
- ``evaluation.max_concurrency`` is honored for real via a thread pool (the
  reference declares the key but never reads it, SURVEY §2.4).

Datasets: HotpotQA-distractor / TriviaQA-rc via HuggingFace ``datasets`` when the
cache/network allows, or any local JSONL with {"id", "question", "answers",
"context"} rows via ``--data`` (zero-egress environments).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.utils.config import load_config


def load_local_jsonl(path: str, limit: Optional[int] = None) -> List[Dict[str, Any]]:
    items = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            items.append({"id": str(obj.get("id", len(items))),
                          "question": obj.get("question", ""),
                          "answers": obj.get("answers") or [],
                          "context": obj.get("context"),
                          "gold_titles": obj.get("gold_titles") or [],
                          "qtype": obj.get("qtype")})
            if limit and len(items) >= limit:
                break
    return items


def load_dataset(name: str, limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """HotpotQA/TriviaQA by name: refused, since they come through the
    ``datasets`` wheel and the network; pass a local JSONL (``data_path``)."""
    if name.lower() in ("hotpotqa", "triviaqa"):
        raise RuntimeError(
            f"the {name!r} dataset is fetched through the 'datasets' package and the "
            "network, which ahrag_tpu_torch does not use: pass a local JSONL of "
            '{"id", "question", "answers", "context"} rows (--data / data_path)')
    raise ValueError(f"Unsupported dataset: {name}")


def context_to_corpus(context: Dict[str, Any]) -> str:
    """HotpotQA context {title: [...], sentences: [[...]]} -> one corpus string
    with '=== title ===' sections (run_benchmark.py:74-79 layout)."""
    parts = []
    for title, sentences in zip(context.get("title", []),
                                context.get("sentences", [])):
        parts.append(f"\n\n=== {title} ===\n" + " ".join(sentences))
    return "".join(parts).strip()


def build_question_graph(context: Dict[str, Any], workdir: str,
                         encoder_name: Optional[str] = None, device=None):
    """In-process per-question KG build (replaces the reference's subprocess
    per question) on ``device``. The corpus, artifacts and graph are written
    under ``workdir``, which the caller removes (a temporary directory)."""
    from ahrag_tpu_torch.cli.demo import run_pipeline

    corpus = os.path.join(workdir, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write(context_to_corpus(context))
    return run_pipeline(corpus, artifacts_dir=os.path.join(workdir, "artifacts"),
                        graph_dir=os.path.join(workdir, "graph"),
                        encoder_name=encoder_name, device=device)


def run_system(system: str, query: str, cfg: Dict[str, Any], hg) -> Dict[str, Any]:
    """Dispatch ah_rag (PPO if configured, else LLM/rule agent) vs naive, on
    the graph's device."""
    if system == "ah_rag":
        from ahrag_tpu_torch.agent.agent import AHRAG_Agent
        from ahrag_tpu_torch.agent.environment import GraphEnvironment
        from ahrag_tpu_torch.agent.inference import InferenceEngine
        env = GraphEnvironment(hg=hg, log_level="off")
        rl_cfg = (cfg.get("rl") or {}).get("inference", {})
        if rl_cfg.get("use_ppo") and os.path.exists(
                rl_cfg.get("ppo_model_path", "")):
            from ahrag_tpu_torch.agent.rl_agent import RLPolicyAgent
            agent = RLPolicyAgent(env, model_path=rl_cfg["ppo_model_path"],
                                  device=hg.device)
        else:
            agent = AHRAG_Agent(env, use_llm=bool(cfg.get("agent", {})
                                                  .get("use_llm", False)))
        engine = InferenceEngine(env, agent)
        knobs = None
        kp_path = rl_cfg.get("knob_policy_path", "")
        if rl_cfg.get("use_knob_policy") and os.path.exists(kp_path):
            # the trained policy picks this question's retrieval knob config
            # (agent/knob_policy.py), on the graph's device
            from ahrag_tpu_torch.agent.knob_policy import load_knob_policy
            knobs = load_knob_policy(kp_path, device=hg.device)(query)
        return engine.run_inference(
            query, steps=int(cfg.get("inference", {}).get("steps", 4)),
            knobs=knobs)
    if system == "naive":
        from ahrag_tpu_torch.answer.generator import AnswerGenerator
        from ahrag_tpu_torch.baselines.naive import NaiveRAG
        top_k = int(cfg.get("evaluation", {}).get("naive_rag_top_k", 5))
        return NaiveRAG(hg, AnswerGenerator(device=hg.device)).run(
            query, top_k=top_k, gen_cfg=cfg.get("answer", {}))
    raise ValueError(f"Unknown system: {system}")


def evaluate_item(item: Dict[str, Any], sys_name: str, ans: Dict[str, Any],
                  hg, cfg: Dict[str, Any], use_llm_judge: bool) -> Dict[str, Any]:
    from ahrag_tpu_torch.eval.answer_eval import AnswerEvaluator
    evaluator = AnswerEvaluator(system_type=sys_name)
    answer_obj = {
        "query": item["question"],
        "answer": ans.get("answer", ""),
        "rationale": ans.get("rationale", ""),
        "citations": ans.get("citations", []),
        "session_data": ans.get("session_data", {}),
        "gold_answers": item.get("answers") or [],
        "evidence": ans.get("evidence", {}),
        "context": ans.get("context", {}),
        "retrieved_nodes": ans.get("retrieved_nodes", []),
    }
    eval_cfg = dict(cfg)
    eval_cfg.setdefault("evaluation", {}).setdefault("judge", {})
    eval_cfg["evaluation"]["judge"] = {**eval_cfg["evaluation"]["judge"],
                                      "use_llm": use_llm_judge}
    unified = evaluator.evaluate(answer_obj, graph=hg, config=eval_cfg)
    scores = unified["scores"]
    diagnosis = unified["details"]["diagnosis"]
    from ahrag_tpu_torch.eval.retrieval import recall_at_k
    # gold-less items (v4 "unanswerable" family) have no retrieval target:
    # recall is undefined there, not zero — None rows are skipped by aggregate
    retrieval_recall = (recall_at_k(ans.get("retrieved_nodes", []),
                                    item.get("gold_titles") or [], hg, k=10)
                        if item.get("gold_titles") else None)
    return {
        "retrieval_recall_at_10": retrieval_recall,
        "id": item.get("id"), "system": sys_name, "qtype": item.get("qtype"),
        "f1": scores.get("f1", 0.0), "em": scores.get("em", 0.0),
        "judge_overall": scores.get("judge_overall", 0.0),
        "contextual_recall": scores.get("contextual_recall", 0.0),
        "contextual_relevancy": scores.get("contextual_relevancy", 0.0),
        "contextual_precision": scores.get("contextual_precision", 0.0),
        "faithfulness": scores.get("faithfulness", 0.0),
        "answer_relevancy": scores.get("answer_relevancy", 0.0),
        "answer_grounding": scores.get("answer_grounding", 1.0),
        "overall_score": scores.get("overall", 0.0),
        "primary_issue": diagnosis["primary_issue"],
        "diagnosis_reason": diagnosis["reason"],
        "diagnosis_confidence": diagnosis["confidence"],
    }


def aggregate(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    metrics = ["f1", "em", "judge_overall", "contextual_recall",
               "contextual_relevancy", "contextual_precision", "faithfulness",
               "answer_relevancy", "answer_grounding", "overall_score",
               "diagnosis_confidence", "retrieval_recall_at_10"]
    by_system: Dict[str, List[Dict[str, Any]]] = {}
    for r in results:
        by_system.setdefault(r["system"], []).append(r)
    agg = []
    for system, rows in sorted(by_system.items()):
        entry: Dict[str, Any] = {"system": system, "n": len(rows)}
        for m in metrics:
            vals = [r[m] for r in rows if r.get(m) is not None]
            entry[m] = sum(vals) / max(1, len(vals))
        issues: Dict[str, int] = {}
        for r in rows:
            issues[r["primary_issue"]] = issues.get(r["primary_issue"], 0) + 1
        entry["primary_issues"] = "/".join(
            f"{k}({v})" for k, v in sorted(issues.items(), key=lambda x: -x[1])[:2])
        agg.append(entry)
    return agg


def to_markdown(agg: List[Dict[str, Any]], dataset: str) -> str:
    headers = ["dataset", "system", "overall_score", "f1", "em",
               "contextual_recall", "faithfulness", "primary_issues"]
    lines = ["| " + " | ".join(headers) + " |", "|" + "---|" * len(headers)]
    for row in agg:
        lines.append(f"| {dataset} | {row['system']} | {row['overall_score']:.3f} | "
                     f"{row['f1']:.3f} | {row['em']:.3f} | "
                     f"{row['contextual_recall']:.3f} | {row['faithfulness']:.3f} | "
                     f"{row['primary_issues']} |")
    return "\n".join(lines)


def run_benchmark(dataset: str, system: str = "both", limit: int = 10,
                  data_path: Optional[str] = None, graph_dir: str = "graph",
                  judge_sample: Optional[float] = None,
                  out: Optional[str] = None,
                  config: Optional[Dict[str, Any]] = None, device=None,
                  item_ms: Optional[List[float]] = None) -> Dict[str, Any]:
    """Answer and score each item with each system on ``device``: items with
    a ``context`` over their own graph, the others over the graph saved in
    ``graph_dir``. ``item_ms``, when given, receives each item's milliseconds
    (its graph, its answers and their scores)."""
    import tempfile

    device = resolve_device(device)
    cfg = config or load_config()
    if data_path:
        data = load_local_jsonl(data_path, limit=limit)
    else:
        data = load_dataset(dataset, limit=limit)
    systems = ["ah_rag", "naive"] if system == "both" else [system]
    sample_ratio = judge_sample if judge_sample is not None else float(
        (cfg.get("evaluation", {}).get("judge", {}) or {}).get("sample_ratio", 0.2))
    rng = random.Random(int(cfg.get("evaluation", {}).get("seed", 42)))
    max_workers = max(1, int(cfg.get("evaluation", {}).get("max_concurrency", 2)))

    results: List[Dict[str, Any]] = []
    shared_hg = None
    import threading
    shared_lock = threading.Lock()

    def process(item: Dict[str, Any], use_llm_judge: bool) -> List[Dict[str, Any]]:
        nonlocal shared_hg
        t0 = time.perf_counter()
        if item.get("context"):
            with tempfile.TemporaryDirectory() as workdir:
                hg = build_question_graph(item["context"], workdir, device=device)
                rows = [evaluate_item(item, s, run_system(s, item["question"],
                                                          cfg, hg), hg, cfg,
                                      use_llm_judge) for s in systems]
        else:
            with shared_lock:
                if shared_hg is None:
                    from ahrag_tpu_torch.graph import HierarchicalGraph
                    shared_hg = HierarchicalGraph.load(graph_dir, device=device)
            hg = shared_hg
            rows = [evaluate_item(item, s, run_system(s, item["question"], cfg, hg),
                                  hg, cfg, use_llm_judge) for s in systems]
        if item_ms is not None:
            item_ms.append((time.perf_counter() - t0) * 1e3)
        return rows

    judge_flags = [rng.random() < sample_ratio for _ in data]
    if max_workers > 1 and len(data) > 1:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            for rows in pool.map(process, data, judge_flags):
                results.extend(rows)
    else:
        for item, flag in zip(data, judge_flags):
            results.extend(process(item, flag))

    agg = aggregate(results)
    report = {"items": results, "aggregate": agg, "dataset": dataset}
    if any(r.get("qtype") for r in results):
        # per-question-family breakdown (v2 synth: the no-name families are
        # the honest-retrieval axis — report them separately)
        by_qtype: Dict[str, Any] = {}
        for r in results:
            qt = r.get("qtype") or "unknown"
            by_qtype.setdefault(qt, []).append(r)
        report["by_qtype"] = {
            qt: {sys_n: {
                "n": len([x for x in rows if x["system"] == sys_n]),
                "f1": round(sum(x["f1"] for x in rows
                                if x["system"] == sys_n)
                            / max(1, len([x for x in rows
                                          if x["system"] == sys_n])), 2),
                "em": round(sum(x["em"] for x in rows if x["system"] == sys_n)
                            / max(1, len([x for x in rows
                                          if x["system"] == sys_n])), 2),
                "recall_at_10": round(
                    sum(x["retrieval_recall_at_10"] for x in rows
                        if x["system"] == sys_n
                        and x["retrieval_recall_at_10"] is not None)
                    / max(1, len([x for x in rows if x["system"] == sys_n
                                  and x["retrieval_recall_at_10"] is not None])),
                    3),
            } for sys_n in {x["system"] for x in rows}}
            for qt, rows in sorted(by_qtype.items())}
    print(to_markdown(agg, dataset))
    diag: Dict[str, Dict[str, int]] = {}
    for r in results:
        diag.setdefault(r["system"], {}).setdefault(r["primary_issue"], 0)
        diag[r["system"]][r["primary_issue"]] += 1
    print("\nDiagnosis summary:", json.dumps(diag))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w", encoding="utf-8") as f:
            json.dump(report, f, ensure_ascii=False, indent=2)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Run the standardized benchmark")
    ap.add_argument("--dataset", required=True, help="hotpotqa|triviaqa|local")
    ap.add_argument("--system", default="both", help="ah_rag|naive|both")
    ap.add_argument("--limit", type=int, default=10)
    ap.add_argument("--data", default=None, help="local JSONL dataset path")
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--corpus", default="graph",
                    help="graph | dataset (dataset uses "
                         "graph_datasets/<dataset>_distractor)")
    ap.add_argument("--judge-sample", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    graph_dir = (f"graph_datasets/{args.dataset}_distractor"
                 if args.corpus == "dataset" else args.graph)
    run_benchmark(args.dataset, system=args.system, limit=args.limit,
                  data_path=args.data, graph_dir=graph_dir,
                  judge_sample=args.judge_sample, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
