"""Diagnostic RAG evaluation: retriever x generator framework.

The port's copy of ``ahrag_tpu/eval/answer_eval.py``. The LLM judge asks
through ``chat_or_none`` and parses through ``utils/parse.py``; the efficiency
read-back checks that ``summary.json`` exists instead of catching the error.

Behavior parity with the reference evaluator (eval/answer_eval.py:15-519):

- retriever metrics: contextual_relevancy (keyword overlap of evidence vs question,
  x1.1 boost cap 1.0), contextual_recall (used_nodes/evidence x1.2 cap 1.0, else
  citations/retrieved), contextual_precision;
- generator metrics: faithfulness / answer_relevancy from the LLM judge when one
  is live (correctness/coverage ÷ 10), otherwise from the DETERMINISTIC judge
  (eval/judge.py — evidence grounding, citation validity, contradiction and
  answer-type checks), so the diagnosis formula carries signal without any LLM.
  The reference's no-judge constants (0.5/0.5/0.65, answer_eval.py:331-361) stay
  behind ``evaluation.judge.mode == "parity"``;
- quantitative F1/EM: first-party SQuAD-style token-level F1/EM on the 0-100 scale
  (the reference delegates to the `evaluate` wheel; this implements the same metric
  directly — token F1, best over gold references);
- qualitative LLM judge (1-10 correctness/coverage/clarity/overall), zeros when off;
- the diagnosis formula with hi 0.7 / lo 0.5 thresholds and recall-first override;
- overall score weights: recall .3, faithfulness .25, ctx relevancy .2,
  answer relevancy .15, precision .1;
- system-specific metrics (ah_rag layer utilization / steps / coverage, naive
  latency) and efficiency read-back from session ``summary.json``.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from collections import Counter
from typing import Any, Dict, List

from ahrag_tpu_torch.utils.llm import LLMModule, get_llm_manager
from ahrag_tpu_torch.utils.parse import float_or_none, json_or_none


def normalize_text(s: str) -> str:
    if not s:
        return ""
    s = s.lower().strip()
    s = re.sub(r"\s+", " ", s)
    s = "".join(ch for ch in s if not unicodedata.category(ch).startswith("P"))
    # drop english articles, SQuAD-style
    s = " ".join(w for w in s.split() if w not in {"a", "an", "the"})
    return s


def squad_f1_em(pred: str, golds: List[str]) -> Dict[str, float]:
    """Token-level SQuAD F1/EM on the 0-100 scale, best over references."""
    p = normalize_text(pred)
    refs = [normalize_text(g) for g in (golds or []) if g]
    if not refs:
        return {"f1": 0.0, "em": 0.0}
    best_f1 = best_em = 0.0
    p_toks = p.split()
    for r in refs:
        r_toks = r.split()
        em = 100.0 if p == r and p else 0.0
        if not p_toks or not r_toks:
            f1 = 100.0 if p_toks == r_toks else 0.0
        else:
            common = Counter(p_toks) & Counter(r_toks)
            overlap = sum(common.values())
            if overlap == 0:
                f1 = 0.0
            else:
                precision = overlap / len(p_toks)
                recall = overlap / len(r_toks)
                f1 = 100.0 * 2 * precision * recall / (precision + recall)
        best_f1 = max(best_f1, f1)
        best_em = max(best_em, em)
    return {"f1": best_f1, "em": best_em}


class AnswerEvaluator:
    """RAG quality = Retriever x Generator; diagnosis localizes the failure."""

    def __init__(self, system_type: str = "ah_rag") -> None:
        self.system_type = system_type

    # ------------------------------------------------------------------ main
    def evaluate(self, answer_obj: Dict[str, Any], graph: Any = None,
                 config: Dict[str, Any] | None = None) -> Dict[str, Any]:
        cfg = config or {}
        session_data = answer_obj.get("session_data", {}) or {}
        question = answer_obj.get("query", "")
        universal = self.evaluate_universal(answer_obj, question, session_data, cfg)
        specific = self.evaluate_system_specific(session_data, graph)
        diagnosis = self.apply_diagnosis_formula(universal)
        return {
            "scores": {"overall": self._overall_score(universal), **universal},
            "details": {"universal_metrics": universal, "specific_metrics": specific,
                        "diagnosis": diagnosis, "system_type": self.system_type},
        }

    def evaluate_universal(self, answer_obj: Dict[str, Any], question: str,
                           session_data: Dict, config: Dict) -> Dict[str, float]:
        retriever = self.evaluate_retriever(session_data, question, answer_obj, config)
        generator = self.evaluate_generator(answer_obj, session_data, question, config)
        quant = self.evaluate_quantitative(answer_obj.get("answer", ""),
                                           answer_obj.get("gold_answers", []))
        qual = self.evaluate_qualitative(answer_obj, question, config)
        if self._judge_mode(config) == "parity":
            grounding = 1.0  # the reference formula has no such metric
        else:
            from ahrag_tpu_torch.eval.judge import judge_answer_grounding
            grounding = judge_answer_grounding(question, answer_obj)
        return {
            "contextual_relevancy": retriever["contextual_relevancy"],
            "contextual_recall": retriever["contextual_recall"],
            "contextual_precision": retriever["contextual_precision"],
            "faithfulness": generator["faithfulness"],
            "answer_relevancy": generator["answer_relevancy"],
            "answer_grounding": grounding,
            "f1": quant["f1"],
            "em": quant["em"],
            "judge_overall": qual["overall"],
            # lets the diagnosis formula tell "f1 == 0 because no gold was
            # provided" apart from "graded against gold and failed"; pinned 0
            # in parity mode (the reference formula is gold-blind, so the
            # no_signal split must not fire there)
            "gold_available": (0.0 if self._judge_mode(config) == "parity"
                               else float(bool(answer_obj.get("gold_answers")))),
        }

    # ------------------------------------------------------------- retriever
    def evaluate_retriever(self, session_data: Dict, question: str,
                           answer_obj: Dict, config: Dict) -> Dict[str, float]:
        evidence = answer_obj.get("evidence", {}) or {}
        retrieved = answer_obj.get("retrieved_nodes", []) or []
        context = answer_obj.get("context", {}) or {}
        if not retrieved:
            actions = (session_data.get("stats", {}) or {}).get("actions", [])
            if not actions:
                return {"contextual_relevancy": 0.0, "contextual_recall": 0.0,
                        "contextual_precision": 0.0}
            retrieved = self._nodes_from_actions(actions)
        return {
            "contextual_relevancy": self._contextual_relevancy(retrieved, question,
                                                               evidence),
            "contextual_recall": self._contextual_recall(retrieved, answer_obj,
                                                         evidence, context),
            "contextual_precision": self._contextual_precision(
                retrieved, question, answer_obj, config),
        }

    @staticmethod
    def _nodes_from_actions(actions: List[Dict[str, Any]]) -> List[str]:
        nodes: List[str] = []
        for action in actions:
            if action.get("action") == "semantic_anchor":
                nodes.extend(action.get("returned_nodes", []))
            elif action.get("action") in {"expand_parents", "expand_children",
                                          "expand_related"}:
                nodes.extend(action.get("inputs", []))
        # order-preserving dedup: list(set(...)) iterates in salted-hash
        # order, so downstream rank-sensitive metrics (recall@10) and the
        # per-item artifact diffs churned run-to-run (ADVICE r3 item 2)
        return list(dict.fromkeys(nodes))

    def _contextual_relevancy(self, retrieved: List[str], question: str,
                              evidence: Dict) -> float:
        if not retrieved:
            return 0.0
        items = (evidence.get("summaries") or []) + (evidence.get("entities") or [])
        if not items:
            return 0.7
        q_kws = [w for w in question.lower().split() if len(w) > 3]
        relevant = 0
        for item in items:
            text = ((item.get("title") or "") + " " + (item.get("summary") or "")).lower()
            if any(k in text for k in q_kws):
                relevant += 1
        return min(1.0, (relevant / len(items)) * 1.1)

    def _contextual_recall(self, retrieved: List[str], answer_obj: Dict,
                           evidence: Dict, context: Dict) -> float:
        if not retrieved:
            return 0.0
        total = len(evidence.get("summaries") or []) + len(evidence.get("entities") or [])
        if context and context.get("stats") and total > 0:
            used = context.get("used_nodes", [])
            return min(1.0, (len(used) / total) * 1.2)
        citations = answer_obj.get("citations", [])
        if citations and retrieved:
            return min(1.0, len(citations) / max(len(retrieved), 1))
        return 0.7 if total > 0 else 0.0

    @staticmethod
    def _judge_mode(config: Dict | None) -> str:
        """evaluation.judge.mode: "deterministic" (default — the metrics carry
        signal without an LLM), or "parity" (the reference's no-judge
        constants: faithfulness/relevancy 0.5, precision 0.65 —
        answer_eval.py:331-361)."""
        judge = ((config or {}).get("evaluation") or {}).get("judge") or {}
        return str(judge.get("mode", "deterministic"))

    def _contextual_precision(self, retrieved: List[str], question: str = "",
                              answer_obj: Dict | None = None,
                              config: Dict | None = None) -> float:
        if not retrieved:
            return 0.0
        if self._judge_mode(config) == "parity":
            # the reference's placeholder constant (answer_eval.py:331-338)
            return 0.65
        from ahrag_tpu_torch.eval.judge import judge_contextual_precision
        return judge_contextual_precision(question, answer_obj or {})

    # ------------------------------------------------------------- generator
    def evaluate_generator(self, answer_obj: Dict, session_data: Dict,
                           question: str, config: Dict) -> Dict[str, float]:
        qual = self.evaluate_qualitative(answer_obj, question, config)
        correctness = qual.get("correctness", 0.0)
        coverage = qual.get("coverage", 0.0)
        if correctness > 0 or coverage > 0:  # live LLM judge
            return {"faithfulness": correctness / 10.0 if correctness > 0 else 0.5,
                    "answer_relevancy": coverage / 10.0 if coverage > 0 else 0.5}
        if self._judge_mode(config) == "parity":
            # the reference's no-judge 0.5 constants (answer_eval.py:350,361)
            return {"faithfulness": 0.5, "answer_relevancy": 0.5}
        from ahrag_tpu_torch.eval.judge import (judge_answer_relevancy,
                                          judge_faithfulness)
        return {"faithfulness": judge_faithfulness(answer_obj),
                "answer_relevancy": judge_answer_relevancy(question, answer_obj)}

    # -------------------------------------------------------------- formulas
    def apply_diagnosis_formula(self, metrics: Dict[str, float]) -> Dict[str, Any]:
        faith = metrics.get("faithfulness", 0.0)
        rel = metrics.get("answer_relevancy", 0.0)
        recall = metrics.get("contextual_recall", 0.0)
        cprec = metrics.get("contextual_precision", 1.0)
        hi, lo = 0.7, 0.5
        if faith > hi and rel < lo:
            issue, reason, conf = "retriever", "retrieved content irrelevant", 0.8
        elif faith < lo and rel > hi:
            issue, reason, conf = "generator", "retrieval fine, generation failed", 0.8
        elif faith < lo and rel < lo:
            issue, reason, conf = "both", "system-wide failure", 0.9
        elif recall < lo:
            issue, reason, conf = "retriever", "low recall drives hallucination", 0.85
        elif cprec < 0.25:
            # Deviation from the reference formula (answer_eval.py:145-193,
            # which routes on faith/relevancy/recall only): faithfulness and
            # answer_relevancy SATURATE on grounded-but-wrong answers (a
            # type-plausible span quoted from off-target evidence scores 1.0
            # on both), so those failures hid in edge_case. Near-zero
            # contextual precision — almost none of the used evidence shares
            # content with the question or answer — is the live signal:
            # calibrated on v4_sharedxl_dev_r3, this branch absorbs every
            # f1<50 item that edge_case was hiding (60/195) while keeping the
            # edge bucket failure-free (0/100). Fault-injection routing
            # unchanged (tests/test_judge.py).
            issue, reason, conf = ("retriever",
                                   "used evidence unrelated to the asked fact "
                                   "(precision)", 0.7)
        elif metrics.get("answer_grounding", 1.0) < 0.5:
            # Reading-layer failure (r4): the produced span IS attested in
            # the evidence (faithfulness saturates) and the evidence DOES
            # relate to the question (precision fine), but every sentence
            # attesting the span has no tie to the question's entities or
            # keywords — the reader lifted a span about the wrong entity.
            # That is a generation-side fault: the right content was
            # retrieved, the reading layer picked the wrong thing from it.
            issue, reason, conf = ("generator",
                                   "answer attested only in sentences untied "
                                   "to the question (grounding)", 0.7)
        elif (metrics.get("gold_available", 0.0) > 0
                and metrics.get("f1", 0.0) < 60.0):
            # "no-signal" split (VERDICT r4 item 9): graded against gold and
            # FAILING, yet every proxy reads green — faithfulness/relevancy
            # saturate, recall/precision/grounding pass. The reference routes
            # this to edge_case (answer_eval.py:145-193), conflating
            # "undiagnosed failure" with "nothing to diagnose"; here it gets
            # its own bucket with LOW confidence (none of the proxies carried
            # the failure, so the localization is genuinely unknown).
            issue, reason, conf = ("no_signal",
                                   "fails against gold while every proxy reads "
                                   "green — failure source undiagnosed", 0.2)
        else:
            issue, reason, conf = "edge_case", "system nominal; investigate edges", 0.3
        return {"primary_issue": issue, "reason": reason, "confidence": conf,
                "metrics_snapshot": {"faithfulness": faith, "answer_relevancy": rel,
                                     "contextual_recall": recall}}

    def _overall_score(self, metrics: Dict[str, float]) -> float:
        weights = {"contextual_recall": 0.3, "faithfulness": 0.25,
                   "contextual_relevancy": 0.2, "answer_relevancy": 0.15,
                   "contextual_precision": 0.1}
        score = sum(metrics.get(k, 0.0) * w for k, w in weights.items()
                    if k in metrics)
        total = sum(w for k, w in weights.items() if k in metrics)
        return score / max(total, 1e-9)

    # ---------------------------------------------------------- quantitative
    def evaluate_quantitative(self, pred_text: str,
                              gold_texts: List[str]) -> Dict[str, float]:
        return squad_f1_em(pred_text, gold_texts)

    # ----------------------------------------------------------- qualitative
    def evaluate_qualitative(self, answer_json: Dict[str, Any], question: str,
                             config: Dict[str, Any] | None = None) -> Dict[str, float]:
        zeros = {"correctness": 0.0, "coverage": 0.0, "clarity": 0.0, "overall": 0.0}
        cfg = config or {}
        judge = (cfg.get("evaluation") or {}).get("judge") or {}
        if not judge.get("use_llm", False):
            return zeros
        mgr = get_llm_manager()
        if not mgr.is_enabled(LLMModule.EVALUATION_JUDGE):
            return zeros
        schema = {"correctness": 0, "coverage": 0, "clarity": 0, "overall": 0}
        prompt = (
            "You are a strict QA judge. Score the answer 1-10 on each dimension.\n"
            f"Question: {question}\n"
            f"Answer JSON: {json.dumps(answer_json, ensure_ascii=False, default=str)}\n"
            "Dimensions: correctness (factual alignment), coverage (evidence "
            "completeness), clarity (conciseness & coherence).\n"
            f"Return only a JSON: {json.dumps(schema)}")
        for _ in range(int(judge.get("max_retries", 1)) + 1):
            txt = mgr.chat_or_none(LLMModule.EVALUATION_JUDGE,
                                   [{"role": "user", "content": prompt}], max_tokens=300)
            m = re.search(r"\{[\s\S]*\}", txt or "")
            obj = json_or_none(m.group(0)) if m else None
            if not isinstance(obj, dict):
                continue
            scores = {k: float_or_none(obj.get(k, 0.0)) for k in
                      ("correctness", "coverage", "clarity", "overall")}
            if None not in scores.values():
                return scores
        return zeros

    # ------------------------------------------------------- system-specific
    def evaluate_system_specific(self, session_data: Dict, graph: Any) -> Dict[str, Any]:
        if self.system_type == "ah_rag":
            stats = (session_data.get("stats", {}) or {}).get("cumulative", {})
            actions = (session_data.get("stats", {}) or {}).get("actions", [])
            layer_usage = {"L0": 0, "L1": 0, "L2": 0}
            all_inputs: List[str] = []
            for action in actions:
                for nid in action.get("inputs", []) or []:
                    all_inputs.append(nid)
                    if str(nid).startswith("ent:"):
                        layer_usage["L0"] += 1
                    elif str(nid).startswith("sum:"):
                        level = None
                        if graph is not None and hasattr(graph, "nodes"):
                            level = (graph.nodes.get(nid) or {}).get("level")
                        layer_usage["L2" if level == 2 else "L1"] += 1
            return {"reasoning_steps": stats.get("steps", 0),
                    "layer_utilization": layer_usage,
                    "graph_coverage": len(set(all_inputs))}
        if self.system_type == "naive_rag":
            stats = (session_data.get("stats", {}) or {}).get("cumulative", {})
            return {"retrieval_efficiency": stats.get("time_s", 0.0),
                    "context_utilization": 1.0}
        return {}

    # ------------------------------------------------------------ efficiency
    def evaluate_efficiency(self, summary_json_path: str) -> Dict[str, float]:
        """Steps, expansions and latency from a session's ``summary.json``;
        zeros when the file is missing. A file that is there but does not
        parse, or whose stats are not numbers, raises (the JAX package
        returns the zeros for those too)."""
        if not os.path.isfile(summary_json_path):
            return {"steps": 0.0, "nodes_expanded": 0.0, "latency_s": 0.0}
        with open(summary_json_path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        stats = obj.get("stats", {}).get("cumulative", {})
        out = {"steps": float(stats.get("steps", 0)),
               "nodes_expanded": float(stats.get("expansions", 0)),
               "latency_s": float(stats.get("time_s", 0.0))}
        if "tokens_total" in stats:
            out["tokens_total"] = float(stats["tokens_total"])
        return out
