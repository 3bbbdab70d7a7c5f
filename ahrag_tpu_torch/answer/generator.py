"""Answer generation with citation enforcement and a deterministic fallback.

The port's copy of ``ahrag_tpu/answer/generator.py``. Two differences: the
learned span reader (``answer.reader_ckpt``) runs on the generator's
``device``, and a configured checkpoint that is missing raises where the JAX
package answers without it; and an LLM reply is asked through
``chat_or_none``, so a failed call falls back as the JAX package's caught
exception does. Behavior parity with the reference generator (answer/generator.py:14-217):

- LLM path: strict-JSON prompt with schema ``{answer, rationale, citations[]}``,
  temperature decays 0.05 per retry, citations are whitelisted against
  ``context.used_nodes``;
- deterministic fallback (LLM disabled/unavailable): parses the evidence skeleton
  lines, routes by query type (nationality/comparison/work/default keyword overlap),
  answers nationality-comparison questions with an explicit Yes/No, caps the answer
  at 200 chars and the rationale at 600, cites the first 3 allowed nodes.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

from ahrag_tpu_torch.utils.llm import LLMModule, get_llm_manager
from ahrag_tpu_torch.utils.parse import json_or_none

_JSON_RE = re.compile(r"\{[\s\S]*\}")

_NATIONALITY_KWS = ("nationality", "country", "citizen", "where", "location")
_COMPARISON_KWS = ("same", "both", "different", "compare")
_WORK_KWS = ("film", "movie", "directed", "work", "project", "cinema")
_NATIONALITY_HINTS = ("american", "british", "chinese", "french", "german", "italian",
                      "japanese", "director", "actor", "born", "nationality")


class AnswerGenerator:
    def __init__(self, device=None) -> None:
        """``device`` is where a configured span reader runs (``cuda`` unless
        the caller names another); nothing else here touches a device."""
        self.device = device

    def _build_prompt(self, query: str, context: Dict[str, Any]) -> str:
        schema = {"answer": "direct, concise conclusion (state clearly if evidence is "
                            "insufficient)",
                  "rationale": "2-4 sentences of evidence-grounded reasoning",
                  "citations": ["node_id"]}
        rules = (
            "You are an expert research assistant. Answer the question using ONLY the "
            "evidence provided.\n"
            "- Be faithful: every claim must be supported by the evidence.\n"
            "- Be specific: extract the exact fact the question asks for.\n"
            "- For comparison questions, extract the compared attribute for each "
            "entity and answer Yes/No when possible.\n"
            "- You may use contextual inference (e.g. 'American director' implies "
            "American nationality).\n"
            "- Cite the node ids of the evidence you used.\n"
            "- Say 'Evidence insufficient' only if no reasonable inference exists."
        )
        return (f"QUESTION: {query}\n\n"
                f"AVAILABLE EVIDENCE:\n{context.get('context_text', '')}\n\n"
                f"RULES:\n{rules}\n\n"
                f"Return ONLY one JSON object of this shape:\n"
                f"{json.dumps(schema, ensure_ascii=False, indent=2)}")

    def _extract_json(self, text: str) -> Optional[Dict[str, Any]]:
        m = _JSON_RE.search(text or "")
        if not m:
            return None
        obj = json_or_none(m.group(0))
        if not (isinstance(obj, dict) and all(k in obj for k in
                                              ("answer", "rationale", "citations"))):
            return None
        cites = obj.get("citations")
        obj["citations"] = [str(x) for x in cites if x] if isinstance(cites, list) else []
        return obj

    def _finalize(self, obj: Dict[str, Any], allowed: List[str]) -> Dict[str, Any]:
        allowed_set = set(allowed)
        return {
            "answer": str(obj.get("answer", "")).strip(),
            "rationale": str(obj.get("rationale", "")).strip(),
            "citations": [c for c in (obj.get("citations") or []) if c in allowed_set],
        }

    # ------------------------------------------------------------------ main
    def generate(self, query: str, context: Dict[str, Any],
                 config: Dict[str, Any] | None = None) -> Dict[str, Any]:
        cfg = config or {}
        use_llm = bool(cfg.get("use_llm", False))
        temperature = float(cfg.get("temperature", 0.1))
        max_retries = int(cfg.get("max_retries", 2))
        allowed: List[str] = context.get("used_nodes", [])

        mgr = get_llm_manager()
        if use_llm and mgr.is_enabled(LLMModule.ANSWER_GENERATION):
            prompt = self._build_prompt(query, context)
            for retry in range(max_retries + 1):
                text = mgr.chat_or_none(LLMModule.ANSWER_GENERATION,
                                        [{"role": "user", "content": prompt}],
                                        temperature=max(0.0, temperature - 0.05 * retry),
                                        max_tokens=400)
                obj = self._extract_json(text)
                if obj is not None:
                    return self._finalize(obj, allowed)
        return self._fallback(query, context, allowed, cfg)

    # -------------------------------------------------------------- fallback
    def _fallback(self, query: str, context: Dict[str, Any],
                  allowed: List[str],
                  cfg: Dict[str, Any] | None = None) -> Dict[str, Any]:
        query_l = query.lower()
        is_comparison = any(k in query_l for k in _COMPARISON_KWS)
        # typed extractive answer first: exact spans beat snippet synthesis.
        # Comparisons included — the fact chain (answer/qa.py) resolves both
        # subjects' attributes and returns a bare yes/no; the former skip here
        # routed every comparison to _synthesize's hardcoded nationality list,
        # which silently failed on any nationality outside its 7 entries.
        from ahrag_tpu_torch.answer.extractive import extract_answer
        # learned reader (answer/reader.py): the schema-free middle stage —
        # opt-in via answer.reader_ckpt; a configured checkpoint that is
        # missing raises
        reader = None
        if cfg and cfg.get("reader_ckpt"):
            from ahrag_tpu_torch.answer.reader import get_reader
            reader = get_reader(str(cfg["reader_ckpt"]),
                                float(cfg.get("reader_min_conf", 0.25)),
                                device=self.device)
        span = extract_answer(query, context.get("context_text", ""),
                              allow_span_scoring=not is_comparison,
                              reader=reader,
                              reader_only=bool(cfg
                                               and cfg.get("reader_only")))
        if span == "unanswerable":
            # abstention (answer/qa.py::unanswerable): the asked entity is
            # absent from the evidence — cite nothing, claim nothing
            return {"answer": "unanswerable",
                    "rationale": "No retrieved evidence mentions the asked "
                                 "entity; the question cannot be answered "
                                 "from this corpus.",
                    "citations": []}
        if span:
            return {"answer": span[:200],
                    "rationale": f"Extracted from evidence matching the "
                                 f"question terms: '{span}'."[:600],
                    "citations": allowed[:3]}
        lines = [ln.strip() for ln in context.get("context_text", "").splitlines()
                 if ln.strip().startswith("-")]
        entity_lines = [ln for ln in lines if "(entity)" in ln]
        summary_lines = [ln for ln in lines if "(summary)" in ln]
        query_lower = query.lower()

        infos: List[str] = []
        for line in (entity_lines + summary_lines)[:8]:
            if "::" not in line:
                continue
            info = line.split("::", 1)[1].strip()
            if self._is_relevant(info.lower(), query_lower):
                infos.append(info)

        if infos:
            answer = self._synthesize(infos, query_lower)
            rationale = f"Evidence analysis shows: {' | '.join(infos[:3])}"
        elif entity_lines or summary_lines:
            answer = "Evidence retrieved but unable to synthesize conclusive answer"
            rationale = " | ".join(lines[:3])[:600]
        else:
            answer = "No sufficient evidence found to answer the question"
            rationale = "Search returned limited relevant information"

        return {"answer": answer[:200], "rationale": rationale[:600],
                "citations": allowed[:3]}

    def _is_relevant(self, info_lower: str, query_lower: str) -> bool:
        if any(k in query_lower for k in _NATIONALITY_KWS):
            return any(k in info_lower for k in _NATIONALITY_HINTS)
        if any(k in query_lower for k in _COMPARISON_KWS):
            return any(k in info_lower for k in
                       ("director", "actor", "person", *_NATIONALITY_HINTS))
        if any(k in query_lower for k in _WORK_KWS):
            return any(k in info_lower for k in
                       ("film", "movie", "directed", "produced", "work"))
        overlap = set(query_lower.split()) & set(info_lower.split())
        return len(overlap) >= 2

    def _synthesize(self, infos: List[str], query_lower: str) -> str:
        is_comparison = any(k in query_lower for k in _COMPARISON_KWS)
        is_nationality = any(k in query_lower for k in ("nationality", "country"))
        if len(infos) >= 2 and is_comparison:
            if is_nationality:
                lowers = [infos[0].lower(), infos[1].lower()]
                nats = []
                for text in lowers:
                    nats.append(next((n for n in ("american", "british", "chinese",
                                                  "french", "german", "italian",
                                                  "japanese") if n in text), None))
                # terse Yes/No: gold answers for comparison questions are bare
                # "Yes"/"No", and EM/F1 punish trailing explanation (the
                # rationale carries the explanation instead)
                if nats[0] and nats[0] == nats[1]:
                    return "Yes"
                if nats[0] and nats[1]:
                    return "No"
                # the reference treats two 'american' hits as a Yes, else a No
                if sum(1 for t in lowers if "american" in t) >= 2:
                    return "Yes"
                return "No"
            return f"Based on evidence analysis: {infos[0]} and {infos[1]}"
        if is_nationality:
            hit = next((i for i in infos if any(n in i.lower()
                                                for n in _NATIONALITY_HINTS)), None)
            return f"Based on evidence: {hit or infos[0]}"
        return f"Based on evidence: {infos[0]}"
