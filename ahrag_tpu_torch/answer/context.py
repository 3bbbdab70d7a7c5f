"""Token-budgeted context assembly ("skeleton + details").

The port's copy of ``ahrag_tpu/answer/context.py``, counting tokens with the
port's ``count_tokens``. Behavior parity with the reference processor (answer/context_processor.py:60-215):

- evidence nodes ranked by ``0.4*judge + 0.2*conf + 0.4*layer_weight`` with layer
  weights L2/L1/L0 = 1.0/0.7/0.4 (unknown level 0.5), judge/conf normalized /10;
- skeleton: one-line briefs within ``budget * skeleton_ratio``;
- details: full raw text if it fits the remaining budget minus the reserve, else
  sentence-trim compression targeted at ``summarizer_max_tokens``;
- kept-spans: regex-extracted dates/numbers/negations re-appended as ``[KEEP:span]``
  when compression loses them;
- outputs ``{context_text, used_nodes, stats}`` with the same stats keys.

Unlike the reference, the ``enable_cache`` flag actually does something: identical
(node set, budget, config) requests return a cached result.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from ahrag_tpu_torch.utils.parse import float_or_none
from ahrag_tpu_torch.utils.tokens import count_tokens


def _normalize_float(x: Any, scale: float = 10.0, default: float = 0.0) -> float:
    v = float_or_none(x)
    return default if v is None else max(0.0, min(1.0, v / scale))


def _layer_weight(level: int | None) -> float:
    if level is None:
        return 0.5
    return {2: 1.0, 1: 0.7, 0: 0.4}.get(level, 0.5)


_DATE_RE = re.compile(r"\b\d{4}[-/.年]?(?:\d{1,2}[-/.月]?)?(?:\d{1,2}日)?\b")
_NUM_RE = re.compile(r"\b\d+(?:\.\d+)?%?\b")
_NEGATIONS = ("不", "未", "无", "否", "not", "no", "never", "without")
# ';' included: merged node descriptions join their source sentences with
# '.; ' (graph build), and a splitter keyed on punctuation-then-space alone
# never fires there — compression then degenerates to prefix truncation
_SENT_SPLIT = re.compile(r"(?<=[。！？.!?;])\s+")


def extract_kept_spans(text: str) -> List[str]:
    spans = _DATE_RE.findall(text) + _NUM_RE.findall(text)
    spans += [n for n in _NEGATIONS if n in text]
    seen: set[str] = set()
    out = []
    for s in spans:
        if s and s not in seen:
            seen.add(s)
            out.append(s)
    return out


class ContextProcessor:
    def __init__(self, model_for_budget: str | None = None) -> None:
        self.model_for_budget = model_for_budget
        self._cache: Dict[Tuple, Dict[str, Any]] = {}

    def _tok(self, text: str) -> int:
        return count_tokens(text)

    @staticmethod
    def _brief(text: str, limit: int = 160) -> str:
        """One-line budget-limited brief that never cuts mid-sentence/mid-word:
        a hard ``text[:160]`` manufactures fragments ("...film Doctor S") that
        read as false facts downstream, and embedded newlines would spill the
        skeleton entry onto unprefixed lines."""
        text = " ".join(text.split())
        if len(text) <= limit:
            return text
        cut = text[:limit]
        # clause boundaries include the '.;'-joined entity-summary seams —
        # cutting mid-span manufactures phantom entities downstream ("The
        # Frozen Harbor" clipped to "The Frozen" reads as a second film)
        end = -1
        for m in re.finditer(r"[.!?;](?=\s)", cut):
            end = m.start()
        if end >= limit // 3:
            return cut[: end + 1]
        sp = cut.rfind(" ")
        return cut[:sp] if sp > 0 else cut

    def _compress(self, text: str, target_tokens: int,
                  subject: str | None = None) -> str:
        if target_tokens <= 0 or not text:
            return ""
        parts = [p for p in _SENT_SPLIT.split(text) if p]
        if subject:
            # a node's own-subject sentences carry its defining facts; at
            # corpus scale a hub node's merged description is dominated by
            # OTHER entities' mention sentences (a city mentioned by dozens of
            # biography paragraphs), and order-of-encounter trimming then
            # drops the one sentence that defines the node itself. Sentences
            # whose opening names the subject go first; relative order within
            # each group is preserved.
            sl = subject.lower()
            window = len(subject) + 32
            lead = [i for i, p in enumerate(parts) if sl in p[:window].lower()]
            lead_set = set(lead)
            parts = ([parts[i] for i in lead]
                     + [p for i, p in enumerate(parts) if i not in lead_set])
        acc: List[str] = []
        cur = 0
        for part in parts:
            pt = self._tok(part)
            if cur + pt > target_tokens:
                break
            acc.append(part)
            cur += pt
        out = " ".join(acc).strip()
        return out if out else text[: max(1, target_tokens * 4)]

    def build_context(self, evidence: Dict[str, Any], hg: Any, token_budget: int,
                      config: Dict[str, Any] | None = None) -> Dict[str, Any]:
        cfg = config or {}
        skeleton_ratio = float(cfg.get("skeleton_ratio", 0.2))
        reserve_ratio = float(cfg.get("reserve_ratio", 0.1))
        enable_kept_spans = bool(cfg.get("enable_kept_spans", True))
        enable_cache = bool(cfg.get("enable_cache", True))
        summarizer_max_tokens = int(cfg.get("summarizer_max_tokens", 256))
        rank_weights = cfg.get("rank_weights") or {"judge": 0.4, "conf": 0.2, "layer": 0.4}

        # gather candidate nodes, dedup preserving order
        ordered: List[str] = []
        seen: set[str] = set()
        for key in ("summaries", "entities"):
            for item in (evidence.get(key) or []):
                nid = item.get("node_id")
                if nid and nid not in seen:
                    seen.add(nid)
                    ordered.append(nid)

        cache_key = (tuple(ordered), int(token_budget), skeleton_ratio, reserve_ratio,
                     enable_kept_spans, summarizer_max_tokens,
                     tuple(sorted(rank_weights.items())))
        if enable_cache and cache_key in self._cache:
            return self._cache[cache_key]

        def node(nid: str) -> Dict[str, Any]:
            return hg.nodes.get(nid, {}) if hasattr(hg, "nodes") else {}

        # rank
        scored: List[Tuple[str, float]] = []
        for nid in ordered:
            d = node(nid)
            judge = _normalize_float(
                d.get("judge_overall")
                or (hg.node_judge_overall(nid) if hasattr(hg, "node_judge_overall") else None))
            conf = _normalize_float(d.get("confidence") or d.get("confidence_score"))
            score = (rank_weights["judge"] * judge + rank_weights["conf"] * conf
                     + rank_weights["layer"] * _layer_weight(d.get("level")))
            scored.append((nid, score))
        scored.sort(key=lambda x: x[1], reverse=True)
        ranked = [nid for nid, _ in scored]

        budget_total = int(token_budget)
        budget_skeleton = int(budget_total * skeleton_ratio)
        budget_reserve = int(budget_total * reserve_ratio)
        tokens_used = 0
        skeleton_lines: List[str] = []
        details_lines: List[str] = []
        used_nodes: List[str] = []
        kept_spans: Dict[str, List[str]] = {}
        per_node_mode: Dict[str, str] = {}

        for nid in ranked:
            d = node(nid)
            title = d.get("title") or d.get("name") or ""
            summary = d.get("summary_text") or d.get("summary") or d.get("description") or ""
            line = (f"- [{nid}] ({d.get('node_type') or ''}) {title} :: "
                    f"{self._brief(summary)}").strip()
            t = self._tok(line)
            if tokens_used + t <= budget_skeleton:
                skeleton_lines.append(line)
                tokens_used += t
                used_nodes.append(nid)
                if enable_kept_spans:
                    kept_spans[nid] = extract_kept_spans(summary)
                per_node_mode[nid] = "skeleton"

        for nid in ranked:
            d = node(nid)
            raw = (d.get("source_text") or d.get("source_text_ref")
                   or d.get("summary_text") or d.get("description") or "")
            if not raw:
                continue
            remaining = max(0, budget_total - budget_reserve - tokens_used)
            if remaining <= 0:
                break
            raw_tokens = self._tok(raw)
            if raw_tokens <= remaining:
                details_lines.append(f"[DETAIL:{nid}]\n{raw.strip()}\n")
                tokens_used += raw_tokens
                per_node_mode.setdefault(nid, "detail_full")
            else:
                comp = self._compress(raw, min(remaining, summarizer_max_tokens),
                                      subject=(d.get("title") or d.get("name")
                                               or None))
                comp_tokens = self._tok(comp)
                if comp and comp_tokens <= remaining:
                    if enable_kept_spans and kept_spans.get(nid):
                        for span in kept_spans[nid]:
                            if span and span not in comp and span in raw:
                                comp = (comp + f"\n[KEEP:{span}]").strip()
                                comp_tokens = self._tok(comp)
                                if comp_tokens > remaining:
                                    break
                    details_lines.append(f"[DETAIL:{nid}]\n{comp.strip()}\n")
                    tokens_used += comp_tokens
                    per_node_mode.setdefault(nid, "detail_compressed")
                else:
                    per_node_mode.setdefault(nid, "detail_dropped")

        context_text = ("# Evidence Skeleton\n" + "\n".join(skeleton_lines)
                        + "\n\n# Evidence Details\n" + "\n".join(details_lines)).strip()
        stats = {
            "budget_total": budget_total,
            "tokens_used": self._tok(context_text),
            "skeleton_tokens": self._tok("\n".join(skeleton_lines)),
            "detail_tokens": self._tok("\n".join(details_lines)),
            "compression_rate": 1.0 if not details_lines
            else min(1.0, tokens_used / max(1, budget_total)),
            "per_node_mode": per_node_mode,
            "kept_spans": kept_spans,
        }
        out = {"context_text": context_text, "used_nodes": used_nodes, "stats": stats}
        if enable_cache:
            self._cache[cache_key] = out
        return out
