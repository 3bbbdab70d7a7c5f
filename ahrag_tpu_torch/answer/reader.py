"""Inference bridge for the learned span reader.

Port of ``ahrag_tpu/answer/reader.py``: everything but the model's forward
is the JAX package's code, unchanged. The members of an ensemble run on
one device (``cuda`` unless the caller names another), one read at B = 1
with the inputs on the device and only the two logit rows copied back.
A configured checkpoint that is missing or does not load raises, where
the JAX package turns the reader off without a word.

Sits between the typed fact chain (answer/qa.py) and generic span
scoring in answer/extractive.py::extract_answer: when the fact tables
don't know a question's relation (the schema-generalization gap the v5
eval measures), the trained SpanReader reads the same cleaned evidence
sentences and points at the answer, with its joint span probability as
the abstention signal.

This is the TPU-native counterpart of the reference's LLM read
(answer/generator.py:100): learned, schema-free, on-device — not
another hand rule. The model never saw any v1-v5 relation during
training (models/reader/data.py randomizes every relation surface), so
its answers here are zero-shot schema generalization by construction.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.utils.once import locked_cache

DEFAULT_CKPT = "checkpoints/reader.msgpack"

_TOKEN_RE = re.compile(r"[A-Za-z0-9][\w']*")
_STOP = {"the", "a", "an", "of", "in", "on", "at", "to", "for", "by", "from",
         "with", "and", "or", "is", "are", "was", "were", "did", "does", "do",
         "who", "whom", "what", "which", "where", "when", "why", "how", "that",
         "this", "it", "its", "their", "his", "her", "as", "be", "been"}


def select_evidence(query: str, sentences: List[str],
                    budget: int = 320) -> List[str]:
    """Dedupe and budget-select evidence sentences for the reader.

    Pipeline contexts repeat node text (skeleton + details + expansion all
    render the same sentence) and routinely exceed the reader's fixed
    evidence window. Duplicates split the span softmax across identical
    positions (confidence dilution), and arrival-order truncation can cut
    the answer sentence entirely. So: keep the FIRST occurrence of each
    distinct sentence, and when the dedup'd evidence still exceeds the
    token budget, keep the sentences most lexically entangled with the
    question (content-word/stem overlap + capitalized-anchor hits),
    in original order, until the budget fills. Paragraph seams (""
    sentinels) are preserved between kept sentences so the model's
    per-paragraph novelty features keep their meaning.
    """
    from ahrag_tpu_torch.models.reader.features import _norm
    q_toks = _TOKEN_RE.findall(query)
    q_content = {_norm(t) for t in q_toks
                 if _norm(t) not in _STOP and len(t) > 2}
    q_stems = {w[:4] for w in q_content}
    q_caps = {_norm(t) for t in q_toks if t[:1].isupper()}

    # dedupe, tracking paragraph id per kept sentence
    kept: List[Tuple[int, str, List[str]]] = []   # (para, text, tokens)
    seen = set()
    para = 0
    for s in sentences:
        if s == "":
            para += 1
            continue
        key = " ".join(_TOKEN_RE.findall(s.lower()))
        if not key or key in seen:
            continue
        seen.add(key)
        kept.append((para, s, _TOKEN_RE.findall(s)))

    total = sum(len(t) for _, _, t in kept)
    if total > budget:
        def score(entry):
            _, _, toks = entry
            low = {_norm(t) for t in toks}
            stems = {_norm(t)[:4] for t in toks}
            ov = sum(1 for w in q_content if w in low or w[:4] in stems)
            anchor = sum(1 for w in q_caps if w in low)
            return ov / max(1, len(q_content)) + anchor
        order = sorted(range(len(kept)), key=lambda i: -score(kept[i]))
        chosen = set()
        used = 0
        for i in order:
            n = len(kept[i][2])
            if used + n > budget and chosen:
                continue
            chosen.add(i)
            used += n
            if used >= budget:
                break
        kept = [kept[i] for i in sorted(chosen)]

    out: List[str] = []
    prev_para = None
    for p, s, _ in kept:
        if prev_para is not None and p != prev_para:
            out.append("")
        out.append(s)
        prev_para = p
    return out


_YEAR_SHAPE = re.compile(r"^(1[5-9]\d{2}|20\d{2})$")
_NUM_SHAPE = re.compile(r"^\d+(?:\.\d+)?$")


_YEAR_Q = re.compile(r"\b(?:what|which)\s+year\b|\bwhen\b|\bin what year\b",
                     re.IGNORECASE)
_WHO_Q = re.compile(r"^\s*(?:who|whom)\b|\bname the (?:person|figure)\b"
                    r"|\bto whom\b|\bwith whom\b",
                    re.IGNORECASE)
# occupation/vocation-intent questions expect a lowercase noun answer —
# question-intent vocabulary (general English), not relation vocabulary
_NOUN_Q = re.compile(r"\b(?:occupation|profession|vocation|trade|calling)\b"
                     r"|\bline of work\b|\b(?:make|earn)s? a living\b"
                     r"|\bdo(?:es)? .{0,40}for a living\b",
                     re.IGNORECASE)
# hop-question marker: the asked entity is DESCRIBED relative to a named
# anchor ("the person who ...", "the figure X is named for") — structural
# English, no relation vocabulary
_HOP_Q = re.compile(r"\bthe (?:person|figure|one|partner|spouse|mentor|"
                    r"counterpart|associate|collaborator)\b", re.IGNORECASE)


def expected_shape(query: str) -> Optional[str]:
    """Coarse expected answer shape from the question word alone — generic
    English, no relation vocabulary (the v5 disjointness discipline)."""
    if _YEAR_Q.search(query):
        return "year"
    if _NOUN_Q.search(query):
        return "noun"
    if _WHO_Q.search(query):
        return "name"
    return None


def answer_shape(text: str) -> str:
    """Coarse span shape for per-type confidence calibration."""
    t = text.strip()
    if _YEAR_SHAPE.match(t):
        return "year"
    if _NUM_SHAPE.match(t):
        return "number"
    if t[:1].isupper():
        return "name"
    return "noun"


def _shape_span_pred(exp: str, tokens: List[str]):
    """Span predicate enforcing surface-shape agreement with the
    question word (structural, vocabulary-free). ``name2`` = multiword
    capitalized run — the person-name shape used to pick a bridge
    entity (single capitalized tokens are usually cities/fragments)."""
    if exp == "year":
        return lambda i, j: (i == j
                             and bool(_YEAR_SHAPE.match(tokens[i])))
    if exp == "name":
        return lambda i, j: all(tokens[k][:1].isupper()
                                for k in range(i, j + 1))
    if exp == "name2":
        return lambda i, j: (j > i
                             and all(tokens[k][:1].isupper()
                                     for k in range(i, j + 1)))
    # noun: every span token lowercase, non-stop, non-numeric
    def _noun_ok(i, j):
        for t in tokens[i:j + 1]:
            if (not t[:1].islower()) or t.lower() in _STOP \
                    or _NUM_SHAPE.match(t):
                return False
        return True
    return _noun_ok


def _raw_hop_valid(window: List[str], query: str, raw_text: str) -> bool:
    """Did the raw read already perform a legitimate hop?

    True when some paragraph contains the raw span contiguously AND that
    paragraph carries a multiword capitalized entity that co-occurs, in
    some sentence anywhere in the window, with one of the question's
    capitalized anchors — the structural signature of "attribute of the
    entity the relation sentence points at"."""
    from ahrag_tpu_torch.models.reader.features import _norm
    q_caps = {_norm(t) for t in _TOKEN_RE.findall(query)
              if t[:1].isupper()}
    rt = tuple(_norm(t) for t in _TOKEN_RE.findall(raw_text))
    if not rt or not q_caps:
        return False
    # tokenize window into (para, sentence-token-lists)
    paras: List[List[List[str]]] = [[]]
    raw_sents: List[List[Tuple[str, bool]]] = [[]]
    for s in window:
        if s == "":
            paras.append([])
            raw_sents.append([])
            continue
        toks = _TOKEN_RE.findall(s)
        paras[-1].append([_norm(t) for t in toks])
        raw_sents[-1].append([(t, t[:1].isupper()) for t in toks])
    lr = len(rt)

    def _contig(seq, pat):
        lp = len(pat)
        return any(tuple(seq[x:x + lp]) == pat
                   for x in range(len(seq) - lp + 1))

    # all multiword cap runs per paragraph
    def _runs(pi):
        out = []
        for sent in raw_sents[pi]:
            run = []
            for t, up in sent:
                if up:
                    run.append(_norm(t))
                else:
                    if len(run) >= 2:
                        out.append(tuple(run))
                    run = []
            if len(run) >= 2:
                out.append(tuple(run))
        return out

    all_sents = [seq for psents in paras for seq in psents]
    for pi, psents in enumerate(paras):
        if not any(_contig(seq, rt) for seq in psents):
            continue
        for name in _runs(pi):
            if all(tok in q_caps for tok in name):
                continue                      # the anchor itself
            for seq in all_sents:
                if _contig(seq, name) and (q_caps & set(seq)):
                    return True
    return False


def _base_span_pred(ev):
    """Default decode exclusions, all vocabulary-free:

    (a) a bare lowercase token that heads a prepositional phrase ("the
        stewardship OF ...", "devoted TO the ...", "a practice ON the
        ...") is a relational/abstract noun, never an entity answer —
        the answer is that phrase's OBJECT (features.py ch18-19);
        multiword spans containing their own preposition ("maker of
        maps") stay eligible;
    (b) a bare lowercase token recurring across half the paragraphs is
        boilerplate-template vocabulary ("devoted", "life", "days" in a
        corpus whose every biography opens the same way), not a fact.
    """
    from ahrag_tpu_torch.models.reader.features import _norm
    toks = ev.tokens
    sent = ev.sent_index
    para_of_sent = ev.para_of_sent or [0]
    df: dict = {}
    for k, t in enumerate(toks):
        sid = sent[k]
        p = para_of_sent[sid] if sid < len(para_of_sent) else 0
        df.setdefault(_norm(t), set()).add(p)
    n_paras = max(1, len({p for p in para_of_sent}))
    half = max(2, (n_paras + 1) // 2)

    _preps = ("of", "to", "in", "on", "at", "from", "with", "up")
    _dets = ("the", "a", "an", "its", "his", "her", "their")

    def ok(i, j):
        nxt = (toks[j + 1].lower()
               if j + 1 < len(toks) and sent[j + 1] == sent[j] else "")
        if i == j and toks[i][:1].islower():
            if nxt in _preps or nxt in _dets:
                # heads a prepositional phrase (relational noun) or is
                # followed by a determiner (a verb: "entered THE world")
                return False
            if len(df.get(_norm(toks[i]), ())) >= half:
                return False
        elif j > i and all(t[:1].islower() for t in toks[i:j + 1]) \
                and nxt in _dets:
            # a lowercase run directly followed by a determiner has
            # overrun into a verb ("marine biologist entered THE world")
            return False
        return True
    return ok


class ReaderAnswerer:
    """Loads a trained SpanReader checkpoint and answers from sentences."""

    #: per-shape confidence at which the reader PRE-EMPTS span scoring (vs
    #: min_conf, below which it never answers; between the two it only
    #: answers when span scoring found nothing — see
    #: extractive.py::extract_answer). Round-4 used one global 0.95, set
    #: where year reads were never observed wrong; round 5 calibrates per
    #: answer SHAPE on v5 DEV probes (tools/calibrate_reader.py writes
    #: reports/reader_calibration_r5.json; test split untouched): each
    #: shape's threshold is the lowest band whose dev precision is 1.0.
    #: round-5 recalibration on the r5 ensemble
    #: (reports/reader_calibration_r5_final.json): lowest band with dev
    #: precision 1.0 per shape — year 0.98, name 0.98, noun 0.90
    #: ("number" unobserved on the probes; kept at the conservative 0.95).
    hi_conf_by_shape = {"year": 0.98, "number": 0.95, "name": 0.98,
                        "noun": 0.90}

    @property
    def hi_conf(self) -> float:  # back-compat floor for external readers
        return min(self.hi_conf_by_shape.values())

    def hi_conf_for(self, text: str) -> float:
        return self.hi_conf_by_shape.get(answer_shape(text), 0.95)

    def __init__(self, ckpt_path: str, d_model: Optional[int] = None,
                 n_layers: Optional[int] = None, min_conf: float = 0.25,
                 device=None) -> None:
        """``ckpt_path`` may be one checkpoint or a ``;``-separated
        ensemble; ensemble members' start/end logits are averaged (seed
        variance moves 5-10 F1 per question family on the v5 probes —
        the mean decodes more stably than any single member). Each member
        is a flax msgpack of the JAX package or the port's ``torch.save``
        file, its architecture read from ``<stem>_curve.json``
        (``SpanReader.from_checkpoint``), on ``device``."""
        from ahrag_tpu_torch.models.reader.model import SpanReader

        self.min_conf = float(min_conf)
        self.device = resolve_device(device)
        paths = [p for p in str(ckpt_path).split(";") if p]
        self._models = [SpanReader.from_checkpoint(p, device=self.device,
                                                   d_model=d_model, n_layers=n_layers)
                        for p in paths]
        self._model = self._models[0]

    @torch.no_grad()
    def _apply(self, fb) -> Tuple[np.ndarray, np.ndarray]:
        """The members' mean (start, end) logits [1, SEQ_LEN] for one
        featurized read, as numpy."""
        args = [torch.from_numpy(x).to(self.device) for x in fb]
        s_sum = e_sum = None
        for m in self._models:
            s, e = m(*args)
            s_sum = s if s_sum is None else s_sum + s
            e_sum = e if e_sum is None else e_sum + e
        if len(self._models) > 1:
            s_sum, e_sum = s_sum / len(self._models), e_sum / len(self._models)
        out = torch.stack([s_sum, e_sum]).cpu().numpy()
        return out[0], out[1]

    def _read(self, query: str, window: List[str],
              max_span_len: int = 6, constrain: bool = True,
              force_shape: Optional[str] = None
              ) -> Tuple[Optional[str], float]:
        """One forward read of an already-selected evidence window.

        With ``constrain`` (shape-constrained decode): when the question
        word fixes the answer's surface shape (a STRUCTURAL cue — "in
        what year" can only be answered by a year token, "who" by a
        capitalized name, an occupation question by a lowercase noun),
        and the model's unconstrained argmax span disagrees, the decoder
        re-searches the same logits restricted to shape-agreeing spans.
        The model still does the pointing; the constraint only removes
        decodes the question word already rules out. ``answer`` passes
        ``constrain=False`` on the FIRST window so a name read where a
        year/noun is expected stays visible as a bridge-entity signal.
        """
        from ahrag_tpu_torch.models.reader.features import (Q_LEN, best_span,
                                                      decode_span, featurize)
        fb, ev = featurize(query, window)
        if not ev.tokens:
            return None, 0.0
        s_log, e_log = self._apply(fb)
        s = np.asarray(s_log)[0, Q_LEN:]
        e = np.asarray(e_log)[0, Q_LEN:]
        if force_shape is not None:
            # direct shape-forced decode (bridge-name extraction). For the
            # bridge ("name2") the span must additionally sit in a sentence
            # that carries one of the question's capitalized anchors — the
            # relation sentence names BOTH the anchor and the bridge
            # entity; names elsewhere are unrelated cast members.
            from ahrag_tpu_torch.models.reader.features import _norm
            shape0 = _shape_span_pred(force_shape, ev.tokens)
            q_norm = {_norm(t) for t in _TOKEN_RE.findall(query)}
            toks = ev.tokens

            def pred0(i, j):
                # in-query spans rejected IN the search (a post-hoc check
                # would discard the whole decode when the argmax span is
                # the question's own anchor, instead of taking next-best).
                # For bridge extraction the span's TAIL is what binds the
                # second read, so a span whose last two tokens are the
                # question's own anchor is equally useless.
                if all(_norm(toks[k]) in q_norm for k in range(i, j + 1)):
                    return False
                if force_shape == "name2" and _norm(toks[j]) in q_norm:
                    # the span TAIL binds the second read; a tail that is
                    # the question's own anchor re-binds the anchor
                    return False
                return shape0(i, j)
            pred = pred0
            if force_shape == "name2":
                # anchored sentences = those carrying a FULL multiword
                # anchor run of the question (single-token matching lets
                # "Juniper Laboratory" anchor a "Meridian Laboratory"
                # question through the shared generic token)
                q_runs: list = []
                run: list = []
                for t in _TOKEN_RE.findall(query):
                    if t[:1].isupper():
                        run.append(_norm(t))
                    else:
                        if len(run) >= 2:
                            q_runs.append(tuple(run))
                        run = []
                if len(run) >= 2:
                    q_runs.append(tuple(run))
                sent_seq: dict = {}
                for k, t in enumerate(ev.tokens):
                    sent_seq.setdefault(ev.sent_index[k],
                                        []).append(_norm(t))

                def _has_run(seq, runs):
                    for r in runs:
                        lr = len(r)
                        if any(tuple(seq[x:x + lr]) == r
                               for x in range(len(seq) - lr + 1)):
                            return True
                    return False
                if q_runs:
                    anchored = {sid for sid, seq in sent_seq.items()
                                if _has_run(seq, q_runs)}
                else:
                    qcaps = {_norm(t) for t in _TOKEN_RE.findall(query)
                             if t[:1].isupper()}
                    anchored = {sid for sid, seq in sent_seq.items()
                                if qcaps & set(seq)} if qcaps else set()
                if anchored:
                    pred = (lambda i, j:
                            pred0(i, j)
                            and ev.sent_index[i] in anchored)
            i, j, p = best_span(s, e, ev, max_len=max_span_len,
                                span_pred=pred)
            if i < 0 and pred is not pred0:
                i, j, p = best_span(s, e, ev, max_len=max_span_len,
                                    span_pred=pred0)
            if i < 0:
                return None, 0.0
            t = decode_span(ev, i, j).strip()
            if not t or t.lower() in query.lower():
                return None, 0.0
            return t, p
        i, j, prob = best_span(s, e, ev, max_len=max_span_len,
                               span_pred=_base_span_pred(ev))
        text = decode_span(ev, i, j).strip() if i >= 0 else ""
        exp = expected_shape(query) if constrain else None
        if exp is not None and (not text or answer_shape(text) != exp
                                or text.lower() in query.lower()):
            shape_ok = _shape_span_pred(exp, ev.tokens)
            base_ok = _base_span_pred(ev)
            pred = lambda i, j: shape_ok(i, j) and base_ok(i, j)
            i2, j2, p2 = best_span(s, e, ev, max_len=max_span_len,
                                   span_pred=pred)
            if i2 >= 0:
                t2 = decode_span(ev, i2, j2).strip()
                if t2 and t2.lower() not in query.lower():
                    return t2, p2
        if not text:
            return None, 0.0
        # never answer with a span the question already contains
        if text.lower() in query.lower():
            return None, prob
        return text, prob

    def _read_bridged(self, query: str, window: List[str], bridge: str,
                      exp: Optional[str], max_span_len: int = 6,
                      raw_text: Optional[str] = None
                      ) -> Tuple[Optional[str], float, bool]:
        """Second read bound to the bridge entity's paragraph.

        Evidence contexts regularly FIT the reader's window, so re-running
        ``select_evidence`` with the bridge name appended reproduces the
        same window and the same read — the hop must instead change what
        the decoder may point at. This read (a) appends the bridge name
        to the question so the anchor channels light the bridge's own
        paragraph, and (b) restricts the span search to paragraphs whose
        sentences carry the bridge's name tokens. Confidence is
        renormalized over the allowed positions (the global softmax mass
        can sit on the anchor's paragraph, which is exactly what the hop
        is escaping).
        """
        from ahrag_tpu_torch.models.reader.features import (E_LEN, Q_LEN, _norm,
                                                      decode_span, featurize)
        q2 = query + " " + bridge
        fb, ev = featurize(q2, window)
        n = min(len(ev.tokens), E_LEN)
        if n == 0:
            return None, 0.0, False
        s_log, e_log = self._apply(fb)
        s = np.asarray(s_log)[0, Q_LEN:Q_LEN + n]
        e = np.asarray(e_log)[0, Q_LEN:Q_LEN + n]
        # paragraphs whose sentences carry the bridge's name (its last two
        # tokens — tokenization can merge a preceding capitalized word into
        # the extracted run, the surname tokens still bind correctly)
        btoks = tuple(_norm(t) for t in _TOKEN_RE.findall(bridge))[-2:]
        if not btoks:
            return None, 0.0, False
        norm_toks = [_norm(t) for t in ev.tokens[:n]]
        sent_seq: dict = {}
        for k, t in enumerate(norm_toks):
            sent_seq.setdefault(ev.sent_index[k], []).append(t)
        lb = len(btoks)
        paras = {ev.para_of_sent[sid] for sid, seq in sent_seq.items()
                 if sid < len(ev.para_of_sent)
                 and any(tuple(seq[x:x + lb]) == btoks
                         for x in range(len(seq) - lb + 1))}
        if not paras:
            return None, 0.0, False
        allowed = [k for k in range(n)
                   if ev.sent_index[k] < len(ev.para_of_sent)
                   and ev.para_of_sent[ev.sent_index[k]] in paras]
        if not allowed:
            return None, 0.0, False
        shape_ok = _shape_span_pred(exp, ev.tokens) if exp else None
        base_ok = _base_span_pred(ev)
        q_low = q2.lower()
        s_soft = np.exp(s - s.max());  s_soft /= s_soft.sum()
        e_soft = np.exp(e - e.max());  e_soft /= e_soft.sum()
        zs = max(float(s_soft[allowed].sum()), 1e-9)
        ze = max(float(e_soft[allowed].sum()), 1e-9)
        aset = set(allowed)
        best = None
        for i in allowed:
            jmax = min(n - 1, i + max_span_len - 1)
            for j in range(i, jmax + 1):
                if ev.sent_index[j] != ev.sent_index[i] or j not in aset:
                    break
                if shape_ok is not None and not shape_ok(i, j):
                    continue
                if not base_ok(i, j):
                    continue
                text = decode_span(ev, i, j).strip()
                if not text or text.lower() in q_low:
                    continue
                sc = s[i] + e[j]
                if best is None or sc > best[0]:
                    best = (sc, i, j, text)
        # raw_hopped: the window-1 read already sits inside a bridge-
        # carrying paragraph — it has performed the hop on its own, and
        # the bridged re-decode must not displace it
        raw_hopped = False
        if raw_text:
            rt = tuple(_norm(t) for t in _TOKEN_RE.findall(raw_text))
            lr = len(rt)
            if lr:
                for sid, seq in sent_seq.items():
                    if sid < len(ev.para_of_sent) \
                            and ev.para_of_sent[sid] in paras \
                            and any(tuple(seq[x:x + lr]) == rt
                                    for x in range(len(seq) - lr + 1)):
                        raw_hopped = True
                        break
        if best is None:
            return None, 0.0, raw_hopped
        _, i, j, text = best
        conf = float((s_soft[i] / zs) * (e_soft[j] / ze))
        return text, conf, raw_hopped

    def answer(self, query: str, sentences: List[str],
               max_span_len: int = 6) -> Tuple[Optional[str], float]:
        """(answer text or None, confidence in [0, 1]).

        Two-window bridge mode (VERDICT r4 item 3): when the first read
        returns a NAME span where the question's answer type wants a year,
        or the read is weak, that name is treated as a bridge entity — the
        evidence window is re-selected with the name's tokens added to the
        anchor set (pulling in the bridge entity's own paragraph, which has
        zero lexical overlap with the question and so loses the first
        window's budget contest), and the SAME question is read again over
        the new window. Accepted only on answer-type agreement or a clear
        confidence gain, so a correct first read is never displaced.
        """
        from ahrag_tpu_torch.models.reader.features import E_LEN
        win1 = select_evidence(query, sentences, budget=E_LEN)
        # first window UNCONSTRAINED: a name decode where the question
        # wants a year/noun is the bridge-entity signal, not an error
        text, prob = self._read(query, win1, max_span_len, constrain=False)
        exp = expected_shape(query)
        hop = bool(_HOP_Q.search(query))
        shape1 = answer_shape(text) if text else None

        if exp == "name":
            # who-questions: answers are full names. Re-decode to the best
            # multiword capitalized run when the raw read is not one (the
            # raw argmax lands on orgs/cities/verbs under unseen vocab).
            if (not text or shape1 != "name"
                    or (len(text.split()) == 1 and prob < 0.6)):
                t2, p2 = self._read(query, win1, max_span_len,
                                    force_shape="name2")
                if t2:
                    return t2, p2
            return text, prob

        # bridge candidate: the read itself when it is a multiword name,
        # else the best multiword-capitalized decode of the same logits.
        # Hop questions ("the city of the person who ...") put the answer
        # in the bridge entity's paragraph, which shares nothing with the
        # question — the bridged read binds the decode there. Only hop or
        # shape-mismatched reads bridge: a shape-agreeing non-hop read is
        # the anchor's own attribute and must not be displaced.
        # bridged reads fire on HOP questions only: a non-hop shape
        # mismatch is a decode problem (handled by the constrained
        # re-decode below), and a speculative bridge there binds to an
        # unrelated entity's paragraph more often than it repairs
        use_bridge = hop
        bridge = None
        if use_bridge:
            if shape1 == "name" and len(text.split()) >= 2:
                bridge = text
            else:
                bridge, _ = self._read(query, win1, max_span_len,
                                       force_shape="name2")
        if bridge:
            t2, p2, raw_in_bridge = self._read_bridged(query, win1, bridge,
                                                       exp, max_span_len,
                                                       raw_text=text)
            t2_ok = t2 and (exp is None or answer_shape(t2) == exp)
            if raw_in_bridge and t2_ok:
                # raw came from the bridge's own paragraph: the bridged
                # re-read of the same region (anchor channels lit on the
                # bridge) is strictly better-conditioned — take it
                return t2, p2
            if (text and (exp is None or shape1 == exp)
                    and _raw_hop_valid(win1, query, text)):
                # raw sits in a DIFFERENT paragraph whose entity provably
                # links to the question anchor — the raw read already
                # hopped (possibly via a better bridge than ours)
                return text, prob
            if t2_ok:
                return t2, p2
        if exp is not None and (not text or shape1 != exp):
            # no bridge read: constrained re-decode of the first window
            t3, p3 = self._read(query, win1, max_span_len, constrain=True)
            if t3 and answer_shape(t3) == exp:
                return t3, p3
        return text, prob


def get_reader(ckpt_path: str, min_conf: float = 0.25,
               device=None) -> Optional[ReaderAnswerer]:
    """Cached reader on ``device`` (``cuda`` unless the caller names
    another; the cache keeps the two used last, as the JAX package's does);
    None when no checkpoint is configured (reader off).
    ``ckpt_path`` may be a ``;``-separated ensemble list. A configured
    checkpoint that does not exist raises ``FileNotFoundError``."""
    if not ckpt_path:
        return None
    missing = [p for p in str(ckpt_path).split(";") if p and not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"reader checkpoint(s) not found: {missing}")
    return _cached_reader(str(ckpt_path), float(min_conf), str(resolve_device(device)))


@locked_cache(maxsize=2)
def _cached_reader(ckpt_path: str, min_conf: float, device: str) -> ReaderAnswerer:
    return ReaderAnswerer(ckpt_path, min_conf=min_conf, device=device)
