"""Host-side featurization for the span reader.

The port's copy of ``ahrag_tpu/models/reader/features.py``, unchanged but
for its imports: its arrays equal the JAX package's bit for bit.

Turns (question, evidence sentences) into fixed-shape arrays the flax
model consumes. Everything here is deliberately RELATION-AGNOSTIC: token
identity is hashed (same FNV-1a as the corpus featurizer, native
parity), and the scalar channels describe structure — answer-type cues
(capitalization, year/number shape), question overlap (exact and
stem-level), sentence-level anchor hits, within-paragraph novelty — not
any particular relation's vocabulary. The model must therefore learn how
questions point at facts, not which facts exist.

Evidence arrives as the plain sentence list produced by
answer/extractive.py::_clean_sentences (pronouns resolved, "" sentinels
at paragraph seams), so the reader reads exactly what the rule-based
extractor reads.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ahrag_tpu_torch.models.encoder.hashed import _fnv1a

# static shapes: one compiled program serves every question
Q_LEN = 32
E_LEN = 320
SEQ_LEN = Q_LEN + E_LEN
# 14 -> 18 in round 5: determiner-adjacency, sentence-final position, and
# paragraph-level anchor/overlap channels. The first two give the model a
# syntax cue that survives UNSEEN vocabulary (diag: v4 answered with unknown
# VERBS — 'keeps', 'picked' — because an untrained hashed id carries no
# category; "follows a determiner" does). The paragraph channels let hop
# questions restrict to the anchor's paragraph even when the answer sentence
# itself shares no token with the question.
# 18 -> 20 late round 5: prepositional-object channels. Biography prose
# attaches the ANSWER as a preposition's object ("the craft of
# <profession>", "the stewardship of the <instrument>", "passed in
# <city>") while the verb/abstract noun before it is an unseen hash
# bucket — the round-5 diag showed the reader picking that noun instead.
# "follows of(-det)" and "follows a locational prep" are vocabulary-free
# syntax cues that survive the shift.
N_SCALARS = 20
WORD_VOCAB = 32768
STEM_VOCAB = 16384
_DETS = {"the", "a", "an", "its", "his", "her", "their"}
_LOC_PREPS = {"in", "at", "from", "near", "on"}

_TOKEN_RE = re.compile(r"[A-Za-z0-9][\w']*")
_YEAR_RE = re.compile(r"^(1[5-9]\d{2}|20\d{2})$")
_NUM_RE = re.compile(r"^\d+(?:\.\d+)?$")
_STOP = {"the", "a", "an", "of", "in", "on", "at", "to", "for", "by", "from",
         "with", "and", "or", "is", "are", "was", "were", "did", "does", "do",
         "who", "whom", "what", "which", "where", "when", "why", "how", "that",
         "this", "it", "its", "their", "his", "her", "as", "be", "been", "s",
         "they", "them", "he", "she", "after", "before", "since", "over",
         "under", "between"}


def _norm(tok: str) -> str:
    """Match/identity normalization: fold possessives onto their noun.

    The tokenizer keeps "Novak's" as one token; without folding, an
    anchor mention via possessive ("Rosa Novak's early years") never
    matches the question's "Rosa Novak" in any overlap/anchor channel —
    a systematic miss in exactly the sentences biographies use most.
    Decode surfaces keep the raw token; only matching and hashed
    identity use the folded form.
    """
    low = tok.lower()
    if low.endswith("'s"):
        return low[:-2]
    if low.endswith("'"):
        return low[:-1]
    return low


def _word_id(tok: str) -> int:
    return _fnv1a(_norm(tok).encode()) % WORD_VOCAB


def _stem_id(tok: str) -> int:
    return _fnv1a(("st:" + _norm(tok)[:4]).encode()) % STEM_VOCAB


class FeatureBatch(NamedTuple):
    word_ids: np.ndarray   # [B, SEQ] int32
    stem_ids: np.ndarray   # [B, SEQ] int32
    scalars: np.ndarray    # [B, SEQ, N_SCALARS] f32
    segments: np.ndarray   # [B, SEQ] int32 (0 question, 1 evidence)
    mask: np.ndarray       # [B, SEQ] bool (real tokens)
    ev_mask: np.ndarray    # [B, SEQ] bool (evidence tokens only — span domain)


class TokenizedEvidence(NamedTuple):
    """Evidence token metadata kept host-side for span decoding."""
    tokens: List[str]
    sent_index: List[int]    # sentence id per token
    sentences: List[str]     # raw sentence text per sentence id
    para_of_sent: List[int]  # paragraph id per sentence id


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


def tokenize_evidence(sentences: List[str]) -> TokenizedEvidence:
    """Flatten the sentence list (with "" paragraph sentinels) into tokens.

    Sentence ids advance per sentence; paragraph seams (the "" entries)
    are kept as metadata via a fresh sentence id so the novelty features
    below can reason per paragraph.
    """
    toks: List[str] = []
    sent_of: List[int] = []
    sents: List[str] = []
    para_of_sent: List[int] = []
    para = 0
    for s in sentences:
        if s == "":
            para += 1
            continue
        sid = len(sents)
        sents.append(s)
        para_of_sent.append(para)
        for t in _tokenize(s):
            if len(toks) >= E_LEN:
                break
            toks.append(t)
            sent_of.append(sid)
    return TokenizedEvidence(toks, sent_of, sents, para_of_sent)


def _content(tokens: List[str]) -> List[str]:
    return [t.lower() for t in tokens if t.lower() not in _STOP and len(t) > 2]


def featurize(question: str, sentences: List[str],
              ev: Optional[TokenizedEvidence] = None
              ) -> Tuple[FeatureBatch, TokenizedEvidence]:
    """One (question, evidence) instance -> [1, SEQ] arrays + decode metadata."""
    q_toks = _tokenize(question)[:Q_LEN]
    if ev is None:
        ev = tokenize_evidence(sentences)
    e_toks, sent_of, sents = ev.tokens, ev.sent_index, ev.sentences
    para_of_sent = ev.para_of_sent or [0] * len(sents)

    q_low = {_norm(t) for t in q_toks}
    q_stems = {_norm(t)[:4] for t in q_toks if _norm(t) not in _STOP}
    q_content = {_norm(t) for t in q_toks
                 if _norm(t) not in _STOP and len(t) > 2}
    q_caps = {_norm(t) for t in q_toks if t[:1].isupper()}
    # FULL multiword anchors: contiguous capitalized runs of the question
    # (>= 2 tokens). Individual cap tokens are ambiguous when a corpus
    # reuses name parts across people ("Dmitri Ustinov" / "Elena Ustinov" /
    # "Dmitri Fontaine") — the full-sequence match is the channel that
    # distinguishes the asked entity's sentences from its name-sharers'.
    q_anchors: List[Tuple[str, ...]] = []
    run: List[str] = []
    for t in q_toks:
        if t[:1].isupper():
            run.append(_norm(t))
        else:
            if len(run) >= 2:
                q_anchors.append(tuple(run))
            run = []
    if len(run) >= 2:
        q_anchors.append(tuple(run))

    # per-sentence aggregates
    sent_toks: Dict[int, List[str]] = {}
    for t, sid in zip(e_toks, sent_of):
        sent_toks.setdefault(sid, []).append(t)
    sent_overlap = {}
    sent_anchor = {}
    sent_full_anchor = {}
    for sid, stoks in sent_toks.items():
        low = {_norm(t) for t in stoks}
        stems = {_norm(t)[:4] for t in stoks}
        if q_content:
            hit = sum(1 for w in q_content if w in low or w[:4] in stems)
            sent_overlap[sid] = hit / len(q_content)
        else:
            sent_overlap[sid] = 0.0
        if q_caps:
            sent_anchor[sid] = sum(1 for w in q_caps if w in low) / len(q_caps)
        else:
            sent_anchor[sid] = 0.0
        if q_anchors:
            slow = [_norm(t) for t in stoks]
            full = 0
            for a in q_anchors:
                la = len(a)
                if any(tuple(slow[i:i + la]) == a
                       for i in range(len(slow) - la + 1)):
                    full += 1
            sent_full_anchor[sid] = full / len(q_anchors)
        else:
            sent_full_anchor[sid] = 0.0

    # token-level: inside an occurrence of a full multiword anchor
    in_anchor = [False] * len(e_toks)
    if q_anchors:
        e_low_seq = [_norm(t) for t in e_toks]
        for a in q_anchors:
            la = len(a)
            for i in range(len(e_low_seq) - la + 1):
                if (tuple(e_low_seq[i:i + la]) == a
                        and sent_of[i] == sent_of[i + la - 1]):
                    for j in range(i, i + la):
                        in_anchor[j] = True

    # novelty: how often does each content token recur across PARAGRAPHS —
    # boilerplate (template) sentences repeat, appended facts don't
    df: Dict[str, set] = {}
    for t, sid in zip(e_toks, sent_of):
        lw = _norm(t)
        if lw not in _STOP:
            df.setdefault(lw, set()).add(para_of_sent[sid]
                                         if sid < len(para_of_sent) else 0)
    n_paras = max(1, len(set(para_of_sent))) if para_of_sent else 1
    sent_rarity = {}
    for sid, stoks in sent_toks.items():
        c = [_norm(t) for t in stoks if _norm(t) not in _STOP]
        if c:
            sent_rarity[sid] = 1.0 - float(
                np.mean([len(df.get(w, ())) for w in c])) / n_paras
        else:
            sent_rarity[sid] = 0.0

    # paragraph-level aggregates: the best sentence-level overlap / full-
    # anchor hit anywhere in each paragraph (hop questions name an anchor in
    # one sentence and the answer sits in a SIBLING sentence with no overlap)
    para_overlap: Dict[int, float] = {}
    para_full_anchor: Dict[int, float] = {}
    for sid in sent_toks:
        p = para_of_sent[sid] if sid < len(para_of_sent) else 0
        para_overlap[p] = max(para_overlap.get(p, 0.0),
                              sent_overlap.get(sid, 0.0))
        para_full_anchor[p] = max(para_full_anchor.get(p, 0.0),
                                  sent_full_anchor.get(sid, 0.0))

    word_ids = np.zeros((1, SEQ_LEN), np.int32)
    stem_ids = np.zeros((1, SEQ_LEN), np.int32)
    scalars = np.zeros((1, SEQ_LEN, N_SCALARS), np.float32)
    segments = np.zeros((1, SEQ_LEN), np.int32)
    mask = np.zeros((1, SEQ_LEN), bool)
    ev_mask = np.zeros((1, SEQ_LEN), bool)

    e_low = {_norm(t) for t in e_toks}
    for i, t in enumerate(q_toks):
        lw = _norm(t)
        word_ids[0, i] = _word_id(t)
        stem_ids[0, i] = _stem_id(t)
        mask[0, i] = True
        scalars[0, i] = [
            float(t[:1].isupper()), float(bool(_YEAR_RE.match(t))),
            float(bool(_NUM_RE.match(t))), float(lw in _STOP),
            float(lw in e_low), 0.0, 0.0, 0.0, 0.0,
            min(i, 31) / 31.0, float(i == 0), 0.0,
            0.0, float(any(lw in a for a in q_anchors)),
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        ]

    pos_in_sent = 0
    prev_sid = -1
    for j, (t, sid) in enumerate(zip(e_toks, sent_of)):
        i = Q_LEN + j
        lw = _norm(t)
        pos_in_sent = 0 if sid != prev_sid else pos_in_sent + 1
        prev_sid = sid
        word_ids[0, i] = _word_id(t)
        stem_ids[0, i] = _stem_id(t)
        segments[0, i] = 1
        mask[0, i] = True
        ev_mask[0, i] = True
        para = para_of_sent[sid] if sid < len(para_of_sent) else 0
        # sentence index within its paragraph (appended facts sit late)
        first_sid_of_para = next((s for s, p in enumerate(para_of_sent)
                                  if p == para), sid)
        prev_det = (j > 0 and sent_of[j - 1] == sid
                    and _norm(e_toks[j - 1]) in _DETS)
        last_of_sent = (j + 1 >= len(e_toks) or sent_of[j + 1] != sid)
        # prep-object: previous token (skipping one determiner) is "of" /
        # a locational preposition, within the same sentence
        k = j - 1
        if k >= 0 and sent_of[k] == sid and _norm(e_toks[k]) in _DETS:
            k -= 1
        prev_prep = (_norm(e_toks[k]) if k >= 0 and sent_of[k] == sid
                     else "")
        of_obj = float(prev_prep == "of")
        loc_obj = float(prev_prep in _LOC_PREPS)
        scalars[0, i] = [
            float(t[:1].isupper()), float(bool(_YEAR_RE.match(t))),
            float(bool(_NUM_RE.match(t))), float(lw in _STOP),
            float(lw in q_low), float(lw[:4] in q_stems),
            sent_overlap.get(sid, 0.0), sent_anchor.get(sid, 0.0),
            min(sid - first_sid_of_para, 7) / 7.0,
            min(pos_in_sent, 31) / 31.0, float(pos_in_sent == 0),
            sent_rarity.get(sid, 0.0),
            sent_full_anchor.get(sid, 0.0), float(in_anchor[j]),
            float(prev_det), float(last_of_sent),
            para_overlap.get(para, 0.0), para_full_anchor.get(para, 0.0),
            of_obj, loc_obj,
        ]

    return FeatureBatch(word_ids, stem_ids, scalars, segments, mask,
                        ev_mask), ev


def stack(batches: List[FeatureBatch]) -> FeatureBatch:
    return FeatureBatch(*[np.concatenate([getattr(b, f) for b in batches])
                          for f in FeatureBatch._fields])


def decode_span(ev: TokenizedEvidence, start: int, end: int) -> str:
    """Token positions (evidence-relative) -> answer text.

    Joins the raw tokens; multiword proper spans keep their casing. The
    span is clamped to one sentence by the decoder that picks (start,
    end), so a plain space join reconstructs the surface form (the
    corpus tokenizer only drops punctuation).
    """
    toks = ev.tokens[start:end + 1]
    return " ".join(toks)


def best_span(start_logits: np.ndarray, end_logits: np.ndarray,
              ev: TokenizedEvidence, max_len: int = 6,
              span_pred=None) -> Tuple[int, int, float]:
    """Highest start+end pair within one sentence, span length <= max_len.

    Returns (start, end, prob) with prob = joint softmax probability —
    the caller's abstention signal. ``span_pred(i, j) -> bool``, when
    given, restricts the search to spans it accepts (shape-constrained
    decode, answer/reader.py); returns (-1, -1, 0.0) if no span passes.
    """
    n = min(len(ev.tokens), E_LEN)
    if n == 0:
        return (-1, -1, 0.0) if span_pred is not None else (0, 0, 0.0)
    s = start_logits[:n]
    e = end_logits[:n]
    s_soft = np.exp(s - s.max());  s_soft /= s_soft.sum()
    e_soft = np.exp(e - e.max());  e_soft /= e_soft.sum()
    best = (-1, -1, -np.inf)
    for i in range(n):
        jmax = min(n - 1, i + max_len - 1)
        for j in range(i, jmax + 1):
            if ev.sent_index[j] != ev.sent_index[i]:
                break
            if span_pred is not None and not span_pred(i, j):
                continue
            score = s[i] + e[j]
            if score > best[2]:
                best = (i, j, score)
    i, j, _ = best
    if i < 0:
        return (-1, -1, 0.0) if span_pred is not None else (0, 0, 0.0)
    return i, j, float(s_soft[i] * e_soft[j])
