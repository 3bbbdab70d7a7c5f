"""Extractive answer spotting for the LLM-free answer path.

The port's copy of ``ahrag_tpu/answer/extractive.py``. One difference: the
modeled-relation sort of ``_sentence_tied_hubs`` is not wrapped in a
catch-all, so a failure there raises.

The reference's deterministic fallback pastes evidence snippets into the answer
(generator.py:128-217), which floors F1/EM. This module does better without any
model: type the question (who / when / which-X / where / how-many), collect typed
candidate spans (proper-name runs, years, numbers) from the evidence sentences,
and score them by keyword co-occurrence with the question — minus the spans the
question itself already contains (asking "Who directed Ed Wood?" must not answer
"Ed Wood").

Pure string processing; deterministic; used by AnswerGenerator before its
snippet-synthesis fallback.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"\b[A-Z][a-zA-Z']+(?:\s+(?:of|the|[A-Z][a-zA-Z']+))*\b")
_YEAR_RE = re.compile(r"\b(1[5-9]\d{2}|20\d{2})\b")
_NUM_RE = re.compile(r"\b\d+(?:\.\d+)?\b")
_NUMWORD_RE = re.compile(r"\b(one|two|three|four|five|six|seven|eight|nine|ten|"
                         r"eleven|twelve|twenty|thirty|hundred)\b", re.IGNORECASE)
# split after sentence-final punctuation, including the description-joiner
# form "<snippet>.; <snippet>". A BARE semicolon stays inside its sentence:
# it coordinates clauses that share the discourse topic ("On <Film>, the
# camera answered to X; <second clause about the same film>") — splitting
# there severs the second clause from the film and the fact layer loses it.
_SENT_SPLIT = re.compile(r"(?<=[.!?。])(?:\s*;\s*|\s+)")
_CAP_STOP = {"The", "He", "She", "It", "In", "On", "At", "A", "An", "This", "That",
             "They", "His", "Her", "Its", "After", "Before", "When", "While",
             "During", "From", "For", "With", "And", "But", "Or", "Who", "What",
             "Which", "Where", "Why", "How", "Entity", "Summary", "Relation",
             "Keywords", "Evidence", "Based", "Among", "Since", "Over",
             "Under", "Between", "To", "Of", "By"}
_STOPWORDS = {"the", "a", "an", "of", "in", "on", "at", "to", "for", "by", "from",
              "with", "and", "or", "is", "are", "was", "were", "did", "does", "do",
              "who", "what", "which", "where", "when", "why", "how", "that", "this",
              "it", "its", "their", "his", "her", "as", "be", "been"}


def _question_type(query: str) -> Tuple[str, Optional[str]]:
    """(type, focus-noun) — type in {who, year, number, which, where, general}."""
    ql = query.lower()
    if re.search(r"\bwho\b|\bwhom\b", ql):
        return "who", None
    if re.search(r"\bwhen\b|\bwhat year\b|\bin which year\b|\bwhich year\b", ql):
        return "year", None
    if re.search(r"\bhow (many|much)\b", ql):
        return "number", None
    m = re.search(r"\b(?:which|what)\s+(?:\d+\s+)*([a-z]+)", ql)
    if m and m.group(1) not in _STOPWORDS:
        return "which", m.group(1)
    if re.search(r"\bwhere\b", ql):
        return "where", None
    return "general", None


def _keywords(query: str) -> List[str]:
    return [w for w in re.findall(r"[a-z0-9]+", query.lower())
            if w not in _STOPWORDS and len(w) > 2]


_SKELETON_RE = re.compile(r"^\- \[([^\]]+)\]\s*\([a-z]*\)\s*(.*)$")
_DETAIL_RE = re.compile(r"^\[DETAIL:([^\]]+)\]\s*(.*)$")
_PRONOUN_RE = re.compile(r"^(?:He|She|It|They)\b")
_HEADER_RE = re.compile(r"===\s*([^=]+?)\s*===")
_PROPER_NAME_RE = re.compile(r"^[A-Z][\w.'-]*(?: [A-Z][\w.'-]*)*$")


def _subject_name(raw: Optional[str]) -> Optional[str]:
    """A usable coref subject: a proper name ('Kathryn Bigelow'), possibly with a
    parenthetical dropped ('Ed Wood (film)' -> 'Ed Wood'); topic-word titles
    ('directed / academy / scott') are not subjects."""
    if not raw:
        return None
    name = re.sub(r"\s*\([^)]*\)\s*$", "", raw.strip())
    return name if _PROPER_NAME_RE.match(name) else None


def _clean_sentences(context_text: str) -> List[str]:
    """Evidence text -> plain sentences (strip skeleton/detail markers and ids).

    Evidence excerpts routinely state the decisive fact with a pronoun subject
    ("He directed ...") because the name lives in the section header or the
    block's skeleton entry — fatal for span scoring, which needs name and fact
    in one sentence. Sentence-leading pronouns are resolved to the governing
    subject: the most recent ``=== Section ===`` header inside the block, else
    the block's owning node name (from the ``[DETAIL:<id>]`` / skeleton-line
    mapping) — unless that subject is itself named later in the sentence (then
    the pronoun refers to someone else: "He directed ..., starring <owner>").
    """
    names: dict = {}
    blocks: List[tuple] = []  # (owner_name_or_None, text)
    owner: Optional[str] = None
    cur: List[str] = []

    def flush() -> None:
        if cur:
            blocks.append((owner, " ".join(cur)))
            cur.clear()

    for raw in context_text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SKELETON_RE.match(line)
        if m:
            nid, rest = m.groups()
            name = rest.split("::", 1)[0].strip()
            if name:
                names[nid] = name
            flush()
            owner = name or None  # continuation lines stay owned by this node
            # start the block with the entry text so hard-wrapped continuation
            # lines rejoin their sentence instead of splitting it mid-clause
            cur.append(rest.replace("::", ". "))
            continue
        m = _DETAIL_RE.match(line)
        if m:
            flush()
            owner = names.get(m.group(1))
            if m.group(2):
                cur.append(m.group(2).replace("::", ". "))
            continue
        line = re.sub(r"^\[KEEP:[^\]]*\]\s*", "", line)
        line = line.replace("::", ". ")
        if line.strip():
            cur.append(line.strip())
    flush()

    out: List[str] = []
    for block_owner, text in blocks:
        if out and out[-1] != "":
            # block-boundary sentinel: consecutive sentences in the flattened
            # list can come from DIFFERENT evidence blocks (different source
            # paragraphs) — topic-continuity inheritance across the seam
            # fabricates facts (a subject-less location sentence from one org
            # inheriting another org's subject). extract_facts resets its
            # running subject on the empty string.
            out.append("")
        # section headers switch the governing subject within the block
        subject = _subject_name(block_owner)
        parts = _HEADER_RE.split(text)  # [text, header, text, header, text...]
        for i, part in enumerate(parts):
            if i % 2 == 1:  # header
                subject = _subject_name(part) or subject
                continue
            for s in _SENT_SPLIT.split(part):
                s = s.strip()
                if not s:
                    continue
                # summary bodies concatenate MEMBER snippets under lowercase
                # slash-joined topic-title prefixes. The prefix is a
                # member-boundary seam: the sentences after it come from a
                # DIFFERENT source paragraph than the ones before, so the
                # running subject must reset or a subject-less snippet
                # inherits the wrong owner (observed: one org's location
                # sentence attributed to another org).
                tm = re.match(r"^[;,]?\s*([a-z][\w'-]*(?: / [a-z][\w'-]*)+)"
                              r"\s*:\s*(.*)$", s)
                if tm:
                    out.append("")
                    s = tm.group(2).strip()
                    if not s:
                        continue
                # only resolve into COMPLETE sentences — substituting into a
                # brief truncated mid-clause ("He directed ..., which starred")
                # fabricates facts about the subject
                if (subject and s[-1] in ".!?。"
                        and subject.lower() not in s.lower()):
                    s = _PRONOUN_RE.sub(subject, s)
                out.append(s)
    return out


def _name_spans(sentence: str) -> List[str]:
    spans = []
    for m in _NAME_RE.finditer(sentence):
        span = m.group(0).strip()
        words = span.split()
        while words and words[0] in _CAP_STOP:
            words = words[1:]
        while words and words[-1].lower() in {"of", "the"}:
            words = words[:-1]
        if not words:
            continue
        span = " ".join(words)
        # possessive marker is question/sentence syntax, not part of the name
        span = re.sub(r"'s$", "", span)
        if span and span not in spans:
            spans.append(span)
    return spans


_VERB_HINTS = {"won", "wins", "stars", "made"}


def _question_verbs(keywords: List[str]) -> List[str]:
    """Verb-ish question keywords ('directed', 'attended', 'won', ...)."""
    return [k for k in keywords if k.endswith("ed") or k in _VERB_HINTS]


def _agent_signal(span_l: str, s_lower: str, verbs: List[str]) -> float:
    """Verb-argument structure for who-questions: '<verb> by <span>' and
    '<span> <verb>' mark the agent; 'as ... <span>' marks a role apposition
    (an object complement, not the asked-for agent). Positive = agent evidence."""
    signal = 0.0
    for verb in verbs:
        if f"{verb} by {span_l}" in s_lower:
            signal += 2.5
        if f"{span_l} {verb}" in s_lower:
            signal += 1.5
    pos = s_lower.find(span_l)
    if pos > 0:
        preceding = s_lower[max(0, pos - 40):pos]
        if re.search(r"\bas (a |an |the )?[a-z ]*$", preceding):
            signal -= 2.0
    return signal


def _bridged_answer(query: str, sentences: List[str],
                    keywords: List[str]) -> Optional[str]:
    """Second-hop apposition answer for questions whose focus noun never
    appears in the evidence ("Which <focus> does the <role> of E ...?").

    When the asked-for category word is absent from every sentence, the
    answer is a common noun standing in apposition to a BRIDGE name: one
    sentence ties the question's entities/keywords to a person or org (the
    hub), another sentence ties the hub to the answer noun. Candidates are
    scored structurally — hub support (how strongly the hub's sentences tie
    back to the question), cross-paragraph rarity (template boilerplate
    repeats across paragraphs, facts don't), and apposition position (the
    noun phrase after a/an/of/as/the) — no relation vocabulary involved,
    so this generalizes to unseen schemas by construction.
    """
    ql = query.lower()
    q_ents = [e.lower() for e in _name_spans(query)]
    # When no question entity is the SUBJECT of the question's verb, the
    # question asks about someone RELATED to E, not E itself ("the <role>
    # of E", "E's <role>", "the <role> E is <verb>ed for") — the answer
    # apposition then attaches to a bridge name in a sentence AWAY from E,
    # and candidates co-occurring with E describe E (the wrong thing).
    # E is subject-ish when an auxiliary immediately precedes it ("does E
    # <verb>") or the question opens with it.
    two_hop = bool(q_ents) and not any(
        re.search(r"\b(?:does|did|do|is|was|are|were|has|have)\s+(?:the\s+)?"
                  + re.escape(e), ql) or ql.startswith(e)
        for e in q_ents)
    # paragraph structure: the "" sentinels in the cleaned sentence list
    # mark paragraph seams (same convention as the reader's novelty
    # features)
    paras = _split_paras(sentences)

    # hub support: names outside the question, from sentences — or
    # paragraphs, at a discount: the bridge statement and the name it
    # honors are routinely adjacent sentences of one paragraph — tied to
    # the question. Multi-word spans only: single capitalized words in a
    # matching sentence are mostly places/adjectives/sentence-initial
    # words, and a junk hub leaks every sentence it appears in into the
    # candidate pool.
    hub_support: Dict[str, float] = {}

    def tie(text_l: str) -> float:
        ov = sum(1 for k in keywords if k in text_l)
        ent = sum(1 for e in q_ents if e in text_l)
        return ov + 2.0 * ent

    for para in paras:
        para_sc = tie(" ".join(para).lower())
        for s in para:
            sc = max(tie(s.lower()), 0.8 * para_sc)
            if sc <= 0:
                continue
            for span in _name_spans(s):
                pl = span.lower()
                if pl in ql or " " not in pl:
                    continue
                hub_support[pl] = max(hub_support.get(pl, 0.0), sc)
    if not two_hop:
        for e in q_ents:  # 1-hop: the question's own entities are hubs too
            if len(e) >= 4:
                hub_support[e] = max(hub_support.get(e, 0.0), 2.0)
    if not hub_support:
        return None

    # 1-hop questions about an entity present in the evidence: the answer
    # apposition must sit in that entity's own sentences — a rare noun next
    # to some OTHER supported name describes that name instead
    ent_present = any(e in s.lower() for e in q_ents for s in sentences)

    para_tokens = [set(re.findall(r"[a-z][a-z'-]{3,}", " ".join(p).lower()))
                   for p in paras]
    n_paras = max(1, len(para_tokens))
    word_df: Dict[str, int] = {}
    for p in para_tokens:
        for w in p:
            word_df[w] = word_df.get(w, 0) + 1

    def rarity(phrase: str) -> float:
        words = phrase.split()
        return min(1.0 - sum(w in p for p in para_tokens) / n_paras
                   for w in words)

    def scaffold(s_l: str, cand: str) -> float:
        # how template-like the candidate's host sentence is: mean paragraph
        # frequency of its content words (candidate excluded). Every
        # paragraph describes its subject with the SAME boilerplate sentence
        # (whose slot filler names a generic attribute of the subject); the
        # asked-for fact of an unmodeled relation lives in a sentence whose
        # scaffold does NOT repeat corpus-wide.
        cand_words = set(cand.split())
        toks = [w for w in re.findall(r"[a-z][a-z'-]{3,}", s_l)
                if w not in cand_words and w not in _STOPWORDS]
        if not toks:
            return 0.0
        return sum(word_df.get(w, 0) for w in toks) / (len(toks) * n_paras)

    best: Optional[Tuple[float, str]] = None
    for s in sentences:
        if not s:
            continue
        sl = s.lower()
        if two_hop and any(e in sl for e in q_ents):
            continue  # sentences about E describe E, not the bridge
        if not two_hop and ent_present and not any(e in sl for e in q_ents):
            continue  # the question subject's own sentences only
        hubs = [h for h in hub_support if h in sl]
        if not hubs:
            continue
        top_hub = max(hubs, key=lambda h: hub_support[h])
        hub_sc = hub_support[top_hub]
        # third-party names in the candidate's sentence mark a RELATIONSHIP
        # statement (successions, attributions) — its nouns describe the
        # relation, not the asked attribute of the subject
        crowd = sum(1 for o in _name_spans(s)
                    if " " in o and o.lower() not in q_ents
                    and o.lower() != top_hub)
        # match on the ORIGINAL casing: the answer is a common noun, and a
        # capitalized word at the match site is a proper noun, not one
        for m in re.finditer(
                r"\b(a|an|of|as|the|The)\s+([a-z][a-z'-]{3,}"
                r"(?:\s+[a-z][a-z'-]{3,})?)\b", s):
            for cand in {m.group(2), m.group(2).split()[0]}:
                if any(w in _STOPWORDS or w in ql for w in cand.split()):
                    continue
                if any(cand in h for h in hubs):
                    continue
                r = rarity(cand)
                if r < 0.5:   # boilerplate: appears in most paragraphs
                    continue
                pos = 1.0 if m.group(1) in ("a", "an") else 0.7
                # object position: the word right before the candidate
                # (through articles/prepositions) is a question keyword —
                # the noun governed by the question's own verb beats a
                # name-adjacent apposition describing the subject
                om = re.search(r"(\w+)\s+(?:(?:the|a|an|in|at|on|of)\s+)*"
                               + re.escape(cand), sl)
                obj = (1.5 if om and om.group(1).isalpha()
                       and any(om.group(1).startswith(k[:6])
                               for k in keywords) else 0.0)
                sc = (hub_sc + 2.0 * r + pos + obj + 0.1 * len(cand.split())
                      - 2.0 * scaffold(sl, cand) - 0.8 * crowd)
                if best is None or sc > best[0]:
                    best = (sc, cand)
    return best[1] if best else None


_DESC_DET = re.compile(
    r"\bthe\s+[a-z][\w'-]+\s+(?:who\b|that\b|of\b|"
    r"[a-z]+(?:ed|wn)\s+(?:to|for|in|by|after|as)\b|"
    # reduced relative with an embedded name ("the <noun> <Name> is
    # <participle> for ...") — case is lost here, so the name is any
    # token run up to the copula
    r"[\w' ]{0,40}?\bis\s+[a-z]+(?:ed|wn)\s+(?:for|after|to|by)\b)")


def _split_paras(sentences: List[str]) -> List[List[str]]:
    """Group the cleaned sentence list by its "" block-seam sentinels."""
    paras: List[List[str]] = [[]]
    for s in sentences:
        if s == "":
            if paras[-1]:
                paras.append([])
            continue
        paras[-1].append(s)
    if not paras[-1]:
        paras.pop()
    return paras


def _hub_support(query: str, sentences: List[str],
                 keywords: List[str]) -> List[Tuple[str, float]]:
    """Names tied to the question by co-occurrence, strongest first.

    Multi-word names outside the question, scored by how strongly their
    sentence (or paragraph, discounted) ties back to the question's entities
    and keyword stems. Crowded sentences are discounted per third-party
    name — a sentence naming several outsiders is a listing, not the
    dedicated two-party statement a relational question points at."""
    ql = query.lower()
    q_ents_l = [e.lower() for e in _name_spans(query)]
    paras = _split_paras(sentences)
    if not paras:
        return []

    def matches(k: str, text_l: str, words) -> bool:
        # stemmed word-prefix match: the surface vocabulary is paraphrased
        # between question and evidence, but shared stems still tie
        stem = k[:4]
        return k in text_l or (len(k) >= 4
                               and any(w.startswith(stem) and
                                       (w.startswith(k[:5]) or len(k) <= 5
                                        or k.startswith(w[:5]))
                                       for w in words))

    # scarcity weighting: a keyword found in most paragraphs ("years",
    # "world") ties everything to everything — the question's SCARCE words
    # are what point at its target (observed: an entity-free birth-year
    # question ranking every person with an "early years" sentence level
    # with the one person tied by the question's rare anchor noun)
    kw_weight: Dict[str, float] = {}
    for k in keywords:
        df = sum(1 for p in paras
                 if matches(k, " ".join(p).lower(),
                            set(re.findall(r"[a-z][a-z'-]+",
                                           " ".join(p).lower()))))
        kw_weight[k] = 1.0 if df <= 2 else 2.0 / df

    def tie(text_l: str) -> float:
        words = set(re.findall(r"[a-z][a-z'-]+", text_l))
        ov = sum(kw_weight[k] for k in keywords if matches(k, text_l, words))
        return ov + 2.0 * sum(1.0 for e in q_ents_l if e in text_l)

    support: Dict[str, float] = {}
    for para in paras:
        para_sc = 0.8 * tie(" ".join(para).lower())
        for s in para:
            sl = s.lower()
            spans = _name_spans(s)
            sc = max(tie(sl), para_sc)
            if sc <= 0:
                continue
            for span in spans:
                pl = span.lower()
                if pl in ql or " " not in pl:
                    continue
                extra = sum(1 for o in spans
                            if " " in o and o.lower() != pl
                            and o.lower() not in q_ents_l)
                hub_sc = sc - 0.3 * extra
                if hub_sc > support.get(span, 0.0):
                    support[span] = hub_sc
    return sorted(support.items(), key=lambda kv: -kv[1])


def _sentence_tied_hubs(hubs: List[str], sentences: List[str],
                        q_ents_l: List[str]) -> List[str]:
    """Hubs named in the same SENTENCE as a question entity.

    Paragraph-level ties admit bystanders: a context block that concatenates
    summary bodies puts every name "in the paragraph" of every entity, and a
    rewrite validated against such a hub fabricates an unrelated person's
    attribute (observed: a home-city question about E's mentor answered with
    a distractor's city because the distractor shared E's context block).
    The dedicated two-party statement a relational question points at names
    both parties in one sentence — or names the hub ALONE in a sentence whose
    anaphoric subject ("The group's moniker...", "Its name...") resolves to
    the entity through the surrounding paragraph."""
    if not q_ents_l:
        return hubs
    tied = []
    for para in _split_paras(sentences):
        para_has_e = any(e in s.lower() for s in para for e in q_ents_l)
        for s in para:
            sl = s.lower()
            direct = any(e in sl for e in q_ents_l)
            for h in hubs:
                hl = h.lower()
                if hl not in sl or h in tied:
                    continue
                if direct:
                    tied.append(h)
                elif para_has_e and not any(
                        " " in n and n.lower() != hl
                        and n.lower() not in q_ents_l
                        for n in _name_spans(s)):
                    tied.append(h)
    ordered = [h for h in hubs if h in tied]
    # Unmodeled ties first: the caller reached here because the typed chain
    # could not answer, so the question's relation is provably unmodeled —
    # the intended bridge is likelier tied to E by a surface the fact tables
    # can NOT parse than by one they already file (a founder/seat question
    # would have been answered from the founder/seat table). Stable within
    # each group, so support order still breaks ties.
    from ahrag_tpu_torch.answer.qa import extract_facts
    facts = extract_facts(sentences)

    def modeled(h: str) -> bool:
        hl = h.lower()
        for k, tab in vars(facts).items():
            if k.startswith("about") or not isinstance(tab, dict):
                continue
            for subj, val in tab.items():
                if subj.lower() not in q_ents_l:
                    continue
                vals = val if isinstance(val, list) else [val]
                if any(isinstance(v, str) and v.lower() == hl
                       for v in vals):
                    return True
        return False
    ordered.sort(key=modeled)
    return ordered


def _second_hop_rewrite(query: str, sentences: List[str]) -> Optional[str]:
    """Resolve a described subject to its NAME by co-occurrence and re-ask.

    A question whose subject is a definite description ("the <noun> of E",
    "the <noun> who <clause about E>") points at someone the evidence names
    but the question does not. The hop needs no relation vocabulary: the
    description's anchor — the question's entities, or its scarcest content
    word — co-occurs with the target name somewhere in the evidence, so the
    tied names are the hub candidates. Substituting a hub for the description
    span yields a one-hop question the typed fact chain already answers; the
    split boundaries are unknown, so every candidate split is tried and
    validated by whether the chain accepts it (a mis-bounded rewrite parses
    to nothing, and a type check blocks wrong-shaped answers). This is the
    schema-free counterpart of the reference LLM's multi-hop reading
    (reference answer/generator.py:100)."""
    ql = query.lower()
    if not _DESC_DET.search(ql):
        return None
    from ahrag_tpu_torch.answer.qa import answer_from_facts
    q_ents_l = [e.lower() for e in _name_spans(query)]
    keywords = _keywords(query)
    qtype, _ = _question_type(query)

    ranked = _hub_support(query, sentences, keywords)
    # with entities in the question, hubs must tie through an entity
    # co-occurrence — verified STRUCTURALLY by _sentence_tied_hubs (same
    # sentence as E, or an anaphoric sentence in E's paragraph), not by a
    # raw support cut: a held-out-relation question shares no vocabulary
    # with the evidence, so a tied hub's score can legitimately sit below
    # any fixed threshold. Keyword-support floors remain for entity-free
    # descriptions, where co-occurrence with the anchor is the only tie.
    # Fabrication stays blocked: with E absent from the evidence no hub
    # ties at all (the abstention families).
    pool = [h for h, sc in ranked if (q_ents_l or sc >= 1.0)]
    hubs = _sentence_tied_hubs(pool, sentences, q_ents_l)

    # the anchor marks which "the <noun> ..." phrase is the description: the
    # question's entity words, or (entity-free descriptions) the scarcest
    # question keyword the evidence actually contains
    anchor = {w for e in q_ents_l for w in e.split()}
    if not anchor:
        ev_l = " ".join(sentences).lower()
        first_the = ql.find("the ")
        # only keywords inside the description region (after its leading
        # determiner) can anchor it — a frame verb before any "the" matches
        # no description span and would veto every split
        present = [k for k in keywords
                   if k in ev_l and first_the >= 0 and ql.find(k) > first_the]
        if present:
            anchor = {min(present, key=ev_l.count)}
        # entity-free descriptions resolve through the anchor: a hub that
        # never shares a paragraph with it is tied by frame vocabulary, and
        # validating a rewrite against such a hub reads an unrelated
        # person's attribute (observed: a birth-year question about "the
        # player of the <rare noun>" answering with whichever person a
        # common question verb happened to tie at equal support)
        if anchor:
            paras = _split_paras(sentences)
            hubs = [h for h in hubs
                    if any(all(a in " ".join(p).lower() for a in anchor)
                           and h.lower() in " ".join(p).lower()
                           for p in paras)]
    if not anchor:
        return None
    hubs = hubs[:3]
    if not hubs:
        return None

    toks = query.split()
    tried = 0
    for hub in hubs:
        for i, t in enumerate(toks[:-1]):
            if t.lower() != "the" or not toks[i + 1][:1].islower():
                continue
            for j in range(i + 2, min(i + 13, len(toks)) + 1):
                desc_l = " ".join(toks[i:j]).lower()
                if not any(a in desc_l for a in anchor):
                    continue
                rw = " ".join(toks[:i] + [hub] + toks[j:])
                if not rw.endswith("?"):
                    rw += "?"
                tried += 1
                if tried > 48:
                    return None
                ans = answer_from_facts(rw, sentences)
                if not ans:
                    continue
                al = ans.lower()
                if al == hub.lower() or al in ql:
                    continue
                if qtype == "year" and not _YEAR_RE.fullmatch(ans):
                    continue
                if qtype == "who" and not ans[:1].isupper():
                    continue
                return ans
    return None


def _rare_slot_noun(query: str, sentences: List[str]) -> Optional[str]:
    """Category questions whose category word never surfaces in the evidence.

    "Which <category> does E ...?" where no evidence word shares the
    category's stem has ZERO lexical bridge — span scoring is blind and the
    typed chain has no table. The distributional signal that remains: the
    corpus renders attributes through repeated sentence frames, so in E's own
    single-name sentences the FRAME words recur across paragraphs while the
    slot value is rare. Answer = the paragraph-rarest content word of E's
    dedicated sentences, preferring determiner-marked slot positions
    ("... the <answer>") and, among ties, the sentence with the fewest other
    rare words (a dedicated short attribute statement over a rich narrative
    one). Purely distributional — no category vocabulary is consulted, so
    unmodeled relation families stay in scope (the schema-freedom the
    reference buys with an LLM, generator.py:100)."""
    ql = query.lower()
    qtype, cat = _question_type(query)
    ev_l = " ".join(sentences).lower()
    # only open-category "which <noun>" intents: year/who/number/where
    # questions have typed answers the chain and span scorer already model
    if qtype != "which" or not cat or len(cat) < 4 or re.search(
            r"\b" + re.escape(cat[:5]), ev_l):
        return None
    ent = next((e for e in _name_spans(query) if e.lower() in ev_l), None)
    if ent is None:
        return None
    el = ent.lower()
    from ahrag_tpu_torch.answer.qa import extract_facts
    facts = extract_facts(sentences)
    explained: set = set()
    for k, tab in vars(facts).items():
        if k.startswith("about") or not isinstance(tab, dict):
            continue
        for subj, val in tab.items():
            if el in subj.lower() or subj.lower() in el:
                for v in (val if isinstance(val, list) else [val]):
                    if isinstance(v, str):
                        explained.update(v.lower().split())
    paras = _split_paras(sentences)
    qwords = set(re.findall(r"[a-z']+", ql))
    best: Optional[Tuple[int, int, int, str]] = None
    for s in sentences:
        sl = s.lower()
        if el not in sl:
            continue
        names = _name_spans(s)
        if any(" " in n and el not in n.lower() for n in names):
            continue        # E shares the sentence with another party
        capwords = {w.lower() for n in names for w in n.split()}
        cands = []
        for w in set(re.findall(r"\b[a-z][a-z-]{3,}\b", sl)):
            if w in qwords or w in explained or w in capwords:
                continue
            df = sum(1 for p in paras if w in " ".join(p).lower())
            slot = 0 if re.search(r"\bthe\s+(?:[a-z-]+\s+)?" + re.escape(w),
                                  sl) else 1
            cands.append((df, slot, w))
        rare = sum(1 for df, _sl, _w in cands if df <= 1)
        for df, slot, w in cands:
            key = (df, slot, rare, w)
            if best is None or key < best:
                best = key
    # only a genuinely rare slot answers; a min-df of 3+ means every word of
    # E's sentences is frame vocabulary — nothing to point at
    return best[3] if best is not None and best[0] <= 2 else None


def bridge_hop_targets(query: str, sentences: List[str]) -> List[str]:
    """Schema-free second-hop retrieval hints (agent/inference.py hook).

    The typed hook (qa.py::missing_entities) proposes follow-up entities only
    for relations its fact tables model; a described-subject question over an
    UNMODELED relation ("the person who mentored E", "the figure E is named
    after") gets no hop, and the bridge person's own paragraph — where the
    asked attribute lives — is never retrieved. This is the schema-free
    complement: when the question is description-shaped, or names an entity
    that is not its grammatical subject, propose the evidence names most
    strongly tied to the question by co-occurrence (the same hub machinery
    the answerer's 2-hop passes use), so the engine can fetch their
    paragraphs. Returns nothing when the fact chain already answers."""
    from ahrag_tpu_torch.answer.qa import answer_from_facts
    ql = query.lower()
    q_ents = [e.lower() for e in _name_spans(query)]
    two_hop = bool(q_ents) and not any(
        re.search(r"\b(?:does|did|do|is|was|are|were|has|have)\s+(?:the\s+)?"
                  + re.escape(e), ql) or ql.startswith(e)
        for e in q_ents)
    if not (_DESC_DET.search(ql) or two_hop):
        return []
    ans = answer_from_facts(query, sentences)
    if ans is not None:
        if not two_hop:
            return []
        # Wrong-person fallback detection: the chain's subject resolution
        # falls back to the question's own named entity when it cannot
        # resolve the description — and then reads E's OWN attribute. That
        # answer is attested only in sentences that mention E and name
        # nobody else; a genuine bridge answer is attested either away from
        # E (the bridge's own paragraph) or next to another name (an
        # apposition introducing the bridge). Only the suspect case keeps
        # proposing hops.
        al = ans.lower()
        alone = beside = False
        for s in sentences:
            sl = s.lower()
            if al not in sl or not any(e in sl for e in q_ents):
                continue            # the chain reads subject-anchored
                                    # sentences; others are distractors
            if any(" " in n and n.lower() not in q_ents
                   for n in _name_spans(s)):
                beside = True       # apposition: the bridge may be named
            else:
                alone = True        # E's own attribute, nobody else named
        if beside or not alone:
            return []
    ranked = _hub_support(query, sentences, _keywords(query))
    # entity questions: structural tie check replaces the support cut (see
    # _second_hop_rewrite — zero-vocabulary-overlap questions score low)
    pool = [h for h, sc in ranked if (q_ents or sc >= 1.0)]
    return _sentence_tied_hubs(pool, sentences, q_ents)[:3]


def extract_answer(query: str, context_text: str,
                   allow_span_scoring: bool = True,
                   reader=None, reader_only: bool = False) -> Optional[str]:
    """Best typed answer span from the evidence, or None when nothing scores.

    Tries the typed fact-KB chain first (answer/qa.py — handles paraphrased
    relation vocabulary and one-hop bridge questions structurally), then the
    learned span reader when one is supplied (answer/reader.py — the
    schema-free path for relations the fact tables don't know), then falls
    back to span scoring. ``allow_span_scoring=False`` stops after the fact
    chain — used for comparison questions, where a scored name span can never
    be the (yes/no) answer."""
    from ahrag_tpu_torch.answer.qa import (_CREATOR_CUES, _STAR_CUES,
                                           answer_from_facts, unanswerable)
    sentences = _clean_sentences(context_text)
    if reader_only:
        # measurement mode (VERDICT r4 item 3): the learned reader IS the
        # whole read path — no fact chain, no rewrites, no span scoring.
        if reader is None:
            return None
        ans, conf = reader.answer(query, sentences)
        return ans if ans and conf >= reader.min_conf else None
    # described-subject questions with an UNMODELED relation (no creator/star
    # cue) and an entity that is not the grammatical subject: the fact
    # chain's subject resolution falls back to E and answers E's OWN
    # attribute — the wrong person. The co-occurrence rewrite (validated by
    # the same chain) is the higher-precision path, so it goes first; when
    # the description's relation IS modeled, the chain's nested-hop
    # resolution knows the relation and keeps precedence.
    ql0 = query.lower()
    q_ents0 = [e.lower() for e in _name_spans(query)]
    desc_unmodeled = bool(
        allow_span_scoring and _DESC_DET.search(ql0)
        and not any(c in ql0 for c in _STAR_CUES + _CREATOR_CUES)
        and (not q_ents0 or not any(
            re.search(r"\b(?:does|did|do|is|was|are|were|has|have)\s+"
                      r"(?:the\s+)?" + re.escape(e), ql0)
            or ql0.startswith(e) for e in q_ents0)))
    if desc_unmodeled:
        second = _second_hop_rewrite(query, sentences)
        if second:
            return second
    fact_answer = answer_from_facts(query, sentences)
    if fact_answer:
        return fact_answer
    # abstention precedes span scoring: when every named entity is absent
    # from the evidence, any scored span is a distractor artifact — saying so
    # beats a confident wrong answer (squad_v2 no-answer behavior)
    if unanswerable(query, sentences):
        return "unanswerable"
    if not allow_span_scoring:
        return None
    # described-subject resolution for the modeled-cue case the early pass
    # skipped: when the chain's nested hop ALSO failed, the co-occurrence
    # rewrite is still worth one try before span scoring
    if not desc_unmodeled and _DESC_DET.search(ql0):
        second = _second_hop_rewrite(query, sentences)
        if second:
            return second
    # learned reader, two thresholds: above hi_conf it pre-empts span
    # scoring (it is reading the evidence, the scorer is pattern-matching);
    # between min_conf and hi_conf it only answers when span scoring finds
    # nothing — so a mildly-confident read can never displace a span the
    # scorer already supports, it can only fill a blank.
    reader_ans: Optional[str] = None
    reader_conf = 0.0
    if reader is not None:
        reader_ans, reader_conf = reader.answer(query, sentences)
        hi = (reader.hi_conf_for(reader_ans) if reader_ans
              and hasattr(reader, "hi_conf_for")
              else getattr(reader, "hi_conf", 0.6))
        if reader_ans and reader_conf >= hi:
            return reader_ans
        if reader_ans and reader_conf < reader.min_conf:
            reader_ans = None
    # category question with no lexical bridge at all: span scoring is blind
    # (nothing shares the category's stem), so the distributional rare-slot
    # read outranks it
    rare = _rare_slot_noun(query, sentences)
    if rare:
        return rare
    qtype, focus = _question_type(query)
    keywords = _keywords(query)
    if not keywords:
        return reader_ans
    query_lower = query.lower()
    verbs = _question_verbs(keywords)
    # (tier, tie, score): tier 1 = the span sits in the agent position of a
    # question verb with decent keyword support — such candidates dominate plain
    # keyword co-occurrence (which is fooled by role appositions and distractors).
    # Among tier-1 candidates keyword overlap dominates pattern strength, so a
    # distractor sharing only the verb can't beat the sentence about the asked
    # entity.
    best: Tuple[int, float, float, str] | None = None

    # proper-name spans the question itself contains: sentences about the
    # asked entity stay candidates for place questions even when the question
    # paraphrases every relation word — it still names the org, and the org's
    # own sentences are where the place lives
    q_entities = [s.lower() for s in _name_spans(query)]

    for sentence in sentences:
        s_lower = sentence.lower()
        overlap = sum(1 for k in keywords if k in s_lower)
        if overlap == 0:
            if qtype in ("where", "which") and any(e in s_lower
                                                  for e in q_entities):
                overlap = 1  # entity-anchored sentence
            else:
                continue
        if qtype == "year":
            cands = _YEAR_RE.findall(sentence)
        elif qtype == "number":
            # spelled-out counts answer how-many at least as often as digits
            cands = _NUM_RE.findall(sentence) + _NUMWORD_RE.findall(sentence)
        else:
            cands = _name_spans(sentence)
        for span in cands:
            span_l = span.lower()
            if span_l in query_lower:
                continue  # the question already contains it
            score = float(overlap)
            tier = 0
            # keyword proximity: among same-sentence candidates the span
            # adjacent to the matched keywords wins ("<S> carries the leading
            # role" must answer S, not the name 40 chars upstream) — a generic
            # locality cue, no relation vocabulary involved
            spos_prox = s_lower.find(span_l)
            if spos_prox >= 0:
                dists = [abs(spos_prox - s_lower.find(k))
                         for k in keywords if k in s_lower]
                if dists and min(dists) <= 40:
                    score += 1.0 - min(dists) / 80.0
            if qtype == "which" and focus:
                # 'Which <focus> ...' — candidates tied to the focus noun (in
                # the span or its sentence) dominate ones that merely share
                # keywords ('Which Marvel film...' must not answer a person)
                if focus in span_l:
                    score += 2.0
                    tier = 1
                elif focus in s_lower:
                    tier = 1
                    # appositive proximity: "...superhero film Doctor Strange"
                    # names the focus immediately before the span
                    fpos = s_lower.find(focus)
                    spos = s_lower.find(span_l)
                    if 0 <= spos - fpos <= len(focus) + 20:
                        score += 1.5
                else:
                    score -= 0.5
            if qtype != "who":  # who has its own verb-argument logic below
                # object position: the word right before the span (through
                # articles/prepositions) is a question keyword — "attended
                # Duke University", "born in 1966", "received two Academy..."
                m = re.search(r"(\w+)\s+(?:(?:the|a|an|in|at|on|of)\s+)*"
                              + re.escape(span_l), s_lower)
                if (m and m.group(1).isalpha()  # content word, not a number
                        and any(m.group(1).startswith(k[:6]) for k in keywords)):
                    score += 1.5
            if qtype == "number" and _YEAR_RE.fullmatch(span):
                score -= 1.0  # a year is rarely the answer to "how many"
            if qtype == "who":
                if " " in span:  # prefer multi-word proper names
                    score += 0.5
                from ahrag_tpu_torch.answer.qa import _org_shaped
                if _org_shaped(span):
                    # a who-question asks for a person; an org-headed name
                    # got here through incidental keyword overlap
                    score -= 2.5
                if (span.startswith(("The ", "A ", "An "))
                        or f"the {span_l}" in s_lower
                        or f"an {span_l}" in s_lower):
                    # a who-question asks for a person; determiner-led spans
                    # are titles/works, not people (generic shape cue; the
                    # span extractor strips the leading article, so check the
                    # sentence context too)
                    score -= 2.5
                if any(k in span_l.split() for k in keywords):
                    # a span built from the question's own words names the
                    # thing asked ABOUT, not the person asked FOR ("Best
                    # Picture" for a Best-Director question)
                    score -= 1.5
                signal = _agent_signal(span_l, s_lower, verbs)
                score += signal
                # tier dominance only for the question's MAIN verb (the first:
                # "Who directed the film that starred X" asks about directing;
                # an agent of the relative-clause verb is not the answer)
                if (verbs and overlap >= 2
                        and _agent_signal(span_l, s_lower, verbs[:1]) > 0):
                    tier = 1
            # light penalty for spans made of generic words
            if all(w.lower() in _STOPWORDS for w in span.split()):
                continue
            tie = float(overlap) if tier == 1 else -1.0
            # final tie-break: longer span ('Doctor Strange' over a 'Doctor'
            # fragment from a truncated brief)
            key = (tier, tie, score, len(span))
            if best is None or key > best[:4]:
                best = (tier, tie, score, len(span), span)
    # bridged apposition pass — ONLY when the question's own category word
    # is absent from the evidence (pass-1's focus machinery had nothing to
    # anchor on, so a name answer is a co-occurrence artifact) or the
    # question asks for a manner/occupation shape no name span can answer
    if ((qtype == "which" and focus
         and not any(focus in s.lower() for s in sentences))
            or (qtype == "general"
                and re.match(r"\s*how\s+(does|did|do|is|was|are|were)\b",
                             query_lower))):
        bridged = _bridged_answer(query, sentences, keywords)
        if bridged:
            return bridged
    if best and best[2] >= 2.0:
        return best[4]
    # who-questions with NO keyword-supported span: the asked relation's
    # vocabulary never surfaces in the evidence (unmodeled paraphrase), but
    # the answer is a person tied to the question's entity by co-occurrence —
    # the strongest hub, preferred person-shaped, wins when it has a clear
    # margin over the runner-up (a coin-flip between associates abstains
    # instead)
    if qtype == "who" and q_entities:
        from ahrag_tpu_torch.answer.qa import _looks_like_person, _org_shaped
        ranked = [(h, sc) for h, sc in
                  _hub_support(query, sentences, keywords) if sc >= 2.0]
        people = [hv for hv in ranked
                  if _looks_like_person(hv[0]) and not _org_shaped(hv[0])]
        pool = people or ranked
        if pool and (len(pool) == 1 or pool[0][1] >= pool[1][1] + 0.3):
            return pool[0][0]
    return reader_ans
