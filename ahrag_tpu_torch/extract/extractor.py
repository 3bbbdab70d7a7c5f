"""LLM-prompted N-ary knowledge hypergraph extraction.

The port's copy of ``ahrag_tpu/extract/extractor.py``. Its parses go through
``utils/parse.py`` and the schema's validator (which returns None where
pydantic raises), and the model is asked through ``chat_or_none``, so no
handler catches anything here.

Capability parity with the reference extractor (extract/hypergraph_extractor.py:
10-336): max 8 extractions per chunk over a controlled 8-type entity set, with

- multi-strategy JSON recovery for malformed LLM output: fenced block, outermost
  braces, ``"extractions"`` array slice, brace-depth object salvage, and regex
  partial-object stitching (:100-187,:311-323);
- confidence coercion (numbers, numeric strings, zh 高/中/低 -> 9/6/3, default 6)
  and clamping to [1, 10];
- post-processing: entity-type normalization via alias table + keyword heuristics,
  source-snippet enrichment of descriptions, truncation to 160 chars;
- deterministic regex/capitalization fallback extraction when the LLM is disabled
  or fails, so the whole build pipeline runs offline.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from ahrag_tpu_torch.schema import (CANONICAL_ENTITY_TYPES, Entity, ExtractionResponse,
                                    HypergraphExtraction)
from ahrag_tpu_torch.utils.llm import LLMModule, get_llm_manager
from ahrag_tpu_torch.utils.parse import float_or_none, json_or_none

TYPE_ALIASES: Dict[str, str] = {
    **{a: "person" for a in ("human", "individual", "artist", "actor", "director",
                             "author")},
    **{a: "organization" for a in ("company", "agency", "institution", "team",
                                   "studio")},
    **{a: "position" for a in ("role", "office", "title", "job", "occupation")},
    **{a: "location" for a in ("place", "city", "country", "region", "state",
                               "province", "neighborhood")},
    **{a: "event" for a in ("conference", "war", "summit", "ceremony")},
    **{a: "work" for a in ("film", "movie", "book", "novel", "song", "album",
                           "series")},
    **{a: "concept" for a in ("idea", "theory", "technology", "process")},
    **{a: "date" for a in ("year", "time", "era")},
}

_TYPE_KEYWORDS = [
    ("position", (" governor", "president", "minister", "protocol", "ambassador",
                  "chief", "captain")),
    ("organization", (" university", " company", " studio", " society", " committee",
                      " agency", " government", " department", " network")),
    ("location", (" city", " village", " town", " district", " county", " province",
                  " state", " country", " mosque", " mansion", " valley", " river")),
    ("work", (" film", " movie", " novel", " book", " series", " drama", " song",
              " album", " comic")),
    ("event", (" battle", " summit", " war", " ceremony", " festival")),
    ("person", (" born", " died", " 19", " 20", " century", " 18")),
    ("concept", (" theory", " concept", " system", " process", " technology")),
]

_SENT_SPLIT = re.compile(r"(?<=[。！？.!?])\s+")
_NAME_RE = re.compile(r"(?:[A-Z][a-z]+(?:\s+[A-Z][a-z]+)+|[A-Z][a-z]+)")
_HDR_SPLIT = re.compile(r"(===\s*[^=\n]+?\s*===)")
_HDR_RE = re.compile(r"===\s*([^=\n]+?)\s*===")
_SENT_PRONOUN = re.compile(r"(^\s*|(?<=[.!?。])\s+)(?:He|She)\b")
_SENT_PRONOUN_IT = re.compile(r"(^\s*|(?<=[.!?。])\s+)(?:He|She|It|They)\b")
_PROPER_NAME_RE = re.compile(r"^[A-Z][\w.'-]*(?: [A-Z][\w.'-]*)*$")
# generic English organization head nouns: a section title ending in one is an
# organization, not a person (determiner-less org names are otherwise
# person-shaped — "Riverbend Guild" vs "Katya Cervantes")
_ORG_NOUNS = {"Institute", "Collective", "Foundation", "Consortium", "Guild",
              "Society", "Laboratory", "Observatory", "Company", "Corporation",
              "Group", "Association", "Agency", "Bureau", "Council", "Union",
              "League", "Trust", "Commission", "Committee", "University",
              "College", "Museum", "Library", "Orchestra", "Studios",
              "Syndicate", "Alliance", "Atelier", "Cooperative"}


def resolve_section_pronouns(text: str) -> str:
    """Resolve sentence-leading pronouns to the enclosing ``=== Section ===``
    subject. Wiki-style source documents state most facts with a pronoun
    subject ("He directed ..."), so without this the extracted snippets,
    descriptions, and summaries — and everything embedded from them — never
    tie the fact to the name. He/She always resolve (the section title names a
    person). It/They resolve only when the header carries a parenthetical
    qualifier ('Doctor Strange (film)') — there 'It' means the titled work;
    in a person's section 'It' refers to some mid-section mention, and
    substituting the subject would fabricate facts."""
    parts = _HDR_SPLIT.split(text)
    subject: Optional[str] = None
    pronoun_re = _SENT_PRONOUN
    out: List[str] = []
    for part in parts:
        m = _HDR_RE.fullmatch(part.strip())
        if m:
            raw = m.group(1).strip()
            cand = re.sub(r"\s*\([^)]*\)\s*$", "", raw)
            if _PROPER_NAME_RE.match(cand):
                subject = cand
                pronoun_re = (_SENT_PRONOUN_IT if cand != raw  # had parenthetical
                              else _SENT_PRONOUN)
            out.append(part)
            continue
        if subject:
            subj = subject
            part = pronoun_re.sub(lambda mm: mm.group(1) + subj, part)
            # definite-NP anaphora: "The film stars X." inside a section whose
            # opening sentence typed the subject as a film/org refers to the
            # section subject — without resolution the fact's hyperedge never
            # links to the titled entity (breaks downstream fact chaining)
            kind_m = re.search(
                rf"{re.escape(subj)} (?:is|was) an? [^.!?]*?"
                rf"\b(film|movie|picture|documentary|organization|organisation|"
                rf"company|institute|foundation|consortium|guild|society|"
                rf"laboratory|collective|observatory|band)\b", part)
            if kind_m:
                kind = kind_m.group(1)
                generic = (r"(?:film|movie|picture|story)" if kind in
                           ("film", "movie", "picture", "documentary")
                           else r"(?:organization|organisation|company|group)")
                part = re.sub(
                    rf"(^\s*|(?<=[.!?。])\s+)The {generic}\b",
                    lambda mm: mm.group(1) + subj, part)
            # possessive anaphora: in a WORK section (determiner-led title), a
            # sentence-internal "its" denotes the section subject. Resolving
            # writes the title INTO fact sentences that otherwise never name
            # it ("X fronts the ensemble, and its narrative is anchored in
            # C") — downstream, entity summaries are built from sentences
            # that MENTION the entity, so without this the star<->work
            # pairing survives only through paragraph adjacency, which
            # evidence assembly destroys. Person sections are excluded (a
            # person's "its" refers to some mid-section object); org sections
            # too — org facts chain through the seat/founder patterns, and
            # rewriting "maintains its seat" measurably corrupted the org
            # mention-order prior on interleaved evidence.
            if subj.split()[0] in ("The", "A", "An"):
                pieces = re.split(r"(?<=[.!?。])\s+", part)
                for pi, piece in enumerate(pieces):
                    if subj not in piece:
                        pieces[pi] = re.sub(r"\bits\b", subj + "'s", piece)
                part = " ".join(pieces)
        out.append(part)
    return "".join(out)
# single capitalized words that are sentence-starters, not entities
_CAP_STOPWORDS = {"The", "He", "She", "It", "In", "On", "At", "A", "An", "This",
                  "That", "They", "His", "Her", "Its", "After", "Before", "When",
                  "While", "During", "From", "For", "With", "And", "But", "Or",
                  "Among", "Between", "Across", "Upon", "Within", "Near",
                  "Beyond", "Amid", "Throughout", "Toward", "Towards",
                  "Despite", "Although", "Though", "Since", "Until",
                  "However", "Meanwhile", "Moreover", "Today", "There", "Here",
                  "To", "Of", "Off", "Over", "Under", "Out", "Into", "Onto",
                  "Above", "Below", "Along", "Behind", "Beside", "Beneath",
                  "Against", "Via", "Per", "As", "By", "If", "So", "Yet",
                  "Not", "No", "Now", "Then", "Thus", "Also", "Once", "Soon"}
_PARTIAL_RE = re.compile(
    r"\{\s*\"hyperedge\"[\s\S]*?\}\s*(?=,\s*\{\s*\"hyperedge\"|\s*\]\s*\}|$)")

PROMPT_TEMPLATE = """\
You are a precision JSON generator. Read the TEXT and return EXACTLY one JSON object.
Do NOT add commentary, code fences, or explanations.

RULES
- At most 8 extractions; each describes one atomic fact/event.
- Each extraction has: hyperedge (short verb phrase), relation_type (CamelCase),
  entities (objects with keys ["name", "type", "description"]), confidence_score (1-10).
- Entity type must be one of: person, organization, position, location, work, event,
  concept, date. Pick the closest if unsure.
- Descriptions consolidate the key attributes stated in the text (nationality, role,
  dates, numbers, aliases, relationships); keep them under 160 characters.
- If the text states a person's nationality/citizenship, include it verbatim in the
  description. If it states an official title, capture it in a position entity.
- Cover distinct facts; do not repeat near-identical statements.
- When one surface form has several facets (a person vs. a same-named film), emit
  separate typed entities.

Return JSON of the exact shape {{"extractions": [...]}}.

TEXT:
{text_chunk}
"""


def coerce_confidence(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        mapping = {"高": 9.0, "中": 6.0, "低": 3.0}
        s = v.strip()
        if s in mapping:
            return mapping[s]
        f = float_or_none(s)
        return 6.0 if f is None else f
    return 6.0


def salvage_objects(text: str) -> List[dict]:
    """Extract balanced top-level {...} objects from arbitrary text."""
    objs: List[dict] = []
    buf: List[str] = []
    depth = 0
    for ch in text:
        if ch == "{":
            depth += 1
        if depth > 0:
            buf.append(ch)
        if ch == "}":
            depth -= 1
            if depth == 0 and buf:
                obj = json_or_none("".join(buf))
                if isinstance(obj, dict):
                    objs.append(obj)
                buf = []
    return objs


class HypergraphExtractor:
    def __init__(self, granularity: str = "fine") -> None:
        self.granularity = granularity

    # ---------------------------------------------------------------- public
    def extract(self, text_chunk: str) -> List[HypergraphExtraction]:
        text_chunk = resolve_section_pronouns(text_chunk)
        mgr = get_llm_manager()
        if not mgr.is_enabled(LLMModule.KNOWLEDGE_EXTRACTION):
            return self.fallback_extract(text_chunk)
        raw = mgr.chat_or_none(LLMModule.KNOWLEDGE_EXTRACTION,
                               [{"role": "user",
                                 "content": PROMPT_TEMPLATE.format(text_chunk=text_chunk)}],
                               max_tokens=2000)
        if not raw:
            return self.fallback_extract(text_chunk)
        parsed = self.parse_response(raw, text_chunk)
        return parsed if parsed else self.fallback_extract(text_chunk)

    # ---------------------------------------------------------------- parsing
    def parse_response(self, raw: str,
                       text_chunk: str = "") -> List[HypergraphExtraction]:
        candidates: List[str] = []
        for m in re.finditer(r"```json\s*([\s\S]*?)```", raw):
            candidates.append(m.group(1))
        l, r = raw.find("{"), raw.rfind("}")
        if 0 <= l < r:
            candidates.append(raw[l:r + 1])
        ex_pos = raw.find('"extractions"')
        if ex_pos != -1:
            lb, rb = raw.find("[", ex_pos), raw.rfind("]")
            if 0 <= lb < rb:
                candidates.append('{"extractions": ' + raw[lb:rb + 1] + "}")

        for cand in candidates:
            out = self._try_candidate(cand, text_chunk)
            if out:
                return out[:8]
        return []

    def _try_candidate(self, cand: str,
                       text_chunk: str) -> Optional[List[HypergraphExtraction]]:
        data = json_or_none(cand)
        if isinstance(data, dict) and isinstance(data.get("extractions"), list):
            return self._validate(data["extractions"], text_chunk)
        objs = salvage_objects(cand)
        if objs:
            out = self._validate(objs, text_chunk)
            if out:
                return out
        matches = _PARTIAL_RE.findall(cand)
        if matches:
            data = json_or_none('{"extractions": [' + ",".join(matches) + "]}")
            return None if data is None else self._validate(data["extractions"], text_chunk)
        return None

    def _validate(self, items: List[dict],
                  text_chunk: str) -> Optional[List[HypergraphExtraction]]:
        for it in items:
            if isinstance(it, dict) and "confidence_score" in it:
                it["confidence_score"] = coerce_confidence(it["confidence_score"])
            elif isinstance(it, dict):
                it["confidence_score"] = 6.0
        resp = ExtractionResponse.model_validate({"extractions": items})
        if resp is None:
            return None
        return self.postprocess(resp.extractions, text_chunk)

    # ----------------------------------------------------------- postprocess
    def postprocess(self, extractions: List[HypergraphExtraction],
                    text_chunk: str) -> List[HypergraphExtraction]:
        context_lower = text_chunk.lower()
        for ex in extractions:
            ex.confidence_score = max(1.0, min(10.0, float(ex.confidence_score or 6.0)))
            normalized: List[Entity] = []
            for ent in ex.entities:
                ent_type = self.normalize_entity_type(ent.type, ent.name,
                                                      ent.description, context_lower)
                desc = (ent.description or "").strip()
                snippet = self._snippet(ent.name, text_chunk)
                if desc:
                    candidate = (f"{desc} | {snippet}"
                                 if snippet and snippet.lower() not in desc.lower()
                                 else desc)
                else:
                    candidate = snippet or desc
                if len(candidate) > 160:
                    candidate = candidate[:157] + "..."
                normalized.append(Entity(name=ent.name.strip(), type=ent_type,
                                         description=candidate))
            ex.entities = normalized
        return extractions

    def normalize_entity_type(self, raw_type: Optional[str], name: str,
                              description: Optional[str], context_lower: str) -> str:
        candidate = (raw_type or "").strip().lower()
        if candidate in CANONICAL_ENTITY_TYPES:
            return candidate
        if candidate in TYPE_ALIASES:
            return TYPE_ALIASES[candidate]
        text = f"{name} {(description or '')}".lower()
        name_s = name.strip()
        # structural name-shape priors (English, no relation vocabulary):
        # a determiner-led multiword TitleCase name ("The Thundering Tides")
        # is a WORK, never a person/event — keyword cues like " war" or a
        # year in its description otherwise misroute it (observed: films
        # typed event/person, which starves the picker's work routing); a
        # determiner-less name ending in an organization head noun
        # ("Juniper Observatory") is an organization.
        det_led = bool(re.match(r"^(?:The|A|An)\s+[A-Z]", name_s))
        if not det_led and " " in name_s and name_s.split()[-1] in _ORG_NOUNS:
            return "organization"
        for canonical, kws in _TYPE_KEYWORDS:
            if det_led and canonical in ("person", "event"):
                continue
            if any(k in text for k in kws):
                return canonical
        if re.fullmatch(r"\d{4}", name_s):
            return "date"
        if det_led and " " in name_s:
            return "work"
        if "person" in context_lower or name.istitle():
            return "person"
        return "concept"

    def _snippet(self, name: str, text_chunk: str) -> str:
        pattern = re.compile(r"[^.!?。]*" + re.escape(name) + r"[^.!?。]*(?:[.!?。]|$)",
                             re.IGNORECASE)
        m = pattern.search(text_chunk)
        if m:
            return m.group(0).strip()[:160]
        idx = text_chunk.lower().find(name.lower())
        if idx != -1:
            return text_chunk[max(0, idx - 80): idx + 120].strip()[:160]
        return text_chunk[:160].strip()

    # -------------------------------------------------------------- fallback
    def fallback_extract(self, text_chunk: str) -> List[HypergraphExtraction]:
        """Deterministic capitalization-based extraction (LLM-free path).

        Deviation from the reference fallback (hypergraph_extractor.py:214-264):
        **section topicality** — every sentence inside a ``=== Section ===``
        block predicates on the section subject even when it refers to it only
        coreferentially ("<Star> fronts the ensemble, and its narrative ..."),
        so the subject joins each sentence's extraction as a participant. This
        keeps a paragraph's facts reachable from its titled entity in the graph
        (and in that entity's merged description/embedding); without it, a fact
        sentence that never names the title is connected to it by nothing.
        """
        out: List[HypergraphExtraction] = []
        sections: List[tuple] = []  # (subject_or_None, section_text)
        subject: Optional[str] = None
        for part in _HDR_SPLIT.split(text_chunk):
            m = _HDR_RE.fullmatch(part.strip())
            if m:
                cand = re.sub(r"\s*\([^)]*\)\s*$", "", m.group(1).strip())
                subject = cand if _PROPER_NAME_RE.match(cand) else None
                continue
            if part.strip():
                sections.append((subject, part))
        if not sections:
            sections = [(None, text_chunk)]
        for subject, section_text in sections:
            subj_type = (self.normalize_entity_type(
                None, subject, section_text, section_text.lower())
                if subject else None)
            for sent in (s.strip() for s in _SENT_SPLIT.split(section_text)
                         if s.strip()):
                names: List[str] = []
                seen: set[str] = set()
                for m in _NAME_RE.findall(sent):
                    # strip leading sentence-starter prepositions/conjunctions
                    # from multiword spans ("On The Wandering Observatory" is
                    # the film "The Wandering Observatory" — keeping the
                    # preposition forks a duplicate entity node); determiners
                    # (The/A/An) are legitimate title heads and stay
                    words = m.split()
                    while (len(words) > 1 and words[0] in _CAP_STOPWORDS
                           and words[0] not in ("The", "A", "An")):
                        words = words[1:]
                    m = " ".join(words)
                    if " " not in m and (
                            m in _CAP_STOPWORDS
                            # participial adjunct opener: "Hailing from …",
                            # "Turning to …" — an -ing word heading the
                            # sentence with a preposition right after is a
                            # verb form, not a name (toponyms like Beijing
                            # head sentences with a finite verb instead)
                            or (m.endswith("ing") and re.match(
                                rf"{re.escape(m)}\s+(?:from|to|in|at|on|with|"
                                rf"into|through|toward|towards|across|over|"
                                rf"under|out|upon|by)\b", sent))
                            # adverbial opener: "Curiously, …"
                            or (m.endswith("ly")
                                and sent.startswith(m + ","))):
                        continue  # sentence-opener function word, not an entity
                    if m not in seen:
                        seen.add(m)
                        names.append(m)
                if not names:
                    continue
                entities = [Entity(name=n,
                                   type=self.normalize_entity_type(None, n, sent,
                                                                   sent.lower()),
                                   description=sent[:240]) for n in names]
                if subject and not any(
                        subject.lower() in n.lower() or n.lower() in subject.lower()
                        for n in names):
                    entities.append(Entity(name=subject, type=subj_type,
                                           description=sent[:240]))
                out.append(HypergraphExtraction(
                    hyperedge=sent[:240],
                    relation_type=("CoOccurrence" if len(entities) > 1
                                   else "Mention"),
                    entities=entities, confidence_score=5.0))
        if not out:
            out.append(HypergraphExtraction(
                hyperedge=text_chunk[:240], relation_type="DocumentSummary",
                entities=[Entity(name="Document", type="concept",
                                 description=text_chunk[:240])],
                confidence_score=3.0))
        return out
