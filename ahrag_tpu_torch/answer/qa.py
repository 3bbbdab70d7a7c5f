"""Typed fact extraction + question-intent chaining for the LLM-free answer path.

The port's copy of ``ahrag_tpu/answer/qa.py``, unchanged but for its imports:
the same data structures (a set stays a set, a list a list), so it iterates
and answers as the JAX package's does.

The span-scoring spotter (answer/extractive.py) matches question keywords against
evidence sentences — which fails exactly where the reference leaned on an LLM:
paraphrased relation vocabulary ("Who helmed X?" vs corpus "directed by") and
bridge questions whose answer lives two hops from the asked entity ("the home
city of the person who made X"). This module answers those structurally:

1. **Fact extraction**: evidence sentences -> a typed mini-KB via general-English
   surface patterns (``directed by P``, ``stars P``, ``founded by P``,
   ``headquarters ... in C``, ``X is a <Nationality> <profession>``,
   ``born in C in Y``, ``X is a city in C``, ``released in Y``). These are
   ordinary Wikipedia-register constructions, not patterns fit to any dataset.
2. **Intent parsing**: the question is reduced to (attribute, subject-expression)
   using paraphrase cue lexicons (helm/made/behind -> creator; citizenship /
   "which country ... from" -> nationality; "base of operations" -> headquarters;
   "line of work" / "do for a living" -> profession; ...). Subject expressions
   may be nested one hop: (relation, entity) — "the performer who appears in X".
3. **Chaining**: resolve the inner relation against the fact KB, then the outer
   attribute; comparison questions ("do A and B share the same ...") compare
   the attribute across both entities and answer yes/no.

Heuristics were developed against the frozen synth train/dev splits only
(samples/synth_eval_{train,dev}.jsonl); synth test is held out. Reference
parity: this replaces the LLM answer path (reference generator.py:100) in the
deterministic regime; the reference's own fallback (generator.py:128-217) pastes
snippets and floors F1.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

_TITLE_RE = re.compile(r"\b(?:The |A |An )?[A-Z][\w'.-]*(?: (?:of|the|[A-Z][\w'.-]*))*")
_YEAR_RE = re.compile(r"\b(1[5-9]\d{2}|20\d{2})\b")

# words that end a lowercase noun phrase (profession / type descriptor)
_NP_STOP = re.compile(r"\s+(?:who|that|which|and|based|from|known|in|at|with|for)\b")

_FILM_WORDS = ("film", "movie", "picture", "documentary", "feature")
_ORG_WORDS = ("organization", "organisation", "company", "institute", "foundation",
              "consortium", "guild", "society", "laboratory", "collective",
              "observatory", "university", "studio", "band", "agency",
              "bureau", "union", "syndicate", "alliance", "atelier",
              "cooperative", "council", "association", "corporation")


class Facts:
    """Typed mini-KB extracted from evidence sentences."""

    def __init__(self) -> None:
        self.directed_by: Dict[str, str] = {}      # film -> person
        self.stars: Dict[str, List[str]] = {}      # film -> [person]
        self.founded_by: Dict[str, str] = {}       # org -> person
        self.founded_year: Dict[str, str] = {}     # org -> year
        self.hq: Dict[str, str] = {}               # org -> city
        self.city_in: Dict[str, str] = {}          # city -> country
        self.nationality: Dict[str, str] = {}      # person -> adjective
        self.country: Dict[str, str] = {}          # person -> country name
        self.profession: Dict[str, str] = {}       # person -> noun phrase
        self.birth_city: Dict[str, str] = {}       # person -> city
        self.birth_year: Dict[str, str] = {}       # person -> year
        self.released: Dict[str, str] = {}         # film -> year
        self.setting: Dict[str, str] = {}          # film -> city
        self.film_attrs: Dict[str, str] = {}       # film -> descriptor text
        self.about: Dict[str, List[str]] = {}      # subject -> its sentences
        # positions of those sentences in the extraction input — mention
        # tests must be positional: evidence assembly DUPLICATES sentence
        # text across blocks, and a text-membership test would alias every
        # twin of an inherited sentence into the subject's mention set
        self.about_idx: Dict[str, List[int]] = {}  # subject -> sentence idxs

    def films(self) -> set:
        return (set(self.directed_by) | set(self.stars) | set(self.released)
                | set(self.film_attrs))

    def orgs(self) -> set:
        return set(self.founded_by) | set(self.hq) | set(self.founded_year)


def _norm(s: str) -> str:
    s = re.sub(r"\s+", " ", s.strip()).strip(".,;:!? ")
    # possessive clitic: a span ending in 's denotes the bare entity —
    # fact-table keys must not fork on the genitive form
    return re.sub(r"['’]s$", "", s)


# Capitalized sentence-openers that are function words / adverbials, never
# entity names. Closed-class English; marker-token-safe (the only members that
# occur in v2 relation markers — "among", "through" — are whitelisted function
# words in the audit). -ing / -ly leading words are stripped morphologically.
_STOP_HEADS = {
    "The", "A", "An", "On", "At", "In", "To", "By", "Of", "For", "As", "And",
    "But", "Or", "Nor", "So", "Yet", "If", "Since", "Among", "Amid", "Upon",
    "Until", "While", "Where", "When", "Whom", "Whose", "With", "Within",
    "Without", "From", "Between", "Beyond", "Despite", "During", "After",
    "Before", "Above", "Below", "Under", "Over", "Across", "Along", "Around",
    "Behind", "Beneath", "Beside", "Besides", "Through", "Throughout",
    "Toward", "Towards", "Against", "About", "Though", "Although", "Once",
    "Unless", "Because", "However", "Moreover", "Meanwhile", "Instead",
    "Indeed", "Perhaps", "Then", "There", "Here", "This", "That", "These",
    "Those", "It", "Its", "He", "She", "They", "His", "Her", "Their", "Our",
    "Not", "No", "Both", "Each", "Every", "Some", "Any", "All", "Most",
    "Many", "Few", "Several", "Such", "Other", "Another", "One", "Now",
    "Today", "Later", "Earlier", "Eventually", "Finally", "Still", "Thus",
}


def _strip_stop_heads(span: str) -> str:
    """Drop leading capitalized function words / -ing / -ly adverbials from a
    TitleCase span ('Among the' -> '', 'On The Gilded Causeway' -> title).
    'The X' survives when followed by more capitalized words (a title shape).
    The morphological -ing/-ly heuristic applies only when the word HEADS a
    longer span — an adverbial head precedes the name it modifies, while a
    lone capitalized -ly/-ing word mid-sentence is a proper noun (Italy,
    Sicily, Beijing), not an adverb; dropping it severed every
    city->country containment fact for such countries."""
    words = span.split()
    while words:
        w = words[0]
        if w in ("The", "A", "An"):
            # keep determiner-led TITLES: 'The Gilded Causeway'
            if len(words) > 1 and words[1][0:1].isupper():
                break
            words = words[1:]
        elif w in _STOP_HEADS or (len(words) > 1 and
                                  (w.endswith("ing") or w.endswith("ly"))):
            words = words[1:]
        else:
            break
    # trailing of/the fragments from the regex's connector matching
    while words and words[-1] in ("of", "the"):
        words = words[:-1]
    return " ".join(words)


def _subject_of(sentence: str) -> Optional[str]:
    """Leading TitleCase span ('The Gilded Causeway is ...' -> the title),
    with capitalized function-word openers stripped (a sentence opening on a
    fronted adverbial like 'Among the ... of X' has no leading subject)."""
    m = _TITLE_RE.match(sentence)
    if not m:
        return None
    return _strip_stop_heads(_norm(m.group(0))) or None


def _lookup(table: Dict[str, str], key: str) -> Optional[str]:
    """Case-insensitive exact-then-containment lookup."""
    kl = key.lower().strip()
    for k, v in table.items():
        if k.lower() == kl:
            return v
    for k, v in table.items():
        if kl in k.lower() or k.lower() in kl:
            return v
    return None


_GENERIC_SUBJECTS = {"the", "it", "the film", "the movie", "the story", "they",
                     "the organization", "the band", "she", "he", "its"}


def _classify_desc(f: Facts, subj: str, desc: str) -> None:
    """Route a descriptor noun phrase to the subject's typed attribute slots.

    Shared by every descriptor-bearing construction — copular ("X is a D"),
    appositive ("X, a D, ..."), and complement ("X ... as a D") — these are
    general English classification structures, not phrasings of any dataset."""
    desc_head = _NP_STOP.split(desc)[0].strip(" .,;")
    dl = desc_head.lower()
    if any(w in dl for w in _FILM_WORDS):
        # descriptor only — cut relation clauses so description-based
        # lookup never matches on relation verbs ("directed", "stars")
        f.film_attrs[subj] = re.split(
            r"\b(?:directed|starring|starred|stars|released|written|"
            r"produced|set)\b", dl)[0].strip()
        y = _YEAR_RE.search(desc_head)
        if y:
            f.released.setdefault(subj, y.group(0))
    elif re.match(r"^city\b", dl):
        c = re.search(r"city in ([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", desc)
        if c:
            f.city_in[subj] = _norm(c.group(1))
    elif any(w in dl for w in _ORG_WORDS):
        pass  # org facts come from founded/headquarters patterns elsewhere
    else:
        # person descriptor: optional Nationality adjective + profession
        pm = re.match(r"^((?:[A-Z][a-z]+[- ])*)([a-z][a-z -]*[a-z])$",
                      desc_head)
        if pm and _looks_like_person(subj):
            nat = _norm(pm.group(1))
            prof = _norm(pm.group(2))
            if nat:
                f.nationality.setdefault(subj, nat)
            if prof and prof not in ("man", "woman"):
                f.profession.setdefault(subj, prof)


def _org_shaped(name: str) -> bool:
    """Name-shape org test: the head noun of the name IS an org-type word
    ('Harbor Institute', 'University of Bologna'). Value-level vocabulary
    (the words appear inside entity NAMES), not relation markers."""
    words = name.split()
    return bool(words) and (words[-1].lower() in _ORG_WORDS
                            or words[0].lower() in _ORG_WORDS)


def _film_shaped(name: str) -> bool:
    """Determiner-led multiword titles ('The Gilded Causeway') — the common
    English work-title shape. Takes precedence over the org head-noun test in
    ``_classified`` ('The Thundering Observatory' is a title, not an org)."""
    return name.startswith(("The ", "A ", "An ")) and len(name.split()) >= 2


def _classified(f: Facts, name: str) -> str:
    """'' | 'person' | 'film' | 'org' | 'place' — which typed tables know
    ``name``, falling back to name-shape classification (org head nouns,
    determiner-led titles, two/three-word person names, bare single-token
    toponyms)."""
    if name in f.nationality or name in f.profession or name in f.country:
        return "person"
    if (name in f.film_attrs or name in f.directed_by or name in f.stars
            or name in f.setting):
        return "film"
    if name in f.founded_by or name in f.hq or name in f.founded_year:
        return "org"
    if name in f.city_in:
        return "place"
    if _film_shaped(name):
        return "film"
    if _org_shaped(name):
        return "org"
    if _looks_like_person(name):
        return "person"
    if len(name.split()) == 1 and name[0:1].isupper():
        return "place"
    return ""


def _name_spans_before(s: str, pos: int) -> List[str]:
    """TitleCase spans preceding position ``pos``, in order."""
    return [_norm(m.group(0)) for m in _TITLE_RE.finditer(s[:pos])]


def extract_facts(sentences: List[str]) -> Facts:
    f = Facts()
    last_subject: Optional[str] = None
    for si, s in enumerate(sentences):
        if not s.strip():
            # block-boundary sentinel (answer/extractive.py::_clean_sentences):
            # topic continuity must not cross evidence-block seams
            last_subject = None
            continue
        raw_subj = _subject_of(s)
        own_subj = (raw_subj is not None
                    and raw_subj.lower() not in _GENERIC_SUBJECTS)
        # impersonal clause: an expletive/impersonal pronoun in the subject
        # slot ("one <verb>s ...", "there is/are ...") never COREFERS with the
        # running discourse topic — general English, closed-class function
        # words only. Such sentences get NO subject (neither own nor
        # inherited): attributing them to the previous subject fabricates
        # facts when evidence assembly interleaves sentences from different
        # source paragraphs (observed: a city-in-country sentence inheriting
        # an org subject and clobbering the org's seat slot).
        impersonal = (not own_subj and re.search(
            r"\b(?:one\s+[a-z]+s|there\s+(?:is|are|was|were))\b", s))
        if impersonal:
            # the sentence still participates in the textual-mention scans
            # (_order_prior_pass reads the full sentence list) — it only
            # stops carrying a discourse subject
            continue
        # topic continuity: "The film stars X ..." inherits the paragraph's
        # subject ("<Title> is a ... film ...") stated in an earlier sentence
        if own_subj:
            subj = raw_subj
            last_subject = subj
        else:
            # fronted-phrase re-anchoring: a sentence opening on a modifier
            # phrase ("<Adverbial/participial ...>, <Name> ...") predicates on
            # the TitleCase span right after the first comma — that span, not
            # the inherited topic, is the sentence's subject. General fronted-
            # constituent word order; no relation vocabulary.
            subj = last_subject
            if "," in s:
                after = s.split(",", 1)[1].lstrip()
                am = _TITLE_RE.match(after)
                if am:
                    cand = _strip_stop_heads(_norm(am.group(0)))
                    if cand and cand.lower() not in _GENERIC_SUBJECTS:
                        subj = cand
                        last_subject = cand
                        own_subj = True
        if subj:
            f.about.setdefault(subj, []).append(s)
            f.about_idx.setdefault(subj, []).append(si)
        # --- "X is a|an <descriptor>" classification -------------------------
        m = re.search(r"^(.*?)\s+(?:is|was)\s+an?\s+(.*)$", s)
        if m and subj:
            _classify_desc(f, subj, m.group(2))
        # --- appositive classification: "<Name>, a <descriptor>, ..." --------
        for am in re.finditer(r"([A-Z][\w'.-]*(?: (?:of|the|[A-Z][\w'.-]*))*)"
                              r"\s*,\s+an?\s+((?:[A-Z][a-z]+ )*[a-z][a-z -]*"
                              r"[a-z])", s):
            _classify_desc(f, _norm(am.group(1)), am.group(2))
        # --- complement classification: "... as a <descriptor>" --------------
        # attaches to the nearest preceding person-shaped name span (the
        # grammatical agent of the complement)
        for cm in re.finditer(r"\bas an?\s+((?:[A-Z][a-z]+ )*[a-z][a-z -]*"
                              r"[a-z])", s):
            agents = [n for n in _name_spans_before(s, cm.start())
                      if _looks_like_person(n)]
            if agents:
                _classify_desc(f, agents[-1], cm.group(1))
        # --- relation patterns ----------------------------------------------
        m = re.search(r"directed by ([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s)
        if m and subj:
            f.directed_by.setdefault(subj, _norm(m.group(1)))
        # --- agentive 'by'-phrase: '<VP> by <Person>' marks the agent of the
        # sentence's subject (passive/agented constructions generally) — for a
        # work-shaped subject that's its creator, for an org its founder. The
        # preposition carries the structure; no relation verb vocabulary.
        m = re.search(r"\b(?:was|were|is|are|been)\b[^.;]*?\bby\s+"
                      r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s)
        if m and subj:
            agent = _strip_stop_heads(_norm(m.group(1)))
            if _looks_like_person(agent):
                kind0 = _classified(f, subj)
                if kind0 == "film":
                    f.directed_by.setdefault(subj, agent)
                elif kind0 == "org":
                    f.founded_by.setdefault(subj, agent)
        # --- fronted participial origin: '<X>ing from <Place>, <Person> ...'
        # (a fronted participle phrase predicates on the following subject —
        # general English; 'from <Place>' marks origin/country)
        m = re.match(r"^[A-Z][a-z]+ing from ([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)"
                     r"\s*,\s*([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s)
        if m:
            origin = _norm(m.group(1))
            who = _strip_stop_heads(_norm(m.group(2)))
            if _looks_like_person(who) and not _looks_like_person(origin):
                f.country.setdefault(who, origin)
        # --- fronted predicate adjective: '<Adj> <small phrase>, <Person> ...'
        # ('Norwegian by ancestry, X ...') — a fronted apposition predicating
        # the capitalized adjective on the following subject. -ing openers are
        # participles (handled above), not adjectives.
        m = re.match(r"^([A-Z][a-z]+)((?: [a-z]+){1,3})\s*,\s*"
                     r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s)
        if m and not m.group(1).endswith("ing") and m.group(1) not in _STOP_HEADS:
            who = _strip_stop_heads(_norm(m.group(3)))
            if _looks_like_person(who):
                f.nationality.setdefault(who, m.group(1))
        # --- trailing 'of <lowercase NP>' profession complement: a person-
        # subject sentence ending in a light-noun 'of'-complement ('took up
        # the <light noun> of <profession>.') — the NP classifies the person.
        # Attribution: the sentence's own person (its subject, or the first
        # person-shaped span when a fronted phrase displaces the subject).
        m = re.search(r"\bof ([a-z][a-z -]{2,})[.;]?$", s)
        if m:
            who = None
            for cand in (_strip_stop_heads(n)
                         for n in _name_spans_before(s, len(s))):
                if _looks_like_person(cand):
                    who = cand
                    break
            if who is None and subj and _looks_like_person(subj):
                who = subj
            np = _norm(m.group(1))
            if (who and np not in ("man", "woman") and not _YEAR_RE.search(np)
                    and 1 <= len(np.split()) <= 3):
                f.profession.setdefault(who, np)
        for m in re.finditer(r"(?:\bstars|\bstarring|\bstarred)\s+"
                             r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s):
            if subj:
                f.stars.setdefault(subj, []).append(_norm(m.group(1)))
        m = re.search(r"(?:founded|established|created|started) by "
                      r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*?)"
                      r"(?:\s+in\s+(1[5-9]\d{2}|20\d{2}))?[\s.,;]*$", s)
        if m and subj:
            f.founded_by.setdefault(subj, _norm(m.group(1)))
            if m.group(2):
                f.founded_year.setdefault(subj, m.group(2))
        m = re.search(r"(?:headquarters of (.+?) (?:are|is) in|"
                      r"headquartered in|based in)\s+"
                      r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s)
        if m:
            owner = _norm(m.group(1)) if m.group(1) else subj
            if owner:
                f.hq.setdefault(owner, _norm(m.group(2)))
        m = re.search(r"born(?: in ([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*))?"
                      r"(?: in (1[5-9]\d{2}|20\d{2}))?", s)
        if m and subj and (m.group(1) or m.group(2)):
            if m.group(1):
                f.birth_city.setdefault(subj, _norm(m.group(1)))
            if m.group(2):
                f.birth_year.setdefault(subj, m.group(2))
        m = re.search(r"(?:released|premiered|came out) in (1[5-9]\d{2}|20\d{2})", s)
        if m and subj:
            f.released.setdefault(subj, m.group(1))
        m = re.search(r"set in ([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s)
        if m and subj:
            f.setting.setdefault(subj, _norm(m.group(1)))
        # --- type-routed year/place attribution (structural, lexicon-free):
        # the schema has exactly one year slot per type (person -> birth year,
        # film -> release year, org -> founding year), so a bare year routes
        # by the types of the entities around it, with no relation verbs.
        # A work/org mentioned before the year owns it (a person's year in a
        # film/org sentence is that work's date, not their birth — 'X owes
        # its ... to <Person>, who put it in motion in 1984'); a person owns
        # it only in a sentence with no work/org, and their "at/in/to <City>"
        # in the same sentence is the birth place.
        for ym in _YEAR_RE.finditer(s):
            year = ym.group(0)
            spans = [_strip_stop_heads(n)
                     for n in _name_spans_before(s, ym.start())]
            kinds = [(n, _classified(f, n)) for n in spans if n]
            works = [(n, k) for n, k in kinds if k in ("film", "org")]
            if not works and subj and own_subj:
                ks = _classified(f, subj)
                if ks in ("film", "org"):
                    works = [(subj, ks)]
            if works:
                target, kind = works[-1]
                if kind == "film":
                    f.released.setdefault(target, year)
                else:
                    f.founded_year.setdefault(target, year)
                continue
            person = next((n for n, k in kinds if k == "person"), None)
            if person is None and subj and own_subj \
                    and _classified(f, subj) == "person":
                person = subj
            if person is None:
                continue
            f.birth_year.setdefault(person, year)
            # \b before the preposition: without it 'in' matches inside
            # 'Quentin' and the surname becomes the "city"
            pc = re.search(r"\b(?:at|in|to)\s+([A-Z][\w'.-]*"
                           r"(?: [A-Z][\w'.-]*)*)[^.]{0,60}?\bin\s+"
                           + year, s)
            if pc and _norm(pc.group(1)) != person:
                f.birth_city.setdefault(person, _norm(pc.group(1)))
    _order_prior_pass(f, sentences)
    return f


def _content_spans(s: str) -> List[str]:
    """Stop-head-stripped TitleCase spans of a sentence, in order, deduped."""
    out: List[str] = []
    for m in _TITLE_RE.finditer(s):
        sp = _strip_stop_heads(_norm(m.group(0)))
        sp = re.sub(r"'s?$", "", sp)   # possessive: "Canada's" -> "Canada"
        if sp and sp not in out:
            out.append(sp)
    return out


def _order_prior_pass(f: Facts, sentences: List[str]) -> None:
    """Paragraph-level slot attribution by type schema + mention order.

    Encyclopedic lead paragraphs about a work or organization name their
    principal people and places in a conventional order: the creator leads
    (director before cast for films, founder for orgs), and the seat/locale
    closes. For every film/org-shaped paragraph subject, sentences MENTIONING
    it contribute their entity spans; unfilled typed slots are attributed by
    that order (explicit constructions from the first pass always win —
    everything here is setdefault). Single-token place subjects get geographic
    containment: when the sentences mentioning a place name exactly one other
    non-person/org/film span, that span is its containing region. These are
    word-order/type priors of the register, not relation vocabulary — they
    generalize across any phrasing of the same facts.
    """
    cands = list(f.about)
    for s in sentences:
        for sp in _content_spans(s):
            # works/orgs whose paragraph never yields a clean sentence subject
            # (fronted adverbials displace it) still get slot attribution
            if (_org_shaped(sp) or _film_shaped(sp)) and sp not in cands:
                cands.append(sp)
    # cities already filling a seat/birth slot are containment candidates even
    # when their own paragraph never yields a sentence subject (fronted
    # existential constructions) — the org->city->country chain needs them
    for c in list(f.hq.values()) + list(f.birth_city.values()):
        if c and c not in cands:
            cands.append(c)
    adjectives = set(f.nationality.values()) | set(f.country.values())
    person_tables = (f.nationality, f.country, f.profession, f.birth_city,
                     f.birth_year)
    # structural personhood: a '<Name>, who ...' relative clause marks its
    # head span as a person — generic English anaphora, no relation
    # vocabulary. Needed because evidence assembly can REORDER sentences
    # (skeleton briefs precede detail blocks), destroying the paragraph-order
    # prior that normally puts the creator before the seat: a person-shaped
    # toponym ('Porto Alegre') mentioned first would otherwise win persons[0].
    who_persons: set = set()
    for s in sentences:
        for wm in re.finditer(r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)\s*,\s*"
                              r"who(?:m|se)?\b", s):
            who_persons.add(_strip_stop_heads(_norm(wm.group(1))))
    # locative obliques: a span governed by a LOCATIVE preposition anywhere
    # ('in/at/within/near/out of <Span>') is a place argument — it can
    # never fill a person slot (creator/founder/star). Dative/genitive 'to'/
    # 'of' are NOT locative: founders arrive as 'existence to <P>' / 'efforts
    # of <P>'. 'who'-clause evidence overrides (a person CAN follow 'in' in
    # rare frames; a '<Name>, who ...' head is definitely a person). The list
    # is core closed-class prepositions only, audited disjoint from every v2
    # realization marker (tools/audit_synth_disjoint.py — e.g. 'inside' is a
    # city2 marker token and is deliberately absent).
    locative_obliques: set = set()
    for s in sentences:
        for lm in re.finditer(r"\b(?:in|at|within|near|around|out of)\s+"
                              r"([A-Z][\w'.-]*(?: [A-Z][\w'.-]*)*)", s):
            sp = _strip_stop_heads(_norm(lm.group(1)))
            if sp and sp not in who_persons:
                locative_obliques.add(sp)
    subjects = [(s0, _classified(f, s0)) for s0 in cands]
    lowers = [s.lower() for s in sentences]
    # phase 1: film/org slot attribution (fills director/star/founder/seat
    # slots that phase 2's person-vs-toponym discrimination depends on)
    for S, kind in subjects:
        if kind not in ("film", "org") or S in adjectives:
            continue
        sl = S.lower()
        # positional membership only: a text-equality test against
        # f.about[S] would pull in every duplicate of an inherited
        # sentence, letting a twin EARLIER in the document hijack the
        # mention-order prior (evidence blocks repeat sentences verbatim)
        own_idx = set(f.about_idx.get(S, []))
        idxs = [i for i in range(len(sentences))
                if sl in lowers[i] or i in own_idx]
        # lead-credit prior: the sentence where the title is directly
        # followed by its classifying appositive ("<Title>, a <descriptor>")
        # is the work's OWN lead sentence — its persons outrank persons from
        # other mention sentences. Document order alone is not trustworthy:
        # evidence assembly interleaves blocks from many source paragraphs,
        # so a co-star's sentence can precede the credit sentence. Keyed on
        # the extracted appositive structure, not on relation vocabulary.
        idxs.sort(key=lambda i: (sl + ", a" not in lowers[i]))
        ment = [sentences[i] for i in idxs]
        spans: List[str] = []
        for s in ment:
            for sp in _content_spans(s):
                low = sp.lower()
                if low == sl or low in sl or sl in low:
                    continue
                if sp not in spans:
                    spans.append(sp)
        persons = [sp for sp in spans if _looks_like_person(sp)
                   and sp not in locative_obliques]
        # 'who'-clause evidence proves personhood for spans nothing else
        # classifies (a maybe-toponym like 'Porto Alegre' sorts behind a
        # proven person). Among spans ALREADY known to be persons (typed
        # tables: nationality/profession appositives), mention order stands —
        # a who-clause in an unrelated paragraph must not reorder a film's
        # own credit sequence (observed: a star with a founder who-clause
        # elsewhere hijacking the director slot).
        persons.sort(key=lambda p: not (p in who_persons
                                        or _classified(f, p) == "person"))
        if kind == "film":
            if persons:
                f.directed_by.setdefault(S, persons[0])
                rest = [p for p in persons
                        if p.lower() != f.directed_by[S].lower()]
                if rest and S not in f.stars:
                    f.stars[S] = [rest[0]]
            if S not in f.stars:
                # neuter-pronoun continuation: the sentence right after a
                # title mention that keeps referring to it with 'it'/'its'
                # ('<Person> ... , and its <noun> ...') is still about the
                # work — its leading person fills the open cast slot
                director = f.directed_by.get(S, "").lower()
                for i in idxs:
                    j = i + 1
                    if j >= len(sentences) or not re.search(
                            r"\bits?\b", sentences[j]):
                        continue
                    cont = [sp for sp in _content_spans(sentences[j])
                            if _looks_like_person(sp)
                            and sp.lower() != director]
                    if cont and not any(
                            _film_shaped(sp) or _org_shaped(sp)
                            for sp in _content_spans(sentences[j])):
                        f.stars[S] = [cont[0]]
                        break
        elif kind == "org":
            if persons:
                f.founded_by.setdefault(S, persons[0])
            # the seat slot takes a CITY: person-shaped spans with person
            # facts are real people (a bare person-shaped span with none is a
            # multiword toponym — 'Porto Alegre'), and country values fill
            # origin slots, never an org seat
            countries = set(f.country.values()) | set(f.city_in.values())
            places = [sp for sp in spans
                      if sp != (persons[0] if persons else None)
                      and not _org_shaped(sp) and not _film_shaped(sp)
                      and not (_looks_like_person(sp)
                               and any(sp in t for t in person_tables))
                      and sp not in countries and sp not in who_persons]
            # seat precision: a span from a sentence that names the org
            # DIRECTLY outranks one reachable only through an anaphoric
            # sentence ("The group's ... <Name>") — the anaphor's object is
            # some related party, not the seat (observed: a commemorated
            # person's name filling hq because it was the paragraph's last
            # unclassified span)
            direct = [sp for sp in places
                      if any(sl in lowers[i] and sp in sentences[i]
                             for i in idxs)]
            if direct:
                places = direct
            if places and S not in f.hq:
                f.hq[S] = places[-1]
        # retro year attribution: the only year in a film/org paragraph is
        # its release/founding year even when it precedes the title mention
        years = [y for s in ment for y in _YEAR_RE.findall(s)]
        if len(set(years)) == 1:
            if kind == "film":
                f.released.setdefault(S, years[0])
            else:
                f.founded_year.setdefault(S, years[0])
    # phase 2: geographic containment for place subjects — AFTER phase 1 so
    # names that fill person-typed relation slots (a cast member whose own
    # attribute paragraph is absent) are known to be people, not toponyms
    role_persons = (set(f.directed_by.values()) | set(f.founded_by.values())
                    | {p for ps in f.stars.values() for p in ps})
    for S, kind in subjects:
        if (kind == "person" and S not in role_persons
                and S not in who_persons
                and not any(S in t for t in person_tables)):
            # a person-SHAPED paragraph subject with zero person facts after
            # the full first pass is a multiword toponym ('Porto Alegre'),
            # not a person — real person paragraphs always classify
            kind = "place"
        if kind != "place" or S in adjectives:
            continue
        # a span already serving as a COUNTRY value (someone's origin, or a
        # demonym stem) is the container side of the relation, never the
        # contained city
        if (S in f.country.values()
                or any(_same_place(S, nat)
                       for nat in f.nationality.values())):
            continue
        sl = S.lower()
        # literal mentions only: topic-continuity sentences inherited into
        # f.about can belong to a NEIGHBORING paragraph (the next city's
        # existential opener) and would pollute the containment evidence
        ment = [s for i, s in enumerate(sentences) if sl in lowers[i]]
        spans: List[str] = []
        for s in ment:
            for sp in _content_spans(s):
                low = sp.lower()
                if low == sl or low in sl or sl in low:
                    continue
                if sp not in spans:
                    spans.append(sp)
        # containers sit in predicate position: a span OPENING one of the
        # mention sentences is that sentence's subject (a fronted common
        # noun or another topic), not the containing region. Word-boundary
        # prefix: a sentence fronted by a demonym adjective must not mark the
        # base place name as sentence-initial (a bare startswith starved
        # place->container whenever such an opener mentioned the place)
        initial = {sp for sp in spans
                   if any(m.startswith(sp)
                          and (len(m) == len(sp) or not m[len(sp)].isalnum())
                          for m in ment)}
        # demonym ADJECTIVES can't be containers, but a country NAME that is
        # also somebody's origin country is exactly the container sought — it
        # co-occurs in this city's own mention sentence (excluding all of
        # `adjectives` here starved city->country for any country that also
        # appears as a person's origin)
        regions = [sp for sp in spans
                   if not _looks_like_person(sp) and not _org_shaped(sp)
                   and not _film_shaped(sp)
                   and sp not in set(f.nationality.values())
                   and sp not in role_persons and sp not in who_persons
                   and sp not in initial]
        if len(regions) == 1 and S not in f.city_in:
            f.city_in[S] = regions[0]


def _looks_like_person(name: str) -> bool:
    words = name.split()
    return (1 < len(words) <= 3 and not name.startswith(("The ", "A ", "An "))
            and all(w[0].isupper() for w in words))


def _demonym_root(s: str) -> str:
    """Morphological stem shared by a country name and its demonym adjective
    (Norwegian/Norway -> 'norweg'/'norway'). Standard English demonym
    suffixes; irregular pairs (French/France) are not resolved."""
    t = s.lower().strip()
    for suf in ("ese", "ian", "ean", "ish", "an", "er", "i"):
        if t.endswith(suf) and len(t) - len(suf) >= 3:
            return t[: len(t) - len(suf)]
    return t


def _prefix_close(ra: str, rb: str) -> bool:
    n = min(len(ra), len(rb))
    k = 0
    while k < n and ra[k] == rb[k]:
        k += 1
    return k >= 3 and k >= n - 2


def _same_place(a: str, b: str) -> bool:
    """Country-name <-> demonym equivalence by shared morphological stem.

    Two passes: suffix-stripped stems (Norwegian/Norway -> norweg/norway),
    then consonant skeletons for the vowel-alternating irregulars
    (French/France -> frnch/frnc) — English demonym irregularity is mostly
    vowel mutation, so comparing consonants recovers those pairs without a
    gazetteer."""
    al, bl = a.lower().strip(), b.lower().strip()
    if al == bl:
        return True
    if _prefix_close(_demonym_root(al), _demonym_root(bl)):
        return True
    # the skeleton pass demands the shorter skeleton be a FULL prefix of the
    # longer (frnc < frnch yes; frnc vs frnt no) — near-prefix here matched
    # unrelated words sharing three consonants. It also demands a shared
    # INITIAL LETTER: English vowel-mutating demonym pairs keep their first
    # letter (French/France, Spanish/Spain); without the guard any word
    # whose consonant run happens to extend the demonym's matched
    # (Nigerian/Ingrid -> ngr/ngrd).
    if al[:1] != bl[:1]:
        return False
    ca = re.sub(r"[aeiou]", "", _demonym_root(al))
    cb = re.sub(r"[aeiou]", "", _demonym_root(bl))
    n = min(len(ca), len(cb))
    return n >= 3 and ca[:n] == cb[:n]


def _people_by_descriptions(query_l: str, facts: Facts) -> List[str]:
    """ALL people whose stored attributes the question's describing words
    cover (full profession words + a place adjective each) — the resolver
    behind both the single-description subject ('the <Nationality>
    <profession>') and the two-description film join."""
    qtoks = set(re.findall(r"[a-z]+", query_l))
    hits = []
    for person in set(facts.profession) | set(facts.nationality) | set(
            facts.country):
        prof = facts.profession.get(person)
        score = 0
        if prof:
            words = [w for w in re.findall(r"[a-z]+", prof.lower())
                     if len(w) > 2]
            if words and all(w in qtoks for w in words):
                score += 2
        nat = facts.nationality.get(person) or facts.country.get(person)
        if nat and any(_same_place(nat, t) for t in qtoks if len(t) > 3):
            score += 1
        if score >= 3:
            hits.append(person)
    uniq: List[str] = []
    for h in hits:  # the same person can be keyed in slightly different forms
        if not any(h.lower() in u.lower() or u.lower() in h.lower()
                   for u in uniq):
            uniq.append(h)
    return uniq


def _person_by_description(query_l: str, facts: Facts) -> Optional[str]:
    """'the <Nationality> <profession>' with no name -> the unique person whose
    stored attributes match the describing words; None when ambiguous."""
    uniq = _people_by_descriptions(query_l, facts)
    return uniq[0] if len(uniq) == 1 else None


def _joining_films(facts: Facts, people: List[str]) -> List[str]:
    """Films whose maker AND first-billed lead both come from ``people`` (two
    distinct members) — the two-description join's candidate set."""
    if len(people) < 2:
        return []
    want = {p.lower() for p in people}
    out = []
    for film, who in facts.directed_by.items():
        leads = facts.stars.get(film) or []
        if (leads and who.lower() in want and leads[0].lower() in want
                and who.lower() != leads[0].lower()):
            out.append(film)
    return sorted(set(out))


def _films_of(facts: Facts, person: str) -> List[str]:
    """Films whose maker credit resolves to ``person`` (case-insensitive,
    containment both ways like ``_lookup``), sorted for determinism."""
    pl = person.lower().strip()
    out = set()
    for film, who in facts.directed_by.items():
        wl = who.lower()
        if wl == pl or wl in pl or pl in wl:
            out.add(film)
    return sorted(out)


def _org_of_founder(person: str, facts: Facts) -> Optional[str]:
    for org, founder in facts.founded_by.items():
        if founder.lower() == person.lower() or person.lower() in \
                founder.lower() or founder.lower() in person.lower():
            return org
    return None


# ---------------------------------------------------------------------------
# Question intent
# ---------------------------------------------------------------------------

# year-question decomposition (see the attribute == "year" branch): the
# scaffold is closed-class interrogative/function vocabulary, the
# characteristic words are the events the year tables actually model
_YEARQ_SCAFFOLD = frozenset(
    "in what which year when did was were does do is are the a an of to for"
    " on at by from with and or that this it its his her their who whom how"
    " there".split())
_YEARQ_CHARACTERISTIC = frozenset(
    "born birth first reach reached theaters theatres come came out release"
    " released premiere premiered debut debuted founded founding established"
    " formed launched begin began start started".split())


def _year_event_unmodeled(query_l: str, ents: List[str],
                          subject: Optional[str]) -> bool:
    """True when a year question's content words describe an event the
    characteristic-year tables do not model (any leftover verb/noun after
    stripping scaffold, asked entities, type nouns, and the modeled
    release/founding/birth vocabulary)."""
    ent_words = set()
    for e in list(ents) + ([subject] if subject else []):
        ent_words.update(re.findall(r"[a-z][a-z'-]*", e.lower()))
    for t in re.findall(r"[a-z][a-z'-]*", query_l):
        if (t not in _YEARQ_SCAFFOLD and t not in ent_words
                and t not in _YEARQ_CHARACTERISTIC
                and t not in _FILM_WORDS and t not in _ORG_WORDS
                and t not in ("person", "figure", "title", "work", "group")):
            return True
    return False


# relation cue lexicons (paraphrase vocabulary -> fact table family)
_CREATOR_CUES = ("helm", "direct", "made", "behind", "filmmaker", "made the",
                 "founded", "establish", "created", "creator", "founder",
                 "set up", "started", "brought", "begun")
_STAR_CUES = ("star", "actor", "actress", "performer", "appears in", "cast",
              "plays in", "features", "role")
_ATTR_PATTERNS: List[Tuple[str, str]] = [
    # (attribute, regex on the lowercased question)
    ("nationality", r"citizenship|nationality|which country .*(?:come from|from)|"
                    r"what country .*(?:come from|from)|country does"),
    ("org_country", r"(?:which|what) country (?:hosts|is)|country .*based"),
    # "year ... birth/born" in either order: a year interrogative with birth
    # vocabulary asks for the YEAR (the birth word only selects which one) —
    # without the bidirectional match these classified birth_city via its
    # "birth" cue and answered a place to a year question
    ("birth_year", r"birth year|(?:what|which) year .*(?:born|birth)|"
                   r"year of birth"),
    ("birth_city", r"home city|home town|hometown|gr[eo]w up|native|born|birth"),
    ("profession", r"occupation|profession|line of work|living|what does .* do\b|"
                   r"job\b|work as"),
    ("hq", r"headquarter|base of operations|operate[sd]? from|located|"
           r"where (?:does|is) .*(?:operate|based)"),
    ("year", r"\bwhen\b|what year|which year|first (?:reach|hit)|come out|premiere"),
    ("setting", r"\bset\b|take[s]? place"),
    # generic place interrogative — lowest priority so the typed place
    # attributes above (hq / birth_city) keep precedence
    ("place", r"(?:what|which) city|city is home"),
]


def _question_entities(query: str) -> List[str]:
    ents = []
    for m in _TITLE_RE.finditer(query):
        span = _norm(m.group(0))
        parts = span.split()
        # strip the interrogative head plus any lowercase connector it
        # dragged along ("Which of Nadia Eriksson" -> "Nadia Eriksson")
        if parts and parts[0] in (
                "Who", "What", "Which", "Where", "When", "How", "Why", "In",
                "Are", "Do", "Does", "Did", "Is", "Was", "Were", "On", "At",
                "Of"):
            parts = parts[1:]
            while parts and not parts[0][0].isupper():
                parts = parts[1:]
        # a trailing lowercase connector can never END a title ("Lord of the
        # Rings" ends capitalized) — "<Name> the <noun>?" questions otherwise
        # mint a phantom entity ("Ulrich Petrov the") that matches nothing
        # and trips the abstention guard on an answerable question
        while parts and not parts[-1][0].isupper():
            parts = parts[:-1]
        span = " ".join(parts)
        if span and len(span.split("_")) >= 1 and span[0].isupper():
            ents.append(span)
    return [e for e in ents if e]


def _resolve_subject(query_l: str, ents: List[str], facts: Facts) -> Optional[str]:
    """The concrete subject entity, resolving one nested relation hop.

    "the performer who appears in X" -> stars[X]; "the person who made X" /
    "the creator of X" -> directed_by[X] or founded_by[X] by entity type.
    With no relation cue the first question entity that hits any table wins.
    """
    for ent in ents:
        inner = None
        if any(c in query_l for c in _STAR_CUES):
            people = _lookup_list(facts.stars, ent)
            inner = people[0] if people else None
        if inner is None and any(c in query_l for c in _CREATOR_CUES):
            inner = _lookup(facts.directed_by, ent) or _lookup(facts.founded_by,
                                                               ent)
        if inner:
            return inner
    # an entity the fact tables actually know (a lone capitalized adjective in
    # 'the Norwegian sculptor' parses as an "entity" but hits no table)
    tables: List[Dict[str, str]] = [facts.directed_by, facts.founded_by,
                                    facts.hq, facts.founded_year,
                                    facts.nationality, facts.country,
                                    facts.profession, facts.birth_city,
                                    facts.birth_year, facts.released,
                                    facts.setting, facts.film_attrs,
                                    facts.city_in]
    for ent in ents:
        if any(_lookup(t, ent) is not None for t in tables) or \
                _lookup_list(facts.stars, ent):
            return ent
    # no named subject resolves: try attribute descriptions ('the <Nationality>
    # <profession>'), then the org/film they anchor ('the organization begun by
    # the <Nationality> <profession>')
    person = _person_by_description(query_l, facts)
    if person:
        if any(w in query_l for w in _ORG_WORDS):
            org = _org_of_founder(person, facts)
            if org:
                return org
        return person
    return ents[0] if ents else None


def _lookup_list(table: Dict[str, List[str]], key: str) -> Optional[List[str]]:
    kl = key.lower().strip()
    for k, v in table.items():
        if k.lower() == kl or kl in k.lower() or k.lower() in kl:
            return v
    return None


def _film_by_description(query_l: str, facts: Facts) -> Optional[str]:
    """'the science fiction picture from 1981' -> the film whose descriptor and
    year both match; None when ambiguous or nothing matches."""
    year = None
    ym = _YEAR_RE.search(query_l)
    if ym:
        year = ym.group(0)
    films = set(facts.film_attrs) | {s for s in facts.about
                                     if _classified(facts, s) == "film"}
    films |= set(facts.directed_by) | set(facts.stars)
    # truncation twins: evidence briefs can clip a title mid-span ("The
    # Frozen Harbor" -> "The Frozen"), minting a phantom film that ties the
    # real one and fails the unambiguous-winner test — a candidate that is a
    # word-boundary prefix of another candidate IS that candidate
    films = {f0 for f0 in films
             if not any(g != f0 and g.lower().startswith(f0.lower() + " ")
                        for g in films)}
    # descriptor segment of the QUESTION: the noun phrase qualifying the film
    # word ("the <descriptor> film/movie/..."), so that only genre words can
    # score — whole-query overlap let generic role vocabulary ("leading",
    # "role") tie a same-year film of the wrong genre with the right one
    # the group may not cross another determiner, so the CLOSEST "the" wins
    # ("the leading role in the noir film" -> "noir", not "leading role in
    # the noir")
    dm = re.search(r"\bthe ((?:(?!the\b)[a-z]+ ){1,3})(?:%s)\b"
                   % "|".join(_FILM_WORDS), query_l)
    desc_toks = ([w for w in re.findall(r"[a-z]+", dm.group(1))
                  if len(w) > 2] if dm else None) or None
    hits = []
    for film in films:
        # descriptor evidence: the explicit classification descriptor when one
        # was extracted, else the film's own paragraph text (any phrasing
        # mentions the genre words somewhere near the title)
        desc = facts.film_attrs.get(film)
        if desc is None:
            # strip TitleCase names so only descriptor words remain
            desc = re.sub(r"[A-Z][\w'.-]*", " ",
                          " ".join(facts.about.get(film, [])))
        words = [w for w in re.findall(r"[a-z]+", desc.lower())
                 if w not in ("film", "the", "that", "was", "with", "its",
                              "this", "from", "and", "for", "are", "has",
                              "had", "have", "one", "who", "while", "apart")
                 and len(w) > 2]
        if desc_toks is not None:
            overlap = len({w for w in words
                           if any(_stem_close(_match_stem(w), _match_stem(d))
                                  for d in desc_toks)})
        else:
            overlap = len({w for w in words if w in query_l})
        y = facts.released.get(film)
        if year and y and y != year:
            continue
        if overlap or (year and y == year):
            hits.append((overlap + (2 if year and y == year else 0), film))
    hits.sort(key=lambda x: -x[0])
    # demand real descriptor evidence (>= 2: a genre word + the year, or two
    # genre words) and an unambiguous winner
    if hits and hits[0][0] >= 2 and (len(hits) == 1 or hits[0][0] > hits[1][0]):
        return hits[0][1]
    return None


def _entity_year(facts: Facts, ent: str) -> Optional[str]:
    """The entity's characteristic year: release for films, birth for people,
    founding for orgs — the tables are type-disjoint so the chain is safe."""
    return (_lookup(facts.released, ent) or _lookup(facts.birth_year, ent)
            or _lookup(facts.founded_year, ent))


def _film_roles(facts: Facts, query_l: str, ents: List[str]
                ) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """(film, director, lead) resolved from a film named in the question (or
    described by attributes) — the three-entity bridge questions' anchor."""
    film = next((e for e in ents
                 if e in facts.directed_by or e in facts.stars
                 or e in facts.released), None)
    if film is None:
        film = _film_by_description(query_l, facts)
    if film is None:
        return None, None, None
    director = facts.directed_by.get(film)
    stars = facts.stars.get(film) or []
    return film, director, (stars[0] if stars else None)


@lru_cache(maxsize=8)
def _extract_facts_cached(key: Tuple[str, ...]) -> Facts:
    """Memoized fact extraction: the engine's rescue hooks and the second-hop
    rewrite trials (answer/extractive.py) re-ask the SAME evidence several
    times per question; parsing it once amortizes all of them."""
    return extract_facts(list(key))


def answer_from_facts(query: str, sentences: List[str]) -> Optional[str]:
    """Answer ``query`` from the evidence fact KB, or None when unresolvable."""
    facts = _extract_facts_cached(tuple(sentences))
    query_l = query.lower()
    ents = _question_entities(query)

    # --- filmography aggregation: counting and superlatives ------------------
    # "How many features does P have to their credit?" / "Of the features
    # credited to P, which opened first?" — the asked quantity is a property
    # of the SET of films crediting P, so the chain enumerates the maker
    # table instead of extracting any single span. Only evidence films can be
    # enumerated; completeness is the retrieval layer's job (the engine's
    # co-participant expansion, related_expansion_targets).
    person_subj = next((e for e in ents if _looks_like_person(e)), None)
    if person_subj:
        film_q = (any(w in query_l for w in _FILM_WORDS)
                  or "credited" in query_l)
        if film_q and re.search(r"\bhow many\b|\btotal\b|\bnumber of\b",
                                query_l):
            films = _films_of(facts, person_subj)
            return str(len(films)) if films else None
        if (film_q and len(ents) == 1
                and re.search(r"\bfirst\b|\bearliest\b|\blatest\b|"
                              r"\bmost recent\b", query_l)):
            films = _films_of(facts, person_subj)
            dated = [(int(y), f0) for f0 in films
                     for y in [_lookup(facts.released, f0)] if y]
            if len(dated) >= 2 and len(dated) == len(films):
                dated.sort()
                pick_last = bool(re.search(r"\blatest\b|\bmost recent\b",
                                           query_l))
                return dated[-1][1] if pick_last else dated[0][1]
            return None

    # --- description-only film join ------------------------------------------
    # "Which feature joined the <desc-A> behind the camera with the <desc-B>
    # out front?" — no entity names anywhere: resolve every uniquely-described
    # person, then the one film whose credit pair is exactly that set (the
    # orientation is the film's own; a two-description question with a unique
    # joining film needs no role parsing).
    if (re.match(r"^(which|what)\b", query_l)
            and any(w in query_l for w in _FILM_WORDS)
            and not any(_looks_like_person(e) or _org_shaped(e)
                        or _film_shaped(e) for e in ents)):
        people = _people_by_descriptions(query_l, facts)
        joined = _joining_films(facts, people)
        if len(joined) == 1:
            return joined[0]

    # --- "A or B" comparative selection --------------------------------------
    # "Which reached audiences first, A or B?" / "Of A and B, who is older?"
    # Structural: both alternatives are NAMED, the compared quantity is each
    # entity's characteristic year, and the comparative direction comes from
    # closed-class cues. Ties cannot occur (the generator skips them) but
    # resolve to None for honesty.
    if len(ents) >= 2 and re.search(r"\bor\b|\bof\b.*\band\b", query_l):
        later = bool(re.search(r"\blater\b|\byounger\b|\bmore recent\b|"
                               r"\blast\b", query_l))
        earlier = bool(re.search(r"\bfirst\b|\bearlier\b|\bolder\b|"
                                 r"\bsooner\b", query_l))
        if later or earlier:
            ya, yb = _entity_year(facts, ents[0]), _entity_year(facts, ents[1])
            if ya and yb and ya != yb:
                pick_first = (int(ya) < int(yb)) if earlier else (int(ya) > int(yb))
                return ents[0] if pick_first else ents[1]
            return None

    # --- temporal arithmetic: age at a film's opening ------------------------
    # "How old was the lead performer of F when it first reached theaters?"
    if re.search(r"\bhow old\b|\bwhat age\b", query_l):
        film, director, lead = _film_roles(facts, query_l, ents)
        person = (director if re.search(r"filmmaker|director|behind|made",
                                        query_l) and director else lead)
        if film and person:
            fy = _lookup(facts.released, film)
            by = _lookup(facts.birth_year, person)
            if fy and by and int(fy) >= int(by):
                return str(int(fy) - int(by))
        return None

    # --- comparison yes/no ---------------------------------------------------
    if re.match(r"^(are|do|does|did|is|was|were)\b", query_l) and (
            "same" in query_l or "share" in query_l) and len(ents) >= 2:
        table = None
        if re.search(r"citizenship|nationality|country", query_l):
            table = facts.nationality
        elif re.search(r"profession|occupation|line of work", query_l):
            table = facts.profession
        elif re.search(r"city|town", query_l):
            table = facts.birth_city
        if table is not None:
            a = _lookup(table, ents[0])
            b = _lookup(table, ents[1])
            if table is facts.nationality:
                # nationality may be stored as an adjective for one person and
                # a country name for the other (different source phrasings) —
                # compare through the demonym stem
                a = a or _lookup(facts.country, ents[0])
                b = b or _lookup(facts.country, ents[1])
                if a is not None and b is not None:
                    return "yes" if _same_place(a, b) else "no"
            if a is not None and b is not None:
                return "yes" if a.lower() == b.lower() else "no"
        return None

    # --- role-pair yes/no: the film's own people compared --------------------
    # "Do the filmmaker and the lead performer of <film> share a citizenship?"
    # — only the FILM is named; both compared people resolve through its role
    # slots (three-entity bridge).
    if re.match(r"^(are|do|does|did|is|was|were)\b", query_l) and (
            "same" in query_l or "share" in query_l):
        film, director, lead = _film_roles(facts, query_l, ents)
        if film and director and lead:
            a = (_lookup(facts.nationality, director)
                 or _lookup(facts.country, director))
            b = (_lookup(facts.nationality, lead)
                 or _lookup(facts.country, lead))
            if a is not None and b is not None:
                return "yes" if _same_place(a, b) else "no"
        return None

    # --- attribute questions -------------------------------------------------
    # A who-interrogative asks for a person even when the body mentions years
    # or places ("Who helmed the musical that premiered in 1990?") — identity
    # routing must beat the attribute cue scan.
    person_heads = ("who ", "who's", "whom ")
    person_nouns = ("filmmaker", "director", "person", "founder", "creator",
                    "actor", "actress", "performer", "author", "artist")
    is_identity = query_l.startswith(person_heads) or bool(
        re.match(r"^(?:which|what)\s+(\w+)", query_l)
        and re.match(r"^(?:which|what)\s+(\w+)", query_l).group(1) in person_nouns)
    attribute = None
    if not is_identity:
        for attr, pat in _ATTR_PATTERNS:
            if re.search(pat, query_l):
                attribute = attr
                break

    # --- creator-chain profession: org -> founder -> film -> lead ------------
    # "What line of work does the lead of the feature made by the person who
    # brought <org> into being pursue?" — the asked person is the LEAD of the
    # film the org's creator made. Must pre-empt the generic profession
    # routing: _resolve_subject stops at the founder, whose own profession is
    # in evidence whenever their paragraph was sampled as a distractor.
    if attribute == "profession" and re.search(r"\blead\b|performer|fronting",
                                               query_l):
        org = next((e for e in ents
                    if _lookup(facts.founded_by, e) is not None), None)
        if org:
            founder = _lookup(facts.founded_by, org)
            films = _films_of(facts, founder)
            if len(films) == 1:
                leads = (facts.stars.get(films[0])
                         or _lookup_list(facts.stars, films[0]) or [])
                if leads:
                    prof = _lookup(facts.profession, leads[0])
                    if prof:
                        return prof
            return None

    subject = _resolve_subject(query_l, ents, facts)

    if attribute == "nationality" and subject:
        nat = (_lookup(facts.nationality, subject)
               or _lookup(facts.country, subject))
        if nat:
            return nat
        # org phrased as "which country ...": fall through to org_country
        attribute = "org_country"
    if attribute == "org_country" and subject:
        city = _lookup(facts.hq, subject) or _lookup(facts.birth_city, subject)
        if city:
            country = _lookup(facts.city_in, city)
            if country:
                return country
        return None
    if attribute == "birth_year" and subject:
        return _lookup(facts.birth_year, subject)
    if attribute == "birth_city" and subject:
        return _lookup(facts.birth_city, subject)
    if attribute == "profession" and subject:
        return _lookup(facts.profession, subject)
    if attribute == "hq" and subject:
        return _lookup(facts.hq, subject)
    if attribute == "setting" and subject:
        return _lookup(facts.setting, subject)
    if attribute == "place" and subject:
        return (_lookup(facts.hq, subject) or _lookup(facts.birth_city, subject)
                or _lookup(facts.setting, subject))
    if attribute == "year":
        # The tables model each entity's CHARACTERISTIC year only (release /
        # founding / birth). A year question whose content words describe some
        # OTHER event is outside the schema — answering it with the subject's
        # characteristic year asserts a fact nobody stated (observed: a prize
        # question answered with the laureate's birth year). The structural
        # cue is leftover content vocabulary after removing the question
        # scaffold, the asked entities, and the characteristic-event words;
        # such questions fall through to the learned reader / span scorer,
        # which read the evidence instead of a typed slot.
        if _year_event_unmodeled(query_l, ents, subject):
            return None
        for ent in ents:
            y = (_lookup(facts.released, ent) or _lookup(facts.founded_year, ent)
                 or _lookup(facts.birth_year, ent))
            if y:
                return y
        # no named entity answers: description references ('the <genre> film
        # from <year>' never asks a year; 'the <Nationality> <profession>' may)
        if subject:
            y = _lookup(facts.birth_year, subject)
            if y:
                return y
        return None

    # --- identity (who) questions -------------------------------------------
    return _identity_answer(query_l, ents, facts)


def _identity_answer(query_l: str, ents: List[str], facts: Facts
                     ) -> Optional[str]:
    if re.search(r"\bwho\b|filmmaker|director|founder|creator|performer|"
                 r"actor|actress|\bstar\b", query_l):
        if any(c in query_l for c in _STAR_CUES):
            for ent in ents:
                people = _lookup_list(facts.stars, ent)
                if people:
                    return people[0]
            # attribute-description film reference ("the western from 1994")
            film = _film_by_description(query_l, facts)
            if film and facts.stars.get(film):
                return facts.stars[film][0]
        if any(c in query_l for c in _CREATOR_CUES):
            for ent in ents:
                p = _lookup(facts.directed_by, ent) or _lookup(facts.founded_by,
                                                               ent)
                if p:
                    return p
            film = _film_by_description(query_l, facts)
            if film:
                return facts.directed_by.get(film)
    return None


def missing_entities(query: str, sentences: List[str]) -> List[str]:
    """Entities the intent resolution needs facts about but the evidence lacks.

    The agentic second-hop hook (used by agent/inference.py): when the question
    resolves an intermediate entity whose attribute paragraph was never
    retrieved — "the lead actor of X" resolved to a name with no nationality
    fact, or an org whose headquarters city has no country fact — return those
    names so the engine can anchor follow-up retrieval on them. Empty when the
    question is answerable (or entirely unresolvable) from the current facts.
    """
    if answer_from_facts(query, sentences) is not None:
        return []
    facts = extract_facts(sentences)
    query_l = query.lower()
    ents = _question_entities(query)
    need: List[str] = []

    # "A or B" comparative: both alternatives need their characteristic year
    if len(ents) >= 2 and re.search(r"\bor\b|\bof\b.*\band\b", query_l) and \
            re.search(r"\bfirst\b|\bearlier\b|\bolder\b|\bsooner\b|\blater\b|"
                      r"\byounger\b|\bmore recent\b|\blast\b", query_l):
        return [e for e in ents[:2] if _entity_year(facts, e) is None]

    # age arithmetic: the film's person needs a birth year on record
    if re.search(r"\bhow old\b|\bwhat age\b", query_l):
        film, director, lead = _film_roles(facts, query_l, ents)
        person = (director if re.search(r"filmmaker|director|behind|made",
                                        query_l) and director else lead)
        if film and person and _lookup(facts.birth_year, person) is None:
            return [person]
        return []

    # comparison: both compared entities need the compared attribute
    if re.match(r"^(are|do|does|did|is|was|were)\b", query_l) and (
            ("same" in query_l or "share" in query_l) and len(ents) >= 2):
        if re.search(r"citizenship|nationality|country", query_l):
            table = facts.nationality
        elif re.search(r"profession|occupation|line of work", query_l):
            table = facts.profession
        else:
            table = facts.birth_city
        return [e for e in ents[:2] if _lookup(table, e) is None]

    # role-pair yes/no: the film's own people need nationality facts
    if re.match(r"^(are|do|does|did|is|was|were)\b", query_l) and (
            "same" in query_l or "share" in query_l):
        film, director, lead = _film_roles(facts, query_l, ents)
        if film:
            return [p for p in (director, lead) if p is not None
                    and _lookup(facts.nationality, p) is None
                    and _lookup(facts.country, p) is None]
        return []

    # filmography superlative with an undated film: its credit sentence made
    # it into evidence but the date sentence was budget-trimmed — rebuild
    # with the film's node as a priority id
    person_subj = next((e for e in ents if _looks_like_person(e)), None)
    if (person_subj and len(ents) == 1
            and (any(w in query_l for w in _FILM_WORDS)
                 or "credited" in query_l)
            and re.search(r"\bfirst\b|\bearliest\b|\blatest\b|\bmost recent\b",
                          query_l)):
        films = _films_of(facts, person_subj)
        undated = [f0 for f0 in films if _lookup(facts.released, f0) is None]
        if undated:
            return undated[:3]

    # creator-chain profession: walk the chain to its first broken link —
    # the film whose lead-credit sentence never made it into evidence, or the
    # lead whose own (profession) paragraph was never retrieved
    if re.search(r"occupation|line of work|profession", query_l) and \
            re.search(r"\blead\b|performer|fronting", query_l):
        org = next((e for e in ents
                    if _lookup(facts.founded_by, e) is not None), None)
        if org:
            founder = _lookup(facts.founded_by, org)
            films = _films_of(facts, founder) if founder else []
            if len(films) == 1:
                leads = (facts.stars.get(films[0])
                         or _lookup_list(facts.stars, films[0]) or [])
                if not leads:
                    return [films[0]]
                if _lookup(facts.profession, leads[0]) is None:
                    return [leads[0]]

    # two-description film join with only ONE side resolved: every film
    # crediting the resolved person proposes the other credit's person as the
    # remaining description's candidate — fetch their paragraphs to test it
    if (re.match(r"^(which|what)\b", query_l)
            and any(w in query_l for w in _FILM_WORDS)
            and not any(_looks_like_person(e) or _org_shaped(e)
                        or _film_shaped(e) for e in ents)):
        people = _people_by_descriptions(query_l, facts)
        if len(people) == 1:
            p = people[0].lower()
            proposed: List[str] = []
            for film, who in facts.directed_by.items():
                leads = facts.stars.get(film) or []
                if who.lower() == p and leads:
                    proposed.append(leads[0])
                elif leads and leads[0].lower() == p:
                    proposed.append(who)
            cands = [n for n in dict.fromkeys(proposed)
                     if facts.profession.get(n) is None
                     or (facts.nationality.get(n) is None
                         and facts.country.get(n) is None)]
            if cands:
                return cands[:3]

    # description-resolved film whose asked ROLE fact is missing: the film's
    # attribute sentence made it into evidence but its credit sentence did
    # not (budget-trimmed) — fetch the film's own node for the full paragraph
    star_q = any(c in query_l for c in _STAR_CUES)
    creator_q = any(c in query_l for c in _CREATOR_CUES)
    if star_q or creator_q:
        film = _film_by_description(query_l, facts)
        if film is not None:
            if star_q and not facts.stars.get(film):
                return [film]
            if creator_q and film not in facts.directed_by:
                return [film]

    subject = _resolve_subject(query_l, ents, facts)
    # _resolve_subject's last resort echoes ents[0] back; an echoed subject
    # that no fact table knows is not a resolution — treat as unresolved so
    # the description-candidate hops below can fire
    if subject in ents:
        known_tables: List[Dict[str, str]] = [
            facts.directed_by, facts.founded_by, facts.hq, facts.founded_year,
            facts.nationality, facts.country, facts.profession,
            facts.birth_city, facts.birth_year, facts.released, facts.setting,
            facts.film_attrs, facts.city_in]
        if not (any(_lookup(t, subject) is not None for t in known_tables)
                or _lookup_list(facts.stars, subject)):
            subject = None
    if subject is None:
        # attribute-description subject ("the <Demonym> <profession>") that no
        # evidence person FULLY satisfies: people who partially match — the
        # demonym fits their known place attribute but their profession never
        # made it into the evidence (budget-trimmed paragraph), or the
        # profession words match but their place attribute is unknown — are
        # candidates whose full paragraphs decide the description. Fetch them
        # before falling back to the country anchor.
        partial: List[str] = []
        qtoks = set(re.findall(r"[a-z]+", query_l))
        demonyms = [e for e in ents if len(e.split()) == 1]
        for person in sorted(set(facts.nationality) | set(facts.country)):
            nat = facts.nationality.get(person) or facts.country.get(person)
            if (nat and _looks_like_person(person)
                    and facts.profession.get(person) is None
                    and any(_same_place(nat, d) for d in demonyms)):
                partial.append(person)
        for person in sorted(facts.profession):
            words = [w for w in re.findall(r"[a-z]+",
                                           facts.profession[person].lower())
                     if len(w) > 2]
            if (words and all(w in qtoks for w in words)
                    and _looks_like_person(person)
                    and facts.nationality.get(person) is None
                    and facts.country.get(person) is None):
                partial.append(person)
        if partial:
            return list(dict.fromkeys(partial))[:3]
        # otherwise anchor the follow-up hop on the COUNTRY the demonym
        # adjective names. People link to their origin country in the graph,
        # so the country node reaches the described person even though no
        # question token names them. Candidate countries come from the
        # evidence itself (no gazetteer).
        known_places = (set(facts.city_in.values()) | set(facts.country.values())
                        | {k for k in facts.about if len(k.split()) == 1})
        for ent in ents:
            if len(ent.split()) != 1:
                continue
            for place in sorted(known_places):
                if place and place.lower() != ent.lower() and \
                        _same_place(ent, place):
                    return [place]
        return []
    person_tables = (facts.nationality, facts.profession, facts.birth_city,
                     facts.birth_year)
    # known-ness is decided by the ASKED attribute's tables: a bridge subject
    # whose profession arrived in a summary is still missing for a nationality
    # question — any-table known-ness silently swallowed the follow-up hop
    attr_tables: Dict[str, List[Dict[str, str]]] = {
        "nationality": [facts.nationality, facts.country],
        "org_country": [facts.country, facts.city_in],
        "birth_year": [facts.birth_year],
        "birth_city": [facts.birth_city],
        "profession": [facts.profession],
        "hq": [facts.hq],
        "year": [facts.birth_year, facts.released, facts.founded_year],
        "setting": [facts.setting],
        "place": [facts.hq, facts.birth_city],
    }
    asked = next((a for a, pat in _ATTR_PATTERNS if re.search(pat, query_l)),
                 None)
    tables = attr_tables.get(asked or "", list(person_tables))
    subject_known = any(_lookup(t, subject) is not None for t in tables)
    # org-country chain: headquarters city known, its country missing
    hq_city = _lookup(facts.hq, subject)
    if (re.search(r"\bcountry\b|citizenship|nationality", query_l) and hq_city
            and _lookup(facts.city_in, hq_city) is None):
        need.append(hq_city)
    elif not subject_known and subject not in " ".join(ents):
        # a resolved intermediate (star/creator) with no facts of their own
        need.append(subject)
    elif not subject_known and _looks_like_person(subject):
        need.append(subject)
    return list(dict.fromkeys(need))


def related_expansion_targets(query: str, sentences: List[str]) -> List[str]:
    """Entities whose co-participant (credit) neighborhood retrieval must
    cover before the question becomes answerable.

    The agentic hook behind the v4 aggregation families (agent/inference.py):
    a counting/superlative question needs EVERY film node adjacent to the
    person — no single attribute hop can enumerate them — and a creator chain
    or two-description join needs the film node that links already-resolved
    people. The engine expands these entities' related/participation edges
    and commits the co-participant nodes. Empty when no aggregation intent
    applies (the cheap hops in ``missing_entities`` stay the default)."""
    facts = extract_facts(sentences)
    query_l = query.lower()
    ents = _question_entities(query)
    out: List[str] = []

    person_subj = next((e for e in ents if _looks_like_person(e)), None)
    film_q = any(w in query_l for w in _FILM_WORDS) or "credited" in query_l
    if person_subj and film_q and re.search(
            r"\bhow many\b|\btotal\b|\bnumber of\b|\bfirst\b|\bearliest\b|"
            r"\blatest\b|\bmost recent\b", query_l):
        out.append(person_subj)

    if re.search(r"occupation|line of work|profession", query_l) and \
            re.search(r"\blead\b|performer|fronting", query_l):
        org = next((e for e in ents
                    if _lookup(facts.founded_by, e) is not None), None)
        if org:
            founder = _lookup(facts.founded_by, org)
            if founder and len(_films_of(facts, founder)) != 1:
                out.append(founder)

    if (re.match(r"^(which|what)\b", query_l)
            and any(w in query_l for w in _FILM_WORDS)
            and not any(_looks_like_person(e) or _org_shaped(e)
                        or _film_shaped(e) for e in ents)):
        people = _people_by_descriptions(query_l, facts)
        if len(people) >= 2 and not _joining_films(facts, people):
            out.extend(people)
        elif len(people) == 1:
            # one side resolved: the joining film is one of this person's
            # credit co-participants, and its own paragraph names the OTHER
            # credit — expand the resolved person's neighborhood so the
            # one-sided proposal (missing_entities) can test the remaining
            # description against real people
            films = _films_of(facts, people[0])
            if not any(facts.stars.get(f0) for f0 in films):
                out.append(people[0])

    return list(dict.fromkeys(out))


def unanswerable(query: str, sentences: List[str]) -> bool:
    """True when the question names entities and NONE of them is mentioned
    anywhere in the evidence, and no descriptive subject resolves either —
    the asked entity does not exist in the corpus, so the only correct
    behavior is to abstain (squad_v2's no-answer axis).

    Deliberately conservative: a single mention of any named span keeps the
    question in play (the fact chain or a follow-up hop may still answer it),
    so a phantom entity sharing surface tokens with real ones ("The Emerald
    Quarry" vs "The Emerald Harbor") abstains only because the full span
    matches nothing."""
    ents = _question_entities(query)
    if not ents:
        return False
    text = " ".join(sentences).lower()
    for e in ents:
        if e.lower() in text:
            return False
    facts = extract_facts(sentences)
    subject = _resolve_subject(query.lower(), ents, facts)
    # _resolve_subject's last resort echoes ents[0] back — an echoed subject
    # with no facts in any table is not a resolution
    if subject and subject not in ents:
        return False
    return True


def answer_subjects(query: str, sentences: List[str]) -> List[str]:
    """Entities whose facts the QA chain reads to answer ``query``.

    Retrieval-accounting hook (agent/inference.py): when the answer resolves
    through a bridge subject whose facts arrived inside a SUMMARY body (so no
    follow-up hop fired), the subject's own graph node never enters the
    selection and recall@k under-credits the evidence that was genuinely
    retrieved. The engine commits these subjects' nodes after answering.
    Empty when the question is not answerable from the current facts.
    """
    if answer_from_facts(query, sentences) is None:
        return []
    facts = extract_facts(sentences)
    query_l = query.lower()
    ents = _question_entities(query)
    if re.match(r"^(are|do|does|did|is|was|were)\b", query_l) and (
            "same" in query_l and len(ents) >= 2):
        return ents[:2]
    subs: List[str] = []

    # filmography aggregation reads every enumerated film's paragraph
    person_subj = next((e for e in ents if _looks_like_person(e)), None)
    if person_subj and (any(w in query_l for w in _FILM_WORDS)
                        or "credited" in query_l) and re.search(
            r"\bhow many\b|\btotal\b|\bnumber of\b|\bfirst\b|\bearliest\b|"
            r"\blatest\b|\bmost recent\b", query_l):
        subs.extend(_films_of(facts, person_subj))

    # two-description join reads the joining film and both people
    if (re.match(r"^(which|what)\b", query_l)
            and any(w in query_l for w in _FILM_WORDS)
            and not any(_looks_like_person(e) or _org_shaped(e)
                        or _film_shaped(e) for e in ents)):
        people = _people_by_descriptions(query_l, facts)
        joined = _joining_films(facts, people)
        if len(joined) == 1:
            film0 = joined[0]
            subs.append(film0)
            subs.append(facts.directed_by[film0])
            subs.extend((facts.stars.get(film0) or [])[:1])

    # creator-chain profession reads the film and the lead
    if re.search(r"occupation|line of work|profession", query_l) and \
            re.search(r"\blead\b|performer|fronting", query_l):
        org = next((e for e in ents
                    if _lookup(facts.founded_by, e) is not None), None)
        if org:
            founder = _lookup(facts.founded_by, org)
            films = _films_of(facts, founder) if founder else []
            if len(films) == 1:
                subs.append(films[0])
                leads = (facts.stars.get(films[0])
                         or _lookup_list(facts.stars, films[0]) or [])
                subs.extend(leads[:1])

    subject = _resolve_subject(query_l, ents, facts)
    if subject:
        subs.append(subject)
        # org-country chain reads the HQ city's paragraph too
        if re.search(r"\bcountry\b|citizenship|nationality", query_l):
            hq_city = _lookup(facts.hq, subject)
            if hq_city and _lookup(facts.city_in, hq_city):
                subs.append(hq_city)
    film = _film_by_description(query_l, facts)
    if film:
        subs.append(film)
    return list(dict.fromkeys(subs))


# -------------------------------------------------- conjunctive verification
def _match_stem(t: str) -> str:
    """Suffix-stripped stem for containment matching (inflection-tolerant)."""
    for suf in ("ation", "ition", "ing", "ion", "ies", "ed", "es", "ly", "s"):
        if t.endswith(suf) and len(t) - len(suf) >= 4:
            return t[: len(t) - len(suf)]
    return t


def _query_constraint_terms(query: str) -> List[Tuple[str, bool]]:
    """(term, was_capitalized) content terms of a question.

    Structural extraction only: tokens belonging to a MULTIWORD capitalized
    span are entity names (anchored by _question_entity_ids already) and are
    excluded; a single capitalized token is kept — it may be a demonym whose
    country the corpus names instead; lowercase tokens pass a function-word
    filter; 4-digit numbers always qualify.
    """
    from ahrag_tpu_torch.answer.extractive import _STOPWORDS
    func = _STOPWORDS | {"has", "have", "had", "same", "both", "all", "any",
                         "whose", "there", "not", "no", "than", "then",
                         "into", "about"}
    multi = {w.lower() for e in _question_entities(query)
             if len(e.split()) >= 2 for w in e.split()}
    out: List[Tuple[str, bool]] = []
    seen: set = set()
    for w in re.findall(r"[A-Za-z][\w'-]*|\d{4}", query):
        wl = w.lower()
        if wl in seen or wl in multi:
            continue
        if w.isdigit():
            out.append((w, False))
            seen.add(wl)
            continue
        if wl in func or len(wl) < 3:
            continue
        out.append((w, w[0].isupper()))
        seen.add(wl)
    return out


def _containment_index(text: str) -> Tuple[set, set, set]:
    words = re.findall(r"[A-Za-z][\w'-]*|\d{4}", text)
    lowered = {w.lower() for w in words}
    stems = {_match_stem(w) for w in lowered if len(w) >= 4}
    caps = {w for w in words if w[:1].isupper()}
    return lowered, stems, caps


def _stem_close(a: str, b: str) -> bool:
    """Equal stems, or a prefix relation at most two characters deep —
    inflection variants pass (animat/anim), compounds do not (film/filmmaker),
    unlike _prefix_close whose bound scales with the SHORTER string."""
    if a == b:
        return True
    if len(a) > len(b):
        a, b = b, a
    return len(b) - len(a) <= 2 and b.startswith(a) and len(a) >= 4


def _term_in_index(term: str, cap: bool, idx: Tuple[set, set, set]) -> bool:
    lowered, stems, caps = idx
    tl = term.lower()
    if tl in lowered:
        return True
    if tl.isdigit():
        return False  # numbers match exactly or not at all
    ts = _match_stem(tl)
    if len(ts) >= 4 and any(_stem_close(ts, s) for s in stems):
        return True
    if cap:
        return any(_same_place(term, c) for c in caps)
    return False


def constraint_coverage(query: str, texts: List[str],
                        idf: Optional[Dict[str, float]] = None
                        ) -> List[Tuple[int, int, float]]:
    """Rank candidate texts by rarity-weighted coverage of the question's
    content terms — the conjunctive verifier behind
    agent/inference.py::_constraint_rescue.

    Dense cosine scores every term independently, so on a corpus-scale graph
    a paragraph matching ONE common term can outrank the paragraph matching
    the full conjunction (a genre-plus-year question: many candidates carry
    some year, exactly one carries that genre AND that year). This verifies
    the conjunction on the candidates themselves: a term matches a text via
    exact word, stem-tolerant prefix (_prefix_close over suffix-stripped
    stems), or — for capitalized single tokens — country/demonym equivalence
    (_same_place). Term weight is 1/df over the candidate set, so generic
    question vocabulary self-discounts without any word list. When the
    caller supplies ``idf`` (corpus-GLOBAL document frequencies from
    ``corpus_idf``), it replaces the pool-relative weights: a rescue pool
    deliberately biased toward the query's own terms makes every query term
    look common in-pool, deflating exactly the descriptor whose rarity
    should decide the ranking (observed: a demonym-augmented pool full of
    one country's residents down-weighting that demonym below the
    scaffolding stem "year(s)").

    Matching is SENTENCE-WINDOW scoped: the conjunction must co-occur within
    two adjacent sentences of a candidate, not merely somewhere in its merged
    description — hub nodes (a city whose description concatenates every
    resident's sentences) otherwise cover any conjunction by accumulation.
    df stays document-level for stability.

    Returns (index, n_matched, weight) rows, best first, for candidates
    whose best window covers at least two term groups.
    No reference counterpart: the reference's MiniLM+HNSW seed path
    (hierarchical_graph.py:706-714) is equally conjunction-blind; this
    deviation uses the candidate set itself as the verifier.
    """
    terms = _query_constraint_terms(query)
    if len(terms) < 2 or not texts:
        return []

    def windows(text: str) -> List[str]:
        sents = [s for s in re.split(r"(?<=[.!?])\s+|;\s+", text) if s.strip()]
        if len(sents) <= 2:
            return [text]
        return [" ".join(sents[i:i + 2]) for i in range(len(sents) - 1)]

    win_match: List[List[List[bool]]] = []   # candidate -> window -> term hits
    for text in texts:
        rows = []
        for w in windows(text):
            ix = _containment_index(w)
            rows.append([_term_in_index(t, c, ix) for (t, c) in terms])
        win_match.append(rows)
    # document-level matches drive df and decorrelation
    match = [[any(r[j] for r in rows) for j in range(len(terms))]
             for rows in win_match]
    # decorrelate: terms whose match columns are IDENTICAL across the pool
    # are one feature, not several — phrasal pairs travel together in both
    # question and corpus, and counting each word separately let scaffolding
    # phrases outvote a single rarer descriptor term
    cols: Dict[tuple, int] = {}
    for j in range(len(terms)):
        cols.setdefault(tuple(row[j] for row in match), j)
    groups = list(cols.values())
    import math
    if idf is not None:
        # corpus-global weights: a group's weight is its rarest member's —
        # phrase pairs ('jazz pianist') decorrelate into one group above,
        # and the rarer member is the phrase's discriminating df
        members: Dict[int, List[int]] = {}
        for j in range(len(terms)):
            members.setdefault(cols[tuple(row[j] for row in match)], []).append(j)
        w = {j: max(idf.get(terms[k][0].lower(), 0.0) for k in members[j])
             for j in groups}
    else:
        df = {j: sum(row[j] for row in match) for j in groups}
        # no absolute-rarity gate: the candidate pool is DENSE-BIASED (it was
        # selected by similarity to this query), so every question term can
        # look common inside it; relative 1/df weighting still ranks the
        # candidate covering the extra term above the ones covering a subset
        n_pool = len(texts)
        w = {j: math.log(n_pool / df[j]) if df[j] else 0.0 for j in groups}
    out: List[Tuple[int, int, float]] = []
    for i, rows in enumerate(win_match):
        best_w, best_n = 0.0, 0
        for r in rows:
            hit = [j for j in groups if r[j]]
            hw = sum(w[j] for j in hit)
            if (hw, len(hit)) > (best_w, best_n):
                best_w, best_n = hw, len(hit)
        if best_n < 2:
            continue
        out.append((i, best_n, best_w))
    out.sort(key=lambda x: (-x[2], -x[1], x[0]))
    return out


def containment_indexes(texts: List[str]) -> List[Tuple[set, set, set]]:
    """Prebuilt document-level containment indexes for ``corpus_idf`` —
    term-independent, so a caller holding a fixed corpus (every entity
    description in a shared graph) builds them once and reuses them across
    queries."""
    return [_containment_index(t) for t in texts]


def corpus_idf(query: str, idxs: List[Tuple[set, set, set]]
               ) -> Dict[str, float]:
    """Corpus-global idf for the query's content terms over prebuilt
    ``containment_indexes`` (one per document). Document-level containment
    matching via the same _term_in_index used by constraint_coverage, so a
    term's df counts demonym/stem variants too. Terms absent from the corpus
    get the maximum weight log(N)."""
    import math
    terms = _query_constraint_terms(query)
    if not terms or not idxs:
        return {}
    n = len(idxs)
    out: Dict[str, float] = {}
    for t, cap in terms:
        df = sum(1 for ix in idxs if _term_in_index(t, cap, ix))
        out[t.lower()] = math.log(n / df) if df else math.log(n)
    return out
