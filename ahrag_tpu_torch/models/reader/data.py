"""Meta-training data for the span reader: randomized relation surfaces.

The port's copy of ``ahrag_tpu/models/reader/data.py``, unchanged but for
its imports (``random.Random`` only): the same seed gives the same
instances, arrays and gold spans as the JAX package's.

The point of the reader is schema generalization, so its training data
must make memorizing any relation impossible. Every instance samples its
OWN relation surfaces: verb phrases are drawn fresh from word pools (and
pseudo-words), subjects/objects from generated name pools, and the
question re-describes the relation with DIFFERENT words than the
evidence sentence uses. The only stable regularities across the corpus —
and therefore the only things the model can learn — are structural:

- the answer lives in a sentence that mentions the question's anchor
  entities (or, for 2-hop items, in the paragraph of the entity that
  co-occurs with the anchor);
- the answer's surface type agrees with the question word (who -> name,
  when/what year -> year, which <noun> -> lowercase noun, ...);
- the answer is never a token the question already contains;
- appended facts are rarer/later than a paragraph's boilerplate, while
  biographical basics (role, origin, birth year) live IN the repeated
  boilerplate shape.

Two vocabularies are deliberately treated differently:

- RELATION surfaces (what links subject to object) are randomized per
  instance — held-out relations (eval/synth.py v5) stay zero-shot, and
  tools/audit_synth_disjoint.py scans this file to prove no v5 corpus
  marker leaks in.
- QUESTION-INTENT vocabulary (occupation / profession / home city /
  year words) is general English an evidence reader must simply know —
  the capability an LLM gets from pretraining. Intent words are sampled
  from broad synonym pools; none of the v5 question templates appears
  verbatim.

The round-4 first cut trained on one narrow boilerplate and failed to
transfer (reports/v5_reader_train_r4.json): real-English biography
sentences were out of distribution, occupation-intent questions were
untrained, and span ends drifted on unfamiliar names. This generator
diversifies all three (6 boilerplate shapes, role/birth question
families incl. 2-hop, 1-3-word names, title-fragment sentences mimicking
answer/extractive.py::_clean_sentences block starts).
"""
from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Optional, Tuple

# ----------------------------------------------------------------- pools
_SYL_A = ["ba", "den", "kor", "mel", "tar", "vin", "sor", "lue", "pra", "nim",
          "gos", "har", "jel", "fen", "rud", "cas", "tol", "wer", "zan", "bri"]
_SYL_B = ["dor", "lin", "mak", "sen", "vik", "rno", "tel", "gard", "bel",
          "mon", "ric", "sta", "ver", "lan", "dis", "fort", "ner", "holm"]

# generic verbs/nouns for relation surfaces — none of these words appears
# in any v5 relation marker phrase (audited)
_VERBS = ["organized", "reviewed", "championed", "catalogued", "restored",
          "audited", "sketched", "financed", "translated", "archived",
          "curated", "surveyed", "drafted", "inspected", "promoted",
          "assembled", "endorsed", "documented", "chronicled", "sponsored",
          "revised", "examined", "compiled", "launched", "convened"]
_NOUNS = ["ledger", "charter", "mural", "archive", "pavilion", "treatise",
          "registry", "almanac", "portfolio", "gazette", "atlas", "dossier",
          "manifesto", "catalogue", "anthology", "compendium", "bulletin",
          "prospectus", "inventory", "blueprint"]
_ADJS = ["celebrated", "reclusive", "prolific", "itinerant", "seasoned",
         "versatile", "meticulous", "renowned", "spirited", "studious"]
_ROLE_HEADS = ["archivist", "cartographer", "botanist", "glassblower",
               "engraver", "luthier", "falconer", "apiarist", "milliner",
               "chandler", "cooper", "farrier", "saddler", "thatcher",
               "vintner", "surveyor", "illustrator", "restorer", "binder",
               "printer", "geologist", "astronomer", "historian", "curator"]
_ROLE_MODS = ["harbor", "alpine", "coastal", "forest", "garden", "royal",
              "polar", "desert", "island", "river", "highland", "valley"]
_OBJ_NOUNS = ["quillwork", "fresco", "tapestry", "sundial", "orrery",
              "astrolabe", "lithograph", "woodcut", "etching", "mosaic",
              "filigree", "marquetry", "cloisonne", "scrimshaw", "repousse",
              "intaglio"]
_ORG_SUFFIX = ["Circle", "Union", "Syndicate", "Assembly", "League",
               "Bureau", "Consortium", "Cooperative", "Guild", "Society"]
_ORG_KINDS = ["research body", "trade association", "charitable trust",
              "survey studio", "learned society", "cooperative venture"]
_Q_CATS = ["technique", "specialty", "discipline", "pursuit",
           "medium", "artform", "vocation"]

# capitalized THING names (award/title-shaped anchors): a question can anchor
# on a non-person capitalized entity whose carrying sentence names the person
# the question is really about. Suffixes deliberately disjoint from
# eval/synth.py AWARD_TAIL so the surface stays zero-shot.
_THING_SUFFIX = ["Ribbon", "Garland", "Chalice", "Banner", "Plaque",
                 "Rosette", "Scroll", "Pennant"]
# generic kin/association nouns for possessive-hop questions ("{p}'s
# {kin}" / "the {kin} of {p}") — question-intent vocabulary, never a v5
# corpus marker
_KIN = ["partner", "counterpart", "associate", "collaborator"]

# question-intent synonym pools (general English, see module docstring)
_ROLE_Q = ["What occupation does {p} hold?",
           "What is {p}'s profession?",
           "What trade does {p} ply?",
           "What does {p} do professionally?",
           "Which profession is {p} known for?",
           "What line of work occupies {p}?",
           "How does {p} make a living?",
           "What is the occupation of {p}?"]
_ROLE_Q_HOP = ["What occupation does the person who {rel} {p} hold?",
               "What is the profession of the figure who {rel} {p}?",
               "How does the person who {rel} {p} make a living?",
               "What does the one who {rel} {p} do professionally?"]
_CITY_Q = ["What is the home city of {p}?",
           "Near which city did {p} come of age?",
           "Which city does {p} come from?",
           "Where did {p} grow up?",
           "What is {p}'s native city?"]
_CITY_Q_HOP = ["What is the home city of the person who {rel} {p}?",
               "Where did the figure who {rel} {p} grow up?",
               "Which city does the one who {rel} {p} come from?"]
_BYEAR_Q = ["In what year was {p} born?",
            "Which year saw the birth of {p}?",
            "When was {p} born?"]
_REL_Q = ["collaborated with", "worked with", "was involved with",
          "dealt with", "was connected to", "crossed paths with",
          "had dealings with"]


def _pseudo_word(rng: random.Random, syls: int = 2) -> str:
    return "".join(rng.choice(_SYL_A if i % 2 == 0 else _SYL_B)
                   for i in range(syls))


def _person(rng: random.Random) -> str:
    n_parts = 1 + rng.randrange(3)          # 1-3 word names (span-end drill)
    parts = [_pseudo_word(rng, 1 + rng.randrange(2)).capitalize()
             for _ in range(n_parts)]
    return " ".join(parts) if n_parts > 1 else (
        parts[0] + " " + _pseudo_word(rng, 2).capitalize())


def _world_people(rng: random.Random, n: int) -> List[str]:
    """A world's cast with DELIBERATE name-part reuse: given names and
    surnames are drawn from small per-world pools, so several people share a
    part while full names stay unique. Real corpora (and eval/synth.py) reuse
    name parts across people — a reader keyed on single capitalized tokens
    confuses the name-sharers; only the full-sequence anchor disambiguates
    (features.py channels 12-13 exist for exactly this drill)."""
    pool = max(3, (n + 1) // 2)
    givens = [_pseudo_word(rng, 1 + rng.randrange(2)).capitalize()
              for _ in range(pool)]
    surs = [_pseudo_word(rng, 2).capitalize() for _ in range(pool)]
    seen, out = set(), []
    tries = 0
    while len(out) < n and tries < 200:
        tries += 1
        name = rng.choice(givens) + " " + rng.choice(surs)
        if rng.random() < 0.15:
            name = (rng.choice(givens) + " "
                    + _pseudo_word(rng, 2).capitalize() + " "
                    + rng.choice(surs))
        if name not in seen:
            seen.add(name)
            out.append(name)
    while len(out) < n:           # pool exhausted: top up with unique names
        out.append(_person(rng))
    return out


def _org(rng: random.Random) -> str:
    return (_pseudo_word(rng, 2).capitalize() + " " + rng.choice(_ORG_SUFFIX))


def _city(rng: random.Random) -> str:
    return _pseudo_word(rng, 2 + rng.randrange(2)).capitalize()


def _year(rng: random.Random) -> str:
    return str(1900 + rng.randrange(120))


def _demonym(rng: random.Random) -> str:
    return _pseudo_word(rng, 2).capitalize() + rng.choice(["ian", "ese", "ic"])


def _role(rng: random.Random) -> str:
    head = rng.choice(_ROLE_HEADS)
    if rng.random() < 0.5:                   # 1-2 word roles
        return rng.choice(_ROLE_MODS) + " " + head
    return head


class Instance(NamedTuple):
    question: str
    sentences: List[str]        # with "" paragraph seams
    answer: str
    gold_sentence: int          # index into the non-"" sentence sequence


# --------------------------------------------------- boilerplate shapes

def _boiler(rng: random.Random, shape: int, p: str, info: Dict[str, str]
            ) -> Tuple[List[str], Dict[str, int]]:
    """Boilerplate sentences for one person + per-attribute sentence offset.

    Returns (sentences, {"role"/"city"/"year": local sentence index}).
    Shapes 0-6 pack all attributes into ONE sentence; shapes 7-8 SPLIT
    them across sentences the way real biography paragraphs (and the v5
    world's two-sentence boilers) do — a profession answer then lives in
    a different sentence than the birth year, and the reader must pick
    the sentence by ATTRIBUTE, not merely by anchor hit.
    """
    adj, role = info["adj"], info["role"]
    city, year = info["city"], info["year"]
    one = None
    if shape == 0:
        one = f"{p} is a {adj} {role} who settled near {city} in {year}."
    elif shape == 1:
        one = (f"{p}, a {role} by calling, hails from {city} and first "
               f"drew notice in {year}.")
    elif shape == 2:
        one = (f"The record of {p} opens in {city} in {year}, where the "
               f"young {role} trained.")
    elif shape == 3:
        one = f"Born in {year} near {city}, {p} earned renown as a {role}."
    elif shape == 4:
        one = (f"{p} lived a first decade in {city} before taking up "
               f"work as a {role} around {year}.")
    elif shape == 5:
        one = (f"{p} is regarded as a {adj} {role}; the rolls of {city} "
               f"list a {year} arrival.")
    elif shape == 6:
        # birth explicitly marked in a single role+city+year sentence —
        # the dominant real-biography shape; birth-year questions train
        # against year DISTRACTORS only when the boiler marks birth (see
        # make_instance birth_marked)
        one = f"{p} is a {adj} {role}, born at {city} in {year}."
    if one is not None:
        return [one], {"role": 0, "city": 0, "year": 0}
    if shape == 7:
        # two-sentence split: role alone, then city+birth year via a
        # possessive opener (the normalization drill in features._norm)
        return ([f"{p} earned a name as a {adj} {role}.",
                 f"{p}'s first seasons ran their course at {city}, and "
                 f"{year} stands recorded as {p}'s year of birth."],
                {"role": 0, "city": 1, "year": 1})
    if shape == 8:
        # three-way split, one attribute per sentence
        return ([f"{p} works as a {adj} {role}.",
                 f"{p} was raised around {city}.",
                 f"Born in {year}, {p} still holds ties there."],
                {"role": 0, "city": 1, "year": 2})
    if shape == 9:
        # of-object role + locational-prep city/year (the construct real
        # biographies use; features.py ch18-19)
        return ([f"{p} has given a long stretch to the work of a {adj} {role}.",
                 f"{p} first drew breath at {city} in {year}."],
                {"role": 0, "city": 1, "year": 1})
    # shape 10: role as of-object mid-sentence, birth year in its own
    # marked sentence
    return ([f"{p}, raised near {city}, holds to the trade of {role}.",
             f"The year {year} saw {p}'s birth."],
            {"role": 0, "city": 0, "year": 1})


# ------------------------------------------------------- fact rendering

def _render_fact(rng: random.Random, subj: str, obj: str, obj_kind: str,
                 extra_entity: Optional[str] = None) -> str:
    """One fact sentence with a freshly sampled relation surface."""
    vp = rng.choice(_VERBS)
    noun = rng.choice(_NOUNS)
    style = rng.randrange(4)
    if obj_kind == "year":
        anchor = extra_entity or f"the {noun}"
        if style == 0:
            return f"{subj} {vp} {anchor} in {obj}."
        if style == 1:
            return f"In {obj}, {subj} {vp} {anchor}."
        if style == 2:
            return f"{obj} marked the season {subj} {vp} {anchor}."
        return f"{subj} first {vp} {anchor} back in {obj}."
    if obj_kind == "noun":
        # styles 4-5: the answer is the OBJECT OF "of", after a competing
        # abstract noun — real prose writes "the stewardship of the
        # dulcimer" / "the craft of volcanology"; the reader must prefer
        # the of-object over the first the-noun (features.py ch18)
        style = rng.randrange(7)
        if style == 0:
            return f"{subj} {vp} the {obj} for ages."
        if style == 1:
            return f"The {obj} remained {subj}'s chosen field."
        if style == 2:
            return f"{subj} gave long seasons to the {obj}."
        if style == 3:
            return f"Much of {subj}'s renown rests on the {obj}."
        if style == 4:
            return f"{subj} tends a long {noun} of the {obj}."
        if style == 5:
            return f"The {noun} of the {obj} has filled {subj}'s days."
        return f"{subj} upholds a steady {noun} on the {obj}."
    # person / org / city objects
    if style == 0:
        return f"{subj} {vp} the {noun} of {obj}."
    if style == 1:
        return f"{obj} and {subj} together {vp} a {noun}."
    if style == 2:
        return f"{subj} frequently {vp} works alongside {obj}."
    return f"At the request of {obj}, {subj} {vp} a {noun}."


def _render_question(rng: random.Random, subj: str, obj_kind: str,
                     extra_entity: Optional[str] = None,
                     cat: Optional[str] = None) -> str:
    """Question re-describing the relation WITHOUT the fact's verb phrase."""
    qv = rng.choice(_REL_Q)
    if obj_kind == "person":
        return rng.choice([
            f"Who {qv} {subj}?",
            f"Which person is associated with {subj}?",
            f"Name the figure linked to {subj}.",
        ])
    if obj_kind == "org":
        return rng.choice([
            f"Which organization is tied to {subj}?",
            f"What group did {subj} have dealings with?",
        ])
    if obj_kind == "year":
        anchor = extra_entity or "it"
        return rng.choice([
            f"In what year did {subj} engage with {anchor}?",
            f"When was {subj} occupied with {anchor}?",
            f"What year connects {subj} and {anchor}?",
        ])
    # noun object. A pseudo-word category (35%) drills the fallback the v5
    # transfer needs: an UNKNOWN category word must still route to the
    # lowercase noun in the anchor's appended fact, not to the boilerplate
    # role (tools/diag_reader_v5.py showed unknown categories regressing to
    # profession guesses).
    c = cat or (_pseudo_word(rng, 2) if rng.random() < 0.5
                else rng.choice(_Q_CATS))
    return rng.choice([
        f"Which {c} is {subj} identified with?",
        f"What {c} does {subj} follow?",
        f"For what {c} is {subj} recognized?",
        f"What {c} is {subj} known for?",
        f"Which {c} does {subj} perform in?",
    ])


# --------------------------------------------------------- world builder

FAMILIES = ("rel_person", "rel_year", "rel_noun", "rel_org",
            "role_1hop", "city_1hop", "byear_1hop",
            "role_2hop", "city_2hop", "year_2hop", "org_honoree_role",
            "noun_holder_attr", "succession",
            # round-5 additions targeting the v5 transfer failures
            # (tools/diag_reader_v5.py): capitalized thing anchors, symmetric
            # pair relations with possessive-hop questions. Listed twice for
            # 2x round-robin weight — they cover 6 of the 8 weak qtypes.
            "capthing_holder_attr", "pair_rel", "pair_rel_attr",
            "capthing_holder_attr", "pair_rel", "pair_rel_attr")


def make_instance(rng: random.Random,
                  family: Optional[str] = None) -> Instance:
    """One (question, evidence, answer) item over a freshly sampled world."""
    fam = family or rng.choice(FAMILIES)
    n_paras = 5 + rng.randrange(4)
    people = _world_people(rng, n_paras)
    info = {p: {"adj": rng.choice(_ADJS + [_demonym(rng)]),
                "role": _role(rng), "city": _city(rng),
                "year": _year(rng)} for p in people}
    shape_pool = list(range(11))
    rng.shuffle(shape_pool)
    # per-world: most paragraphs share one boilerplate shape (the repeated-
    # template signal the novelty channel keys on), a couple diverge
    main_shape = shape_pool[0]
    shapes = {p: (main_shape if rng.random() < 0.75
                  else rng.choice(shape_pool[1:])) for p in people}

    subj = people[0]
    other = people[1]

    # birth-year questions: when the asked person's boilerplate MARKS birth
    # (shapes 3/6 say "born"), year distractors stay in the paragraph and the
    # model must disambiguate by the birth context — the regularity real
    # biographies (and eval/synth.py boilers) rely on. Unmarked boilers keep
    # the old exclusion (a bare when-born question is unresolvable there).
    # pair families ask from either side — draw the split BEFORE paragraph
    # construction so distractor exclusions target the right paragraph
    pair_asker, pair_answer = ((subj, other) if rng.random() < 0.5
                               else (other, subj))
    year_target = {"byear_1hop": subj, "year_2hop": other,
                   "capthing_holder_attr": subj, "pair_rel_attr": pair_answer,
                   "noun_holder_attr": subj}.get(fam)
    pair_attr = (rng.choice(["year", "city", "role"])
                 if fam in ("capthing_holder_attr", "pair_rel_attr") else None)
    birth_marked = False
    if year_target is not None and (
            fam in ("byear_1hop", "year_2hop")
            or pair_attr == "year" or fam == "noun_holder_attr"):
        birth_marked = rng.random() < 0.85
        if birth_marked:
            shapes[year_target] = rng.choice([3, 6, 7, 8, 9, 10])

    # the queried fact (relation families) or boilerplate target
    extra_entity = None
    obj_kind, obj = "person", other
    if fam == "rel_person":
        obj_kind, obj = "person", other
    elif fam == "rel_year":
        obj_kind, obj = "year", _year(rng)
        extra_entity = (("the " + _pseudo_word(rng, 2).capitalize() + " "
                         + rng.choice(_NOUNS).capitalize())
                        if rng.random() < 0.5 else other)
    elif fam == "rel_noun":
        obj_kind, obj = "noun", rng.choice(_OBJ_NOUNS)
    elif fam == "rel_org":
        obj_kind, obj = "org", _org(rng)
    elif fam == "noun_holder_attr":
        # anchor noun + asked attribute chosen HERE so the distractor loop
        # can exclude colliding facts (a second holder of the anchor noun,
        # or a year fact beside an asked birth year, is label noise)
        obj_kind, obj = "noun", rng.choice(_OBJ_NOUNS)
        extra_entity = rng.choice(["year", "city", "role"])  # reused as attr

    paragraphs: List[List[str]] = []
    boiler_at: Dict[int, Tuple[int, Dict[str, int]]] = {}
    for i, p in enumerate(people):
        sents = []
        if rng.random() < 0.5:
            # title fragment, as _clean_sentences emits at block starts
            sents.append(f"{p}.")
        bs, boff = _boiler(rng, shapes[p], p, info[p])
        boiler_at[i] = (len(sents), boff)
        sents.extend(bs)
        kinds = ["person", "year", "noun", "org"]
        if i == 0 and fam.startswith("rel_"):
            # the GOLD paragraph excludes distractors of the queried kind —
            # a second same-typed object with no disambiguating overlap is
            # label noise, not signal
            kinds = [k for k in kinds if k != obj_kind]
        if i == 0 and fam in ("role_2hop", "city_2hop", "year_2hop"):
            # first-hop ambiguity: a second person fact on the anchor would
            # make "the person who <rel> subj" unresolvable
            kinds = [k for k in kinds if k != "person"]
        if i == 0 and fam == "noun_holder_attr":
            # unique noun anchor; and no year fact beside an asked birth year
            # UNLESS the boiler marks birth (birth_marked drill)
            kinds = [k for k in kinds if k != "noun"
                     and not (k == "year" and extra_entity == "year"
                              and not birth_marked)]
        if i in (0, 1) and fam in ("pair_rel", "pair_rel_attr"):
            # a second person fact on either pair member's paragraph would
            # make "who is X's partner" / the hop unresolvable
            kinds = [k for k in kinds if k != "person"]
        if i == 0 and fam == "capthing_holder_attr" and pair_attr == "year" \
                and not birth_marked:
            kinds = [k for k in kinds if k != "year"]
        if (fam == "pair_rel_attr" and pair_attr == "year"
                and not birth_marked and people[i] == pair_answer):
            kinds = [k for k in kinds if k != "year"]
        if ((i == 0 and fam == "byear_1hop")
                or (i == 1 and fam == "year_2hop")):
            # a year-object fact beside the boilerplate birth year is
            # unresolvable by a bare when-born question — unless the boiler
            # marks birth explicitly (birth_marked drill)
            if not birth_marked:
                kinds = [k for k in kinds if k != "year"]
        for _ in range(1 + rng.randrange(2)):
            dk = rng.choice(kinds)
            if dk == "person":
                dobj = rng.choice([x for x in people if x != p])
            elif dk == "org":
                dobj = _org(rng)
            elif dk == "year":
                dobj = _year(rng)
            else:
                dobj = rng.choice([x for x in _OBJ_NOUNS if x != obj])
            sents.append(_render_fact(rng, p, dobj, dk))
        paragraphs.append(sents)

    def _boiler_sent_local(pi: int, attr: str = "role") -> int:
        start, boff = boiler_at[pi]
        return start + boff.get(attr, 0)

    gold_para = 0
    if fam.startswith("rel_"):
        paragraphs[0].append(_render_fact(rng, subj, obj, obj_kind,
                                          extra_entity=extra_entity))
        answer = obj
        gold_sentence_local = len(paragraphs[0]) - 1
        question = _render_question(rng, subj, obj_kind,
                                    extra_entity=extra_entity)
    elif fam == "role_1hop":
        answer = info[subj]["role"]
        gold_sentence_local = _boiler_sent_local(0, "role")
        question = rng.choice(_ROLE_Q).format(p=subj)
    elif fam == "city_1hop":
        answer = info[subj]["city"]
        gold_sentence_local = _boiler_sent_local(0, "city")
        question = rng.choice(_CITY_Q).format(p=subj)
    elif fam == "byear_1hop":
        answer = info[subj]["year"]
        gold_sentence_local = _boiler_sent_local(0, "year")
        question = rng.choice(_BYEAR_Q).format(p=subj)
    elif fam == "org_honoree_role":
        # org paragraph names a person; the question asks that person's role
        org = _org(rng)
        org_city = _city(rng)
        link = rng.choice([
            f"{org} is a {rng.choice(_ORG_KINDS)} seated in {org_city}; "
            f"its rolls open with {other}.",
            f"{org}, a {rng.choice(_ORG_KINDS)} of {org_city}, lists "
            f"{other} first among its founders' kin.",
        ])
        paragraphs.append([f"{org}.", link])
        answer = info[other]["role"]
        gold_para = 1
        gold_sentence_local = _boiler_sent_local(1, "role")
        question = rng.choice(_ROLE_Q_HOP).format(
            rel="is first listed by", p=org)
    elif fam == "noun_holder_attr":
        # noun-anchored hop (the person_by_instrument SHAPE, no v5 vocab):
        # the question names only a distinctive OBJECT; the answer is an
        # attribute from the boilerplate of the person tied to that object.
        # Trains "resolve a noun anchor to its person, then read the
        # person's paragraph" — the question contains no person name at all.
        distinct_obj = obj
        paragraphs[0].append(_render_fact(rng, subj, distinct_obj, "noun"))
        attr = extra_entity
        extra_entity = None
        answer = info[subj][attr]
        gold_sentence_local = _boiler_sent_local(0, attr)
        holder = rng.choice(["the one known for", "the figure identified with",
                             "the person linked to", "whoever works in"])
        if attr == "year":
            question = rng.choice([
                f"Which year saw the birth of {holder} the {distinct_obj}?",
                f"When was {holder} the {distinct_obj} born?",
            ])
        elif attr == "city":
            question = rng.choice([
                f"What is the home city of {holder} the {distinct_obj}?",
                f"Where did {holder} the {distinct_obj} grow up?",
            ])
        else:
            question = rng.choice([
                f"What occupation does {holder} the {distinct_obj} hold?",
                f"What is the profession of {holder} the {distinct_obj}?",
            ])
    elif fam == "capthing_holder_attr":
        # capitalized THING anchor (award/title-shaped): the question names
        # only the thing; its carrying sentence names the person, whose
        # boilerplate holds the asked attribute (the award_holder SHAPE,
        # zero v5 surface). The thing name is world-unique by construction.
        thing = (_pseudo_word(rng, 2).capitalize() + " "
                 + rng.choice(_THING_SUFFIX))
        vp = rng.choice(_VERBS)
        yr2 = _year(rng)
        style = rng.randrange(3)
        if style == 0:
            link = f"{subj} {vp} the {thing} in {yr2}."
        elif style == 1:
            link = f"In {yr2}, the {thing} was {vp} by {subj}."
        else:
            link = f"The {thing} rests with {subj}."
        paragraphs[0].append(link)
        answer = info[subj][pair_attr]
        gold_sentence_local = _boiler_sent_local(0, pair_attr)
        holder = rng.choice(["the holder of", "the bearer of",
                             "the keeper of", "the winner of"])
        if pair_attr == "year":
            question = rng.choice([
                f"In what year was {holder} the {thing} born?",
                f"Which year saw the birth of {holder} the {thing}?",
            ])
        elif pair_attr == "city":
            question = rng.choice([
                f"What is the home city of {holder} the {thing}?",
                f"Where did {holder} the {thing} grow up?",
            ])
        else:
            question = rng.choice([
                f"What occupation does {holder} the {thing} hold?",
                f"What is the profession of {holder} the {thing}?",
                f"How does {holder} the {thing} make a living?",
            ])
    elif fam in ("pair_rel", "pair_rel_attr"):
        # symmetric pair fact (two people in one sentence, optional year):
        # asked from EITHER side via a generic kin noun — the possessive-hop
        # question surface ("X's partner", "the counterpart of X") the
        # verb-relative 2-hop families never produce
        a, b = subj, other
        vp = rng.choice(_VERBS)
        noun = rng.choice(_NOUNS)
        yr2 = _year(rng)
        style = rng.randrange(3)
        if style == 0:
            link = f"{a} {vp} a {noun} with {b} in {yr2}."
        elif style == 1:
            link = f"Since {yr2}, {a} and {b} have jointly {vp} the {noun}."
        else:
            link = f"{a} and {b} {vp} a {noun} together."
        paragraphs[0].append(link)
        asker, answer_person = pair_asker, pair_answer
        kin = rng.choice(_KIN)
        if fam == "pair_rel":
            answer = answer_person
            gold_sentence_local = len(paragraphs[0]) - 1
            question = rng.choice([
                f"To whom is {asker} joined?",
                f"Who is {asker}'s {kin}?",
                f"With whom did {asker} share a {noun}?",
                f"Name the {kin} of {asker}.",
            ])
        else:
            answer = info[answer_person][pair_attr]
            gold_para = people.index(answer_person)
            gold_sentence_local = _boiler_sent_local(gold_para, pair_attr)
            if pair_attr == "year":
                question = rng.choice([
                    f"In what year was {asker}'s {kin} born?",
                    f"Which year saw the birth of the {kin} of {asker}?",
                ])
            elif pair_attr == "city":
                question = rng.choice([
                    f"Which city does the {kin} of {asker} come from?",
                    f"What is the home city of {asker}'s {kin}?",
                ])
            else:
                question = rng.choice([
                    f"What occupation does {asker}'s {kin} hold?",
                    f"What is the calling of the {kin} of {asker}?",
                    f"How does the {kin} of {asker} make a living?",
                ])
    elif fam == "succession":
        # ordered three-entity relation: two people and an org in ONE
        # sentence, where WHICH person answers depends on the asked
        # direction. Trains argument-order sensitivity (the successor/
        # predecessor SHAPE) with a fresh verb surface per instance.
        org = _org(rng)
        a, b = other, people[2]
        vp = rng.choice(_VERBS)
        noun = rng.choice(_NOUNS)
        style = rng.randrange(3)
        if style == 0:
            link = f"At {org}, {b} {vp} the {noun} once held by {a}."
        elif style == 1:
            link = f"{b} {vp} the {noun} of {org} right after {a} stepped away."
        else:
            link = f"When {a} left {org}, it was {b} who {vp} its {noun}."
        paragraphs[0].append(link)
        if rng.random() < 0.5:
            answer = b
            question = rng.choice([
                f"Who came after {a} at {org}?",
                f"Who took over from {a} at {org}?",
                f"Name the person who replaced {a} at {org}.",
                f"Who followed {a} at {org}?",
            ])
        else:
            answer = a
            question = rng.choice([
                f"Who came before {b} at {org}?",
                f"Whom did {b} replace at {org}?",
                f"Who preceded {b} at {org}?",
                f"Whom did {b} follow at {org}?",
                f"Who held the post before {b} at {org}?",
            ])
        gold_sentence_local = len(paragraphs[0]) - 1
    else:
        # 2-hop: link fact in subj's paragraph, attribute in other's boiler
        rel_surface = rng.choice(_REL_Q)
        paragraphs[0].append(_render_fact(rng, subj, other, "person"))
        gold_para = 1
        attr2 = {"role_2hop": "role", "city_2hop": "city"}.get(fam, "year")
        gold_sentence_local = _boiler_sent_local(1, attr2)
        if fam == "role_2hop":
            answer = info[other]["role"]
            question = rng.choice(_ROLE_Q_HOP).format(rel=rel_surface, p=subj)
        elif fam == "city_2hop":
            answer = info[other]["city"]
            question = rng.choice(_CITY_Q_HOP).format(rel=rel_surface, p=subj)
        else:
            answer = info[other]["year"]
            question = rng.choice([
                f"In what year was the person who {rel_surface} {subj} born?",
                f"Which year saw the birth of the figure who {rel_surface} "
                f"{subj}?",
            ])

    # pseudo-word pools occasionally collide: a city/name answer can end up a
    # substring of a name IN the question (e.g. city "Denner" vs person
    # "Vindis Denner"), which both violates the dataset invariant and teaches
    # a span the inference path rejects — resample the world (rate ~0.05%)
    if answer.lower() in question.lower():
        return make_instance(rng, family=fam)

    # shuffle paragraph order (the gold paragraph is not always first)
    order = list(range(len(paragraphs)))
    rng.shuffle(order)
    sentences: List[str] = []
    gold_sentence = -1
    seen_sents = 0
    for pos, pi in enumerate(order):
        if pos > 0:
            sentences.append("")
        for si, s in enumerate(paragraphs[pi]):
            if pi == gold_para and si == gold_sentence_local:
                gold_sentence = seen_sents
            sentences.append(s)
            seen_sents += 1
    return Instance(question, sentences, answer, gold_sentence)


# ------------------------------------------------------------ batch prep

def build_training_arrays(n_items: int, seed: int = 7):
    """Featurized arrays + gold span targets for ``n_items`` instances.

    Families round-robin for balance. Items whose gold span fell outside
    the token window are dropped (rare: long worlds truncated at E_LEN).
    """
    import numpy as np

    from ahrag_tpu_torch.models.reader.features import featurize, stack

    rng = random.Random(seed)
    feats, starts, ends = [], [], []
    fam_i = 0
    while len(feats) < n_items:
        inst = make_instance(rng, family=FAMILIES[fam_i % len(FAMILIES)])
        fam_i += 1
        fb, ev = featurize(inst.question, inst.sentences)
        span = _locate(ev, inst)
        if span is None:
            continue
        s, e = span
        feats.append(fb)
        starts.append(s)
        ends.append(e)
    return stack(feats), (np.asarray(starts, np.int32),
                          np.asarray(ends, np.int32))


def _locate(ev, inst: Instance) -> Optional[Tuple[int, int]]:
    """Token positions of the answer inside the gold sentence."""
    from ahrag_tpu_torch.models.reader.features import _tokenize

    ans_toks = [t.lower() for t in _tokenize(inst.answer)]
    if not ans_toks:
        return None
    for i in range(len(ev.tokens)):
        if ev.sent_index[i] != inst.gold_sentence:
            continue
        j = i + len(ans_toks) - 1
        if j >= len(ev.tokens) or ev.sent_index[j] != inst.gold_sentence:
            continue
        if [t.lower() for t in ev.tokens[i:j + 1]] == ans_toks:
            return i, j
    return None
