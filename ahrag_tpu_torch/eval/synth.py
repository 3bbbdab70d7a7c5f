"""Deterministic adversarial QA dataset generator (held-out evaluation).

The port's copy of ``ahrag_tpu/eval/synth.py``, pure Python on
``random.Random``: the same seeds give the same worlds and items, so it
regenerates every frozen ``samples/synth_*`` file byte for byte.

    python -m ahrag_tpu_torch.eval.synth --split dev --version v2 --out FILE.jsonl

- a synthetic *world* of people / films / organizations / cities with typed
  relations, rendered into one Wikipedia-style paragraph per entity;
- multi-hop (bridge), comparison, attribute-description, temporal and location
  question families, each phrased through paraphrase templates whose relation
  vocabulary is deliberately **disjoint from the corpus vocabulary** ("helmed"
  vs "directed", "base of operations" vs "headquarters") so lexical-overlap
  retrieval gets no free ride;
- per-item distractor paragraphs chosen adversarially (same profession / genre
  / country / surname as the gold entities), 2 gold + 8 distractors like
  HotpotQA's 10-paragraph contexts;
- disjoint split seeds (train=11, dev=22, test=33).

Items follow the benchmark-local JSONL schema (``cli/benchmark.py``
``load_local_jsonl``): ``{"id", "question", "answers", "context": {"title":
[...], "sentences": [[...]]}, "gold_titles", "qtype"}``.
"""
from __future__ import annotations

import argparse
import json
import random
import re
from typing import Any, Dict, List, Tuple

# ---------------------------------------------------------------------------
# World vocabulary (corpus-side). Relation verbs used in PARAGRAPHS live here;
# question templates below intentionally avoid these stems.
# ---------------------------------------------------------------------------

FIRST = ["Ada", "Boris", "Carmen", "Dmitri", "Elena", "Farid", "Greta", "Hugo",
         "Ingrid", "Jonas", "Katya", "Luca", "Mireille", "Nadia", "Oskar",
         "Priya", "Quentin", "Rosa", "Stefan", "Tomoko", "Ulrich", "Vera",
         "Wendell", "Ximena", "Yusuf", "Zofia"]
LAST = ["Albrecht", "Barros", "Cervantes", "Delacroix", "Eriksson", "Fontaine",
        "Grigoriev", "Hartmann", "Ibanez", "Jankowski", "Kovacs", "Lindqvist",
        "Moreau", "Novak", "Okafor", "Petrov", "Quiroga", "Rasmussen",
        "Sorensen", "Takahashi", "Ustinov", "Vasquez", "Weiss", "Yamamoto"]
COUNTRIES = [("Norway", "Norwegian"), ("Brazil", "Brazilian"),
             ("Japan", "Japanese"), ("Poland", "Polish"), ("Mexico", "Mexican"),
             ("France", "French"), ("Nigeria", "Nigerian"), ("Canada", "Canadian"),
             ("Hungary", "Hungarian"), ("Spain", "Spanish")]
CITIES = [("Bergen", "Norway"), ("Porto Alegre", "Brazil"), ("Sendai", "Japan"),
          ("Krakow", "Poland"), ("Guadalajara", "Mexico"), ("Lyon", "France"),
          ("Ibadan", "Nigeria"), ("Halifax", "Canada"), ("Debrecen", "Hungary"),
          ("Valencia", "Spain"), ("Tromso", "Norway"), ("Recife", "Brazil"),
          ("Nagoya", "Japan"), ("Gdansk", "Poland"), ("Monterrey", "Mexico")]
PROFESSIONS = ["marine biologist", "volcanologist", "jazz pianist",
               "sculptor", "astronomer", "architect", "chess grandmaster",
               "opera singer", "mathematician", "glassblower", "cartographer",
               "mycologist"]
GENRES = ["science fiction", "western", "documentary", "animated", "thriller",
          "romantic comedy", "horror", "musical", "war", "noir"]
TITLE_ADJ = ["Silent", "Crimson", "Wandering", "Forgotten", "Luminous",
             "Hollow", "Emerald", "Restless", "Distant", "Burning", "Frozen",
             "Gilded", "Violet", "Thundering"]
TITLE_NOUN = ["Harbor", "Meridian", "Orchard", "Lantern", "Causeway", "Tides",
              "Summit", "Archive", "Furnace", "Colonnade", "Monsoon", "Quarry",
              "Observatory", "Labyrinth"]
ORG_HEAD = ["Harbor", "Meridian", "Northlight", "Cobalt", "Juniper", "Vantage",
            "Ironwood", "Solstice", "Palisade", "Riverbend"]
ORG_TAIL = ["Institute", "Collective", "Foundation", "Consortium",
            "Observatory", "Guild", "Society", "Laboratory"]

# ---------------------------------------------------------------------------
# XL pool extensions (shared-KB corpus-scale worlds only). The base pools
# above are FROZEN — tests/test_synth_eval.py pins the committed v1-v4 splits
# to byte-identical regeneration, and extending a base list would change the
# shuffle outcome for every existing seed. XL worlds use base + extension.
# Descriptor-space math: _unique_people_by_desc needs (nationality,
# profession) singletons, so pairs must scale with n_people — 20 countries x
# 48 professions = 960 pairs keeps ~350 of 1,200 people uniquely describable.
# New countries are chosen so qa.py::_same_place resolves their demonyms
# (suffix-stripped stems or consonant skeletons); no gazetteer exists.
# ---------------------------------------------------------------------------

FIRST_XL = ["Anouk", "Bela", "Cyrus", "Dalia", "Emeka", "Freya", "Gaspard",
            "Hana", "Ivo", "Jara", "Kenji", "Leona", "Matteo", "Nils"]
LAST_XL = ["Aalto", "Bianchi", "Castellanos", "Duarte", "Egorov", "Fischer",
           "Galvan", "Horvath", "Iwata", "Jimenez", "Keller", "Lombardi",
           "Mbeki", "Nakamura", "Oliveira", "Pavlov"]
COUNTRIES_XL = [("Germany", "German"), ("Italy", "Italian"),
                ("Portugal", "Portuguese"), ("Kenya", "Kenyan"),
                ("Chile", "Chilean"), ("India", "Indian"),
                ("Vietnam", "Vietnamese"), ("Austria", "Austrian"),
                ("Ghana", "Ghanaian"), ("Peru", "Peruvian")]
CITIES_XL = [("Hamburg", "Germany"), ("Leipzig", "Germany"),
             ("Turin", "Italy"), ("Bologna", "Italy"),
             ("Coimbra", "Portugal"), ("Braga", "Portugal"),
             ("Mombasa", "Kenya"), ("Kisumu", "Kenya"),
             ("Valparaiso", "Chile"), ("Antofagasta", "Chile"),
             ("Pune", "India"), ("Mysore", "India"),
             ("Danang", "Vietnam"), ("Hue", "Vietnam"),
             ("Graz", "Austria"), ("Linz", "Austria"),
             ("Kumasi", "Ghana"), ("Tamale", "Ghana"),
             ("Arequipa", "Peru"), ("Cusco", "Peru")]
PROFESSIONS_XL = ["horologist", "paleontologist", "oceanographer",
                  "typographer", "luthier", "falconer", "apiarist",
                  "milliner", "cellist", "engraver", "choreographer",
                  "puppeteer", "blacksmith", "meteorologist", "linguist",
                  "botanist", "historian", "sommelier", "acrobat",
                  "illustrator", "stonemason", "perfumer", "geologist",
                  "archivist", "economist", "playwright", "photographer",
                  "novelist", "violinist", "ceramicist", "entomologist",
                  "seismologist", "bookbinder", "glaciologist",
                  "ornithologist", "printmaker"]
GENRES_XL = ["heist", "espionage", "dystopian", "biographical", "courtroom",
             "swashbuckling", "psychological", "anthology", "surrealist",
             "mockumentary"]
TITLE_ADJ_XL = ["Amber", "Scarlet", "Ashen", "Whispering", "Shattered",
                "Verdant", "Midnight", "Obsidian", "Copper", "Veiled",
                "Nameless"]
TITLE_NOUN_XL = ["Estuary", "Viaduct", "Citadel", "Crossing", "Paddock",
                 "Aqueduct"]
ORG_HEAD_XL = ["Bluewater", "Stonegate", "Kestrel", "Larkspur", "Tidewater",
               "Greenfield"]
ORG_TAIL_XL = ["Syndicate", "Alliance", "Atelier", "Bureau", "Cooperative",
               "Union"]


# ---------------------------------------------------------------------------
# v2 surface realizations.
#
# Round-2 verdict: answer/qa.py's fact patterns were one-to-one with the v1
# corpus renderers below, so F1 measured template coverage, not generalization.
# v2 renders every paragraph through one of >=3 alternative realizations per
# entity type (passive voice, appositives, cross-sentence coreference, synonym
# verb sets) whose RELATION MARKERS — the static phrases that carry each fact —
# are provably disjoint from every literal in answer/qa.py and
# answer/extractive.py. tools/audit_synth_disjoint.py (run as a CI test)
# enforces that disjointness mechanically, in both directions: markers must
# appear in generated v2 text, and must never appear in the answerer sources.
# ---------------------------------------------------------------------------

V2_RELATION_MARKERS: Dict[str, List[str]] = {
    "person2": ["hailing from", "took up the craft of", "early years passed in",
                "came into the world in"],
    "person3": ["entered the world at", "practices as a"],
    "person4": ["by heritage", "devoted to days spent as a",
                "traces family roots to"],
    "film2": ["called the shots on", "arrived in cinemas in",
              "fronts the ensemble", "its narrative is anchored in"],
    "film3": ["offerings of", "steered from script to screen by",
              "anchors the ensemble", "forms the backdrop"],
    "film4": ["opened to audiences in", "the camera answered to",
              "carries the leading role", "frames the scenery"],
    "org2": ["came into being in", "through the efforts of",
             "maintains its seat in"],
    "org3": ["owes its existence to", "conducts its affairs out of"],
    "org4": ["the brainchild of", "has kept its principal offices in"],
    "city2": ["lies inside"],
    "city3": ["among the urban centers of", "one finds"],
    "city4": ["counts among", "municipalities"],
}


def _person_paragraph_v2(p: Dict[str, Any], variant: int) -> Tuple[str, List[str]]:
    n = p["name"]
    if variant == 0:  # person2: country (not adjective) + craft phrasing
        sents = [
            f"Hailing from {p['country']}, {n} took up the craft of "
            f"{p['profession']}.",
            f"{n}'s early years passed in {p['birth_city']}, where {n} came "
            f"into the world in {p['birth_year']}.",
        ]
    elif variant == 1:  # person3: appositive classification
        sents = [
            f"{n}, a {p['nationality']} {p['profession']}, entered the world "
            f"at {p['birth_city']} in {p['birth_year']}.",
            f"To this day, {n} practices as a {p['profession']}.",
        ]
    else:  # person4: cross-sentence coreference
        sents = [
            f"The life of {n} has been devoted to days spent as a "
            f"{p['profession']}.",
            f"{p['nationality']} by heritage, {n} traces family roots to "
            f"{p['birth_city']}, arriving there in {p['birth_year']}.",
        ]
    return n, sents


def _film_paragraph_v2(f: Dict[str, Any], variant: int) -> Tuple[str, List[str]]:
    t, d, s = f["title"], f["director"]["name"], f["star"]["name"]
    if variant == 0:  # film2
        sents = [
            f"{d} called the shots on {t}, a {f['genre']} feature that "
            f"arrived in cinemas in {f['year']}.",
            f"{s} fronts the ensemble, and its narrative is anchored in "
            f"{f['city'][0]}.",
        ]
    elif variant == 1:  # film3
        sents = [
            f"Among the {f['genre']} offerings of {f['year']}, {t} stands "
            f"apart.",
            f"{t} was steered from script to screen by {d}, while {s} anchors "
            f"the ensemble.",
            f"{f['city'][0]} forms the backdrop.",
        ]
    else:  # film4
        sents = [
            f"{t} opened to audiences in {f['year']} as a work of "
            f"{f['genre']} cinema.",
            f"On {t}, the camera answered to {d}; {s} carries the leading "
            f"role, and {f['city'][0]} frames the scenery.",
        ]
    return t, sents


def _org_paragraph_v2(o: Dict[str, Any], variant: int) -> Tuple[str, List[str]]:
    n, f = o["name"], o["founder"]["name"]
    if variant == 0:  # org2
        sents = [
            f"{n} came into being in {o['year']} through the efforts of {f}.",
            f"The group maintains its seat in {o['city'][0]}.",
        ]
    elif variant == 1:  # org3
        sents = [
            f"{n} owes its existence to {f}, who put the venture in motion "
            f"in {o['year']}.",
            f"{n} conducts its affairs out of {o['city'][0]}.",
        ]
    else:  # org4
        sents = [
            f"Since {o['year']}, {n} — the brainchild of {f} — has kept its "
            f"principal offices in {o['city'][0]}.",
        ]
    return n, sents


def _city_paragraph_v2(city: Tuple[str, str], variant: int) -> Tuple[str, List[str]]:
    name, country = city
    if variant == 0:  # city2
        sents = [f"{name} lies inside {country}.",
                 f"{name} is celebrated for bustling markets and old universities."]
    elif variant == 1:  # city3
        sents = [f"Among the urban centers of {country} one finds {name}.",
                 f"{name} draws traders and scholars alike."]
    else:  # city4
        sents = [f"{name} counts among {country}'s municipalities.",
                 f"Markets and universities give {name} its reputation."]
    return name, sents


# ---------------------------------------------------------------------------
# v5: HELD-OUT relation schema (VERDICT r3 item 2 / "What's missing" #1).
#
# Every relation type in v1-v4 (direct/star/found/hq/birth/profession/...) has
# a hand-written counterpart in answer/qa.py's Facts tables — so F1 there
# measures "every family was hand-patched", not schema generalization. v5
# introduces SIX relation types the answerer has never seen (award-won,
# mentored-by, instrument-played, succeeded-as, named-after, married-to),
# rendered under the same audit discipline (markers provably disjoint from
# answerer literals, tools/audit_synth_disjoint.py). The protocol is
# two-numbered: the system is FIRST scored on v5 with qa.py / extractive.py /
# inference.py frozen at their v4 state (the zero-edit number — the honest
# generalization measurement), and only then may the answerer be extended,
# keeping the pre-fix number in the report.
#
# Extra facts attach to existing person/org paragraphs as appended sentences,
# one of >=3 surface realizations each, so retrieval topology (titles,
# distractor structure) matches v1-v4 exactly; only the relation schema is new.
# ---------------------------------------------------------------------------

AWARD_HEAD = ["Beacon", "Zenith", "Garnet", "Halcyon", "Polaris", "Quill",
              "Sapphire", "Tempest", "Wreath", "Cinder", "Lodestar", "Myrtle"]
AWARD_TAIL = ["Prize", "Medal", "Trophy", "Laurels", "Commendation",
              "Distinction"]
INSTRUMENTS = ["cello", "oboe", "marimba", "theremin", "bassoon", "zither",
               "accordion", "harpsichord", "dulcimer", "clarinet", "viola",
               "bandoneon"]

V5_RELATION_MARKERS: Dict[str, List[str]] = {
    "award": ["accepted the", "went to", "take home the"],
    "mentor": ["under their wing", "at the side of", "early guidance for"],
    "instrument": ["often heard on", "lifelong companion",
                   "devoted practice on"],
    "succeeded": ["picked up the reins from", "into the stewardship of",
                  "assumed the role"],
    "named_after": ["as a tribute to", "moniker commemorates",
                    "carries the name of"],
    "spouse": ["exchanged vows with", "keeps a household with",
               "have been wed"],
}


def _award_sentence(n: str, award: str, year: int, variant: int) -> str:
    if variant == 0:
        return f"{n} accepted the {award} in {year}."
    if variant == 1:
        return f"In {year}, the {award} went to {n}."
    return f"{year} saw {n} take home the {award}."


def _mentor_sentence(n: str, m: str, variant: int) -> str:
    if variant == 0:
        return f"{m} took {n} under their wing."
    if variant == 1:
        return f"{n} learned the trade at the side of {m}."
    return f"Early guidance for {n} came from {m}."


def _instrument_sentence(n: str, instr: str, variant: int) -> str:
    if variant == 0:
        return f"{n} is often heard on the {instr}."
    if variant == 1:
        return f"The {instr} has been {n}'s lifelong companion."
    return f"{n} keeps a devoted practice on the {instr}."


def _succeeded_sentence(n: str, s: str, o: str, variant: int) -> str:
    if variant == 0:
        return f"At {o}, {n} picked up the reins from {s}."
    if variant == 1:
        return f"{n} stepped into the stewardship of {o} after {s}."
    return f"When {s} left {o}, {n} assumed the role."


def _named_after_sentence(o: str, h: str, variant: int) -> str:
    if variant == 0:
        return f"{o} carries its title as a tribute to {h}."
    if variant == 1:
        return f"The group's moniker commemorates {h}."
    return f"{o} carries the name of {h} forward."


def _spouse_sentence(a: str, b: str, year: int, variant: int) -> str:
    if variant == 0:
        return f"{a} exchanged vows with {b} in {year}."
    if variant == 1:
        return f"Since {year}, {a} keeps a household with {b}."
    return f"{a} and {b} have been wed since {year}."


def attach_v5_extras(world: Dict[str, Any], rng: random.Random) -> None:
    """Attach the six held-out relation types to an existing world, in place.

    Facts append one extra sentence to the carrying entity's paragraph (the
    mentee's, the successor's, the first spouse's, the org's). Uniqueness is
    enforced where a question family needs it: awards and instruments are
    world-unique, successions/namesakes are one per org, mentor/spouse
    assignments are disjoint over people.
    """
    people = world["people"]
    orgs = world["orgs"]
    paras = world["paragraphs"]

    def _append(title: str, sent: str) -> None:
        paras[title] = paras[title] + [sent]

    n_slots = max(4, len(people) // 7)
    pool = people[:]
    rng.shuffle(pool)

    awards = [f"{h} {t}" for h in AWARD_HEAD for t in AWARD_TAIL]
    rng.shuffle(awards)
    world["awards"] = []
    for i in range(min(n_slots, len(pool))):
        p = pool.pop()
        award, year = awards[i], 1975 + rng.randrange(45)
        world["awards"].append({"person": p, "award": award, "year": year})
        _append(p["name"], _award_sentence(p["name"], award, year,
                                           rng.randrange(3)))

    world["mentors"] = []
    for _ in range(min(n_slots, len(pool) // 2)):
        mentee, mentor = pool.pop(), pool.pop()
        world["mentors"].append({"mentee": mentee, "mentor": mentor})
        _append(mentee["name"], _mentor_sentence(mentee["name"],
                                                 mentor["name"],
                                                 rng.randrange(3)))

    instrs = INSTRUMENTS[:]
    rng.shuffle(instrs)
    world["instruments"] = []
    for i in range(min(n_slots, len(pool), len(instrs))):
        p = pool.pop()
        world["instruments"].append({"person": p, "instrument": instrs[i]})
        _append(p["name"], _instrument_sentence(p["name"], instrs[i],
                                                rng.randrange(3)))

    world["spouses"] = []
    for _ in range(min(n_slots, len(pool) // 2)):
        a, b = pool.pop(), pool.pop()
        year = 1960 + rng.randrange(55)
        world["spouses"].append({"a": a, "b": b, "year": year})
        _append(a["name"], _spouse_sentence(a["name"], b["name"], year,
                                            rng.randrange(3)))

    world["successions"] = []
    world["namesakes"] = []
    for j, o in enumerate(orgs):
        others = [p for p in people if p["name"] != o["founder"]["name"]]
        if j % 2 == 0 and len(others) >= 2:
            succ, pred = rng.sample(others, 2)
            world["successions"].append({"org": o, "successor": succ,
                                         "predecessor": pred})
            _append(succ["name"], _succeeded_sentence(
                succ["name"], pred["name"], o["name"], rng.randrange(3)))
        elif others:
            h = rng.choice(others)
            world["namesakes"].append({"org": o, "honoree": h})
            _append(o["name"], _named_after_sentence(o["name"], h["name"],
                                                     rng.randrange(3)))


def _person_paragraph(p: Dict[str, Any]) -> Tuple[str, List[str]]:
    sents = [
        f"{p['name']} is a {p['nationality']} {p['profession']} who was born in "
        f"{p['birth_city']} in {p['birth_year']}.",
        f"{p['name']} began working as a {p['profession']} after moving away "
        f"from {p['birth_city']}.",
    ]
    return p["name"], sents


def _film_paragraph(f: Dict[str, Any]) -> Tuple[str, List[str]]:
    sents = [
        f"{f['title']} is a {f['year']} {f['genre']} film directed by "
        f"{f['director']['name']}.",
        f"The film stars {f['star']['name']} and is set in {f['city'][0]}.",
        f"{f['title']} was released in {f['year']} to wide attention.",
    ]
    return f["title"], sents


def _org_paragraph(o: Dict[str, Any]) -> Tuple[str, List[str]]:
    sents = [
        f"{o['name']} is an organization founded by {o['founder']['name']} in "
        f"{o['year']}.",
        f"The headquarters of {o['name']} are in {o['city'][0]}.",
    ]
    return o["name"], sents


def _city_paragraph(city: Tuple[str, str]) -> Tuple[str, List[str]]:
    name, country = city
    return name, [f"{name} is a city in {country}.",
                  f"{name} is known for its markets and universities."]


def make_world(rng: random.Random, n_people: int = 40, n_films: int = 18,
               n_orgs: int = 12, version: str = "v1",
               xl: bool = False) -> Dict[str, Any]:
    """Build a closed world of typed entities with non-ambiguous attributes.

    ``version="v2"`` renders every paragraph through one of the three v2
    surface realizations per entity type (sampled per paragraph) — the v1
    renderers are deliberately EXCLUDED from the v2 pool so the v2 corpus is
    template-disjoint from answer/qa.py (see V2_RELATION_MARKERS).

    ``xl=True`` appends the *_XL pool extensions (corpus-scale shared worlds:
    1,600 names / 500 titles / 400 genre-year pairs / 256 org names /
    960 nationality-profession descriptor pairs). Base-pool worlds are
    byte-stable across this change for every existing seed."""
    p_first = FIRST + FIRST_XL if xl else FIRST
    p_last = LAST + LAST_XL if xl else LAST
    p_countries = COUNTRIES + COUNTRIES_XL if xl else COUNTRIES
    p_cities = CITIES + CITIES_XL if xl else CITIES
    p_prof = PROFESSIONS + PROFESSIONS_XL if xl else PROFESSIONS
    p_genres = GENRES + GENRES_XL if xl else GENRES
    p_tadj = TITLE_ADJ + TITLE_ADJ_XL if xl else TITLE_ADJ
    p_tnoun = TITLE_NOUN + TITLE_NOUN_XL if xl else TITLE_NOUN
    p_ohead = ORG_HEAD + ORG_HEAD_XL if xl else ORG_HEAD
    p_otail = ORG_TAIL + ORG_TAIL_XL if xl else ORG_TAIL
    names = [f"{f} {l}" for f in p_first for l in p_last]
    rng.shuffle(names)
    people = []
    for i in range(n_people):
        country, nationality = p_countries[rng.randrange(len(p_countries))]
        cities = [c for c in p_cities if c[1] == country] or p_cities
        people.append({
            "name": names[i], "country": country, "nationality": nationality,
            "birth_city": rng.choice(cities)[0],
            "birth_year": 1930 + rng.randrange(60),
            "profession": rng.choice(p_prof),
        })
    titles = [f"The {a} {n}" for a in p_tadj for n in p_tnoun]
    rng.shuffle(titles)
    # (genre, year) must be unique world-wide so attribute-description
    # questions ("the <genre> film from <year>") are never ambiguous
    gy = [(g, 1960 + y) for g in p_genres for y in range(0, 60, 3)]
    rng.shuffle(gy)
    films = []
    for i in range(n_films):
        director, star = rng.sample(people, 2)
        genre, year = gy[i]
        films.append({"title": titles[i], "genre": genre, "year": year,
                      "director": director, "star": star,
                      "city": rng.choice(p_cities)})
    orgnames = [f"{h} {t}" for h in p_ohead for t in p_otail]
    rng.shuffle(orgnames)
    orgs = [{"name": orgnames[i], "founder": rng.choice(people),
             "year": 1900 + rng.randrange(110), "city": rng.choice(p_cities)}
            for i in range(n_orgs)]
    paragraphs: Dict[str, List[str]] = {}
    kinds: Dict[str, str] = {}
    v2 = version == "v2"
    for p in people:
        t, s = (_person_paragraph_v2(p, rng.randrange(3)) if v2
                else _person_paragraph(p))
        paragraphs[t], kinds[t] = s, "person"
    for f in films:
        t, s = (_film_paragraph_v2(f, rng.randrange(3)) if v2
                else _film_paragraph(f))
        paragraphs[t], kinds[t] = s, "film"
    for o in orgs:
        t, s = (_org_paragraph_v2(o, rng.randrange(3)) if v2
                else _org_paragraph(o))
        paragraphs[t], kinds[t] = s, "org"
    for c in p_cities:
        t, s = _city_paragraph_v2(c, rng.randrange(3)) if v2 else _city_paragraph(c)
        paragraphs[t], kinds[t] = s, "city"
    return {"people": people, "films": films, "orgs": orgs,
            "paragraphs": paragraphs, "kinds": kinds, "version": version}


# ---------------------------------------------------------------------------
# Question families. Each returns (question, answers, gold_titles, avoid).
# ``avoid`` lists paragraph titles that would make the question ambiguous if
# sampled as distractors. Question relation vocabulary deliberately avoids the
# corpus stems (direct*, star*, found*, headquarter*, release*, born).
# ---------------------------------------------------------------------------

def _q_director_of_film(w, rng):
    f = rng.choice(w["films"])
    q = rng.choice([
        f"Who helmed {f['title']}?",
        f"Which filmmaker was behind {f['title']}?",
        f"Who made the movie {f['title']}?",
    ])
    return q, [f["director"]["name"]], [f["title"]], []


def _q_film_by_attrs(w, rng):
    f = rng.choice(w["films"])
    q = rng.choice([
        f"Who helmed the {f['genre']} movie that premiered in {f['year']}?",
        f"Which filmmaker made the {f['genre']} picture from {f['year']}?",
    ])
    avoid = [g["title"] for g in w["films"]
             if g is not f and (g["genre"] == f["genre"] or g["year"] == f["year"])]
    return q, [f["director"]["name"]], [f["title"]], avoid


def _q_star_nationality(w, rng):
    f = rng.choice(w["films"])
    star = f["star"]
    q = rng.choice([
        f"What is the citizenship of the performer who appears in {f['title']}?",
        f"Which country does the lead actor of {f['title']} come from?",
    ])
    return (q, [star["nationality"], star["country"]],
            [f["title"], star["name"]], [])


def _q_director_birth_city(w, rng):
    f = rng.choice(w["films"])
    d = f["director"]
    q = rng.choice([
        f"In which city did the filmmaker behind {f['title']} grow up?",
        f"What is the home city of the person who made {f['title']}?",
    ])
    return q, [d["birth_city"]], [f["title"], d["name"]], []


def _q_same_nationality(w, rng):
    a, b = rng.sample(w["people"], 2)
    q = rng.choice([
        f"Do {a['name']} and {b['name']} share the same citizenship?",
        f"Are {a['name']} and {b['name']} from the same country?",
    ])
    ans = "yes" if a["nationality"] == b["nationality"] else "no"
    return q, [ans], [a["name"], b["name"]], []


def _q_org_hq(w, rng):
    o = rng.choice(w["orgs"])
    q = rng.choice([
        f"In which city does {o['name']} have its base of operations?",
        f"Where does {o['name']} operate from?",
    ])
    return q, [o["city"][0]], [o["name"]], []


def _q_founder_profession(w, rng):
    o = rng.choice(w["orgs"])
    p = o["founder"]
    q = rng.choice([
        f"What is the occupation of the person who established {o['name']}?",
        f"What does the creator of {o['name']} do for a living?",
    ])
    return q, [p["profession"]], [o["name"], p["name"]], []


def _q_film_year(w, rng):
    f = rng.choice(w["films"])
    q = rng.choice([
        f"When did {f['title']} first reach theaters?",
        f"In what year did {f['title']} come out?",
    ])
    return q, [str(f["year"])], [f["title"]], []


def _q_org_country(w, rng):
    o = rng.choice(w["orgs"])
    city, country = o["city"]
    q = rng.choice([
        f"In which country is {o['name']} based?",
        f"What country hosts {o['name']}?",
    ])
    return q, [country], [o["name"], city], []


def _q_person_profession(w, rng):
    p = rng.choice(w["people"])
    q = rng.choice([
        f"How does {p['name']} earn a living?",
        f"What is {p['name']}'s line of work?",
    ])
    return q, [p["profession"]], [p["name"]], []


# ---------------------------------------------------------------------------
# v2-only families: NO gold-entity tokens in the question (pure attribute /
# bridge descriptions). Retrieval gets no name anchor and answering requires a
# real bridge hop — the regime where navigation is necessary (VERDICT r2 items
# 2/4/5). Uniqueness of the describing attributes is enforced world-wide so the
# questions stay unambiguous.
# ---------------------------------------------------------------------------

def _unique_people_by_desc(w):
    from collections import Counter
    combos = Counter((p["nationality"], p["profession"]) for p in w["people"])
    return [p for p in w["people"]
            if combos[(p["nationality"], p["profession"])] == 1]


def _q_org_by_founder_desc(w, rng):
    """Bridge with no names: describe the founder by attributes, ask the org's
    city. Gold = org paragraph (city) + founder paragraph (attributes)."""
    forgs: Dict[str, list] = {}
    for o in w["orgs"]:
        forgs.setdefault(o["founder"]["name"], []).append(o)
    uniq = {p["name"]: p for p in _unique_people_by_desc(w)}
    cands = [(uniq[fn], orgs[0]) for fn, orgs in sorted(forgs.items())
             if len(orgs) == 1 and fn in uniq]
    if not cands:
        return None
    p, o = rng.choice(cands)
    q = rng.choice([
        f"In what city are the offices of the organization begun by the "
        f"{p['nationality']} {p['profession']}?",
        f"Which city is home to the organization that the {p['nationality']} "
        f"{p['profession']} brought about?",
    ])
    return q, [o["city"][0]], [o["name"], p["name"]], []


def _q_person_year_by_desc(w, rng):
    cands = _unique_people_by_desc(w)
    if not cands:
        return None
    p = rng.choice(cands)
    q = rng.choice([
        f"What is the birth year of the {p['nationality']} {p['profession']}?",
        f"In which year was the {p['nationality']} {p['profession']} born?",
    ])
    return q, [str(p["birth_year"])], [p["name"]], []


def _q_star_by_film_desc(w, rng):
    f = rng.choice(w["films"])
    q = rng.choice([
        f"Who has the leading role in the {f['genre']} film of {f['year']}?",
        f"Which performer appears at the front of the {f['genre']} film from "
        f"{f['year']}?",
    ])
    avoid = [g["title"] for g in w["films"]
             if g is not f and (g["genre"] == f["genre"] or g["year"] == f["year"])]
    return q, [f["star"]["name"]], [f["title"]], avoid


# ---------------------------------------------------------------------------
# v3-only families: the corpus stays the v2 renderers (no new markers, the
# disjointness audit is unchanged) — the QUESTIONS get harder. Comparison
# across paragraphs, temporal arithmetic, and 3-entity bridges: regimes the
# structural fact chain does not get for free, so the eval keeps headroom
# after v2 saturated (dev F1 100 with the audit green).
# ---------------------------------------------------------------------------

def _q_film_earlier(w, rng):
    """Comparison: which of two named films reached audiences first."""
    a, b = rng.sample(w["films"], 2)
    if a["year"] == b["year"]:
        return None
    q = rng.choice([
        f"Which reached audiences first, {a['title']} or {b['title']}?",
        f"Of {a['title']} and {b['title']}, which came out earlier?",
    ])
    winner = a if a["year"] < b["year"] else b
    return q, [winner["title"]], [a["title"], b["title"]], []


def _q_born_earlier(w, rng):
    """Comparison over birth years of two named people."""
    a, b = rng.sample(w["people"], 2)
    if a["birth_year"] == b["birth_year"]:
        return None
    q = rng.choice([
        f"Who came into the world earlier, {a['name']} or {b['name']}?",
        f"Of {a['name']} and {b['name']}, who is older?",
    ])
    winner = a if a["birth_year"] < b["birth_year"] else b
    return q, [winner["name"]], [a["name"], b["name"]], []


def _q_age_at_release(w, rng):
    """Temporal arithmetic across a bridge: star's age when the film opened.
    Gold = film paragraph (year, star) + star paragraph (birth year)."""
    cands = [f for f in w["films"]
             if f["year"] - f["star"]["birth_year"] >= 10]
    if not cands:
        return None
    f = rng.choice(cands)
    age = f["year"] - f["star"]["birth_year"]
    q = rng.choice([
        f"How old was the lead performer of {f['title']} when it first "
        f"reached theaters?",
        f"What age had the person carrying the lead of {f['title']} attained "
        f"in its opening year?",
    ])
    return q, [str(age)], [f["title"], f["star"]["name"]], []


def _q_director_star_same_country(w, rng):
    """Three-entity bridge comparison: filmmaker vs lead citizenship."""
    f = rng.choice(w["films"])
    q = rng.choice([
        f"Do the filmmaker and the lead performer of {f['title']} share a "
        f"citizenship?",
        f"Are the person behind {f['title']} and its lead from the same "
        f"country?",
    ])
    ans = ("yes" if f["director"]["nationality"] == f["star"]["nationality"]
           else "no")
    return (q, [ans],
            [f["title"], f["director"]["name"], f["star"]["name"]], [])


def _q_org_founder_birth_city(w, rng):
    """Bridge: org -> founder -> birth city (parallels director_birth_city)."""
    o = rng.choice(w["orgs"])
    p = o["founder"]
    q = rng.choice([
        f"In which city did the creator of {o['name']} spend their early "
        f"years?",
        f"What is the home city of the person who brought {o['name']} into "
        f"being?",
    ])
    return q, [p["birth_city"]], [o["name"], p["name"]], []


# ---------------------------------------------------------------------------
# v4-only families: the corpus stays the v2 renderers (no new markers, the
# disjointness audit is unchanged) — the questions demand AGGREGATION over a
# variable number of gold paragraphs (counting, superlatives), description-only
# intersections (two no-name entity constraints joined through one film),
# 3-hop chains, and ABSTENTION (the asked entity exists nowhere in the corpus;
# the only correct behavior is to say so — squad_v2's no-answer axis, which
# nothing in v1-v3 exercised). v3 saturated honestly (dev 100.0, held-out test
# 98.3 with the audit green); v4 keeps the eval ahead of the system.
# ---------------------------------------------------------------------------

def _films_by_director(w) -> Dict[str, list]:
    by: Dict[str, list] = {}
    for f in w["films"]:
        by.setdefault(f["director"]["name"], []).append(f)
    return by


def _q_films_count(w, rng):
    """Aggregation: count a director's films. Golds = the FULL filmography —
    retrieval must cover a variable number of paragraphs and the answerer must
    enumerate, not extract."""
    by = _films_by_director(w)
    cands = sorted(d for d, fs in by.items() if len(fs) >= 2)
    if not cands:
        return None
    d = rng.choice(cands)
    fs = by[d]
    q = rng.choice([
        f"How many features does {d} have to their credit?",
        f"What is the total count of movies from {d}?",
    ])
    return q, [str(len(fs))], [f["title"] for f in fs], []


def _q_earliest_film(w, rng):
    """Superlative over a filmography: which of the director's films opened
    first. Requires all their film paragraphs plus a cross-paragraph compare."""
    by = _films_by_director(w)
    cands = [(d, fs) for d, fs in sorted(by.items())
             if len(fs) >= 2 and len({f["year"] for f in fs}) == len(fs)]
    if not cands:
        return None
    d, fs = cands[rng.randrange(len(cands))]
    first = min(fs, key=lambda f: f["year"])
    q = rng.choice([
        f"Of the features credited to {d}, which opened first?",
        f"Which of {d}'s movies reached audiences earliest?",
    ])
    return q, [first["title"]], [f["title"] for f in fs], []


def _q_film_by_people_desc(w, rng):
    """Description-only intersection: no entity names at all — the film is
    identified by joining a described filmmaker with a described lead."""
    uniq = {p["name"] for p in _unique_people_by_desc(w)}
    pair_count: Dict[tuple, int] = {}
    for f in w["films"]:
        key = (f["director"]["name"], f["star"]["name"])
        pair_count[key] = pair_count.get(key, 0) + 1
    cands = [f for f in w["films"]
             if f["director"]["name"] in uniq and f["star"]["name"] in uniq
             and pair_count[(f["director"]["name"], f["star"]["name"])] == 1]
    if not cands:
        return None
    f = cands[rng.randrange(len(cands))]
    d, s = f["director"], f["star"]
    q = rng.choice([
        f"Which feature joined the {d['nationality']} {d['profession']} behind "
        f"the camera with the {s['nationality']} {s['profession']} out front?",
        f"What movie has the {d['nationality']} {d['profession']} at the helm "
        f"and the {s['nationality']} {s['profession']} in the lead?",
    ])
    return q, [f["title"]], [f["title"], d["name"], s["name"]], []


def _q_org_founder_film_star_prof(w, rng):
    """3-hop chain: org -> founder (who directs exactly one film) -> that
    film's lead -> the lead's profession."""
    by = _films_by_director(w)
    cands = [(o, by[o["founder"]["name"]][0]) for o in w["orgs"]
             if len(by.get(o["founder"]["name"], [])) == 1]
    if not cands:
        return None
    o, f = cands[rng.randrange(len(cands))]
    s = f["star"]
    q = rng.choice([
        f"What line of work does the lead of the feature made by the person "
        f"who brought {o['name']} into being pursue?",
        f"What is the occupation of the performer fronting the movie from "
        f"the creator of {o['name']}?",
    ])
    return q, [s["profession"]], [o["name"], f["title"], s["name"]], []


def _q_unanswerable(w, rng):
    """Abstention: the asked entity exists NOWHERE in the corpus (an unused
    title/name drawn from the same surface vocabulary, so partial lexical
    matches abound). Gold answer is the literal token "unanswerable"; gold
    paragraphs are empty (the harness skips retrieval recall for these)."""
    used_titles = set(w["paragraphs"])
    unused_t = [t for t in (f"The {a} {n}" for a in TITLE_ADJ
                            for n in TITLE_NOUN) if t not in used_titles]
    used_names = {p["name"] for p in w["people"]}
    unused_n = [x for x in (f"{a} {b}" for a in FIRST for b in LAST)
                if x not in used_names]
    if rng.random() < 0.5 and unused_t:
        t = unused_t[rng.randrange(len(unused_t))]
        q = rng.choice([f"Who helmed {t}?",
                        f"When did {t} first reach theaters?"])
    else:
        name = unused_n[rng.randrange(len(unused_n))]
        q = rng.choice([f"How does {name} earn a living?",
                        f"In which city did {name} grow up?"])
    return q, ["unanswerable"], [], []


# ---------------------------------------------------------------------------
# v5-only families: every question targets one of the six HELD-OUT relation
# types (see attach_v5_extras). No v1-v4 relation is asked, so the v5 score
# isolates schema generalization: an answerer whose fact tables cover exactly
# the v1-v4 relations scores ~0 here until it generalizes. Question vocabulary
# avoids the v5 corpus markers (tutelage/ropes vs wing/guidance; collect vs
# accepted/went; married vs vows/wed) so lexical overlap gives no free ride.
# ---------------------------------------------------------------------------

def _q_award_year(w, rng):
    if not w.get("awards"):
        return None
    a = rng.choice(w["awards"])
    n = a["person"]["name"]
    q = rng.choice([
        f"In what year did {n} collect the {a['award']}?",
        f"When was {n} given the {a['award']}?",
    ])
    return q, [str(a["year"])], [n], []


def _q_award_holder_prof(w, rng):
    """No-name bridge: award -> recipient -> profession."""
    if not w.get("awards"):
        return None
    a = rng.choice(w["awards"])
    p = a["person"]
    q = rng.choice([
        f"What does the recipient of the {a['award']} do for a living?",
        f"Which occupation does the holder of the {a['award']} pursue?",
    ])
    return q, [p["profession"]], [p["name"]], []


def _q_mentor_of(w, rng):
    if not w.get("mentors"):
        return None
    m = rng.choice(w["mentors"])
    n = m["mentee"]["name"]
    q = rng.choice([
        f"Who showed {n} the ropes?",
        f"Who oversaw {n}'s first steps in the field?",
    ])
    return q, [m["mentor"]["name"]], [n], []


def _q_mentor_birth_city(w, rng):
    """Bridge: mentee -> mentor -> the mentor's home city."""
    if not w.get("mentors"):
        return None
    m = rng.choice(w["mentors"])
    n = m["mentee"]["name"]
    q = rng.choice([
        f"What is the home city of the person who showed {n} the ropes?",
        f"In which city did the figure who oversaw {n}'s first steps grow up?",
    ])
    return (q, [m["mentor"]["birth_city"]],
            [n, m["mentor"]["name"]], [])


def _q_instrument_of(w, rng):
    if not w.get("instruments"):
        return None
    i = rng.choice(w["instruments"])
    n = i["person"]["name"]
    q = rng.choice([
        f"Which instrument does {n} perform on?",
        f"What instrument is {n} known for?",
    ])
    return q, [i["instrument"]], [n], []


def _q_person_by_instrument(w, rng):
    """No-name: instrument (world-unique) -> player -> birth year."""
    if not w.get("instruments"):
        return None
    i = rng.choice(w["instruments"])
    p = i["person"]
    q = rng.choice([
        f"In what year was the performer known for the {i['instrument']} "
        f"born?",
        f"Which year saw the birth of the player of the {i['instrument']}?",
    ])
    return q, [str(p["birth_year"])], [p["name"]], []


def _q_predecessor_of(w, rng):
    if not w.get("successions"):
        return None
    s = rng.choice(w["successions"])
    n, o = s["successor"]["name"], s["org"]["name"]
    q = rng.choice([
        f"Whom did {n} follow at the head of {o}?",
        f"Who ran {o} before {n} took charge?",
    ])
    return q, [s["predecessor"]["name"]], [n], []


def _q_successor_of(w, rng):
    if not w.get("successions"):
        return None
    s = rng.choice(w["successions"])
    p, o = s["predecessor"]["name"], s["org"]["name"]
    q = rng.choice([
        f"Who took charge of {o} after {p}?",
        f"Who came after {p} at the top of {o}?",
    ])
    return q, [s["successor"]["name"]], [s["successor"]["name"]], []


def _q_namesake_prof(w, rng):
    """Bridge: org -> honoree in its name -> the honoree's profession."""
    if not w.get("namesakes"):
        return None
    nm = rng.choice(w["namesakes"])
    o, h = nm["org"]["name"], nm["honoree"]
    q = rng.choice([
        f"What occupation does the person honored in the name of {o} pursue?",
        f"How does the figure {o} is named for earn a living?",
    ])
    return q, [h["profession"]], [o, h["name"]], []


def _q_spouse_of(w, rng):
    if not w.get("spouses"):
        return None
    sp = rng.choice(w["spouses"])
    asker, other = ((sp["a"], sp["b"]) if rng.random() < 0.5
                    else (sp["b"], sp["a"]))
    q = rng.choice([
        f"To whom is {asker['name']} married?",
        f"Who is {asker['name']}'s partner in marriage?",
    ])
    return q, [other["name"]], [sp["a"]["name"]], []


def _q_spouse_prof(w, rng):
    """Bridge: person -> spouse -> the spouse's profession."""
    if not w.get("spouses"):
        return None
    sp = rng.choice(w["spouses"])
    asker, other = ((sp["a"], sp["b"]) if rng.random() < 0.5
                    else (sp["b"], sp["a"]))
    q = rng.choice([
        f"How does the partner of {asker['name']} earn a living?",
        f"What is the line of work of the person married to "
        f"{asker['name']}?",
    ])
    return q, [other["profession"]], [sp["a"]["name"], other["name"]], []


def _q_marriage_year(w, rng):
    if not w.get("spouses"):
        return None
    sp = rng.choice(w["spouses"])
    a, b = sp["a"]["name"], sp["b"]["name"]
    q = rng.choice([
        f"In which year did {a} and {b} marry?",
        f"What year marks the marriage of {a} and {b}?",
    ])
    return q, [str(sp["year"])], [sp["a"]["name"]], []


# ---------------------------------------------------------------------------
# v6: VOCAB-SHIFTED world (round-5 VERDICT item 4). The corpus renders
# profession and genre attributes through paraphrase surfaces that share no
# word (and essentially no character n-grams) with the canonical vocabulary
# the QUESTIONS keep using. A purely lexical retriever (the hashed/LSA
# encoder) then has no bucket overlap between a descriptor question and its
# gold paragraph — the regime where the reference's MiniLM carries retrieval
# (semantic_aggregator.py:71). The paraphrase-contrastive encoder
# (models/encoder/contrastive.py) trains on cluster pairs drawn from this
# SAME general-vocabulary table (its stand-in for pretraining knowledge) with
# fresh pseudo entities; v6 worlds hold out the entities, bindings, and
# templates. Answer lists are augmented with the corpus surface so extractive
# answers in either vocabulary score.
# ---------------------------------------------------------------------------

V6_ATTR_VARIANTS: Dict[str, str] = {
    # professions -> corpus paraphrase (no shared content word or stem)
    "marine biologist": "researcher of ocean creatures",
    "volcanologist": "student of erupting mountains",
    "jazz pianist": "improvising keyboard player",
    "sculptor": "carver of figures in bronze",
    "astronomer": "watcher of the night sky",
    "architect": "designer of buildings",
    "chess grandmaster": "elite strategist of the sixty-four squares",
    "opera singer": "classical vocal performer",
    "mathematician": "scholar of numbers and proofs",
    "glassblower": "shaper of molten vessels",
    "cartographer": "maker of maps",
    "mycologist": "specialist in fungi",
    # genres -> corpus paraphrase
    "science fiction": "futuristic speculative",
    "western": "frontier-era",
    "documentary": "nonfiction factual",
    "animated": "hand-drawn moving-picture",
    "thriller": "suspense-driven",
    "romantic comedy": "lighthearted courtship",
    "horror": "fright-laden",
    "musical": "song-and-dance",
    "war": "battlefield",
    "noir": "shadowy crime",
}

_V6_SUB_RE = None


def shift_vocabulary(world: Dict[str, Any]) -> None:
    """Rewrite every paragraph's profession/genre surfaces in place."""
    global _V6_SUB_RE
    if _V6_SUB_RE is None:
        keys = sorted(V6_ATTR_VARIANTS, key=len, reverse=True)
        _V6_SUB_RE = re.compile(
            r"\b(" + "|".join(re.escape(k) for k in keys) + r")\b")
    sub = lambda m: V6_ATTR_VARIANTS[m.group(1)]
    for title, sents in world["paragraphs"].items():
        world["paragraphs"][title] = [_V6_SUB_RE.sub(sub, s) for s in sents]


NO_NAME_FAMILIES = ("film_by_attrs", "org_by_founder_desc",
                    "person_year_by_desc", "star_by_film_desc",
                    "film_by_people_desc", "award_holder_prof",
                    "person_by_instrument")

QUESTION_FAMILIES = [
    ("director_of_film", _q_director_of_film),
    ("film_by_attrs", _q_film_by_attrs),
    ("star_nationality", _q_star_nationality),
    ("director_birth_city", _q_director_birth_city),
    ("same_nationality", _q_same_nationality),
    ("org_hq", _q_org_hq),
    ("founder_profession", _q_founder_profession),
    ("film_year", _q_film_year),
    ("org_country", _q_org_country),
    ("person_profession", _q_person_profession),
]

V2_QUESTION_FAMILIES = QUESTION_FAMILIES + [
    ("org_by_founder_desc", _q_org_by_founder_desc),
    ("person_year_by_desc", _q_person_year_by_desc),
    ("star_by_film_desc", _q_star_by_film_desc),
]

V3_QUESTION_FAMILIES = V2_QUESTION_FAMILIES + [
    ("film_earlier", _q_film_earlier),
    ("born_earlier", _q_born_earlier),
    ("age_at_release", _q_age_at_release),
    ("director_star_same_country", _q_director_star_same_country),
    ("org_founder_birth_city", _q_org_founder_birth_city),
]

V4_QUESTION_FAMILIES = V3_QUESTION_FAMILIES + [
    ("films_count", _q_films_count),
    ("earliest_film", _q_earliest_film),
    ("film_by_people_desc", _q_film_by_people_desc),
    ("org_founder_film_star_prof", _q_org_founder_film_star_prof),
    ("unanswerable", _q_unanswerable),
]

# v5 asks ONLY the held-out relations — mixing v1-v4 families back in would
# dilute the zero-edit generalization measurement the split exists for
V5_QUESTION_FAMILIES = [
    ("award_year", _q_award_year),
    ("award_holder_prof", _q_award_holder_prof),
    ("mentor_of", _q_mentor_of),
    ("mentor_birth_city", _q_mentor_birth_city),
    ("instrument_of", _q_instrument_of),
    ("person_by_instrument", _q_person_by_instrument),
    ("predecessor_of", _q_predecessor_of),
    ("successor_of", _q_successor_of),
    ("namesake_prof", _q_namesake_prof),
    ("spouse_of", _q_spouse_of),
    ("spouse_prof", _q_spouse_prof),
    ("marriage_year", _q_marriage_year),
]


def _pick_distractors(w, gold_titles: List[str], avoid: List[str],
                      rng: random.Random, n: int,
                      question: str = "") -> List[str]:
    """Adversarial distractors: prefer paragraphs confusable with the golds
    (same profession/genre/country/surname), then fill uniformly. For
    gold-less (unanswerable) items the QUESTION text drives the confusability
    score instead — paragraphs sharing the phantom entity's surface tokens."""
    kinds, paras = w["kinds"], w["paragraphs"]
    banned = set(gold_titles) | set(avoid)
    gold_text = " ".join(" ".join(paras[t]) for t in gold_titles).lower()
    if not gold_titles:
        gold_text = question.lower()
    gold_surnames = {t.split()[-1] for t in gold_titles if kinds[t] == "person"}
    scored = []
    for t in paras:
        if t in banned:
            continue
        text = " ".join(paras[t]).lower()
        score = 0
        for token in set(text.split()):
            if len(token) > 4 and token in gold_text:
                score += 1
        if kinds[t] == "person" and t.split()[-1] in gold_surnames:
            score += 5
        scored.append((score, rng.random(), t))
    scored.sort(key=lambda x: (-x[0], x[1]))
    hard = [t for _, _, t in scored[: n * 2]]
    rng.shuffle(hard)
    return hard[:n]


def make_dataset(seed: int, n_items: int, n_distractors: int = 8,
                 split: str = "test",
                 version: str = "v1") -> List[Dict[str, Any]]:
    rng = random.Random(seed)
    # v3/v4 reuse the v2 corpus renderers — only the question families widen.
    # v4 worlds carry more films/orgs so multi-film directors (the counting
    # and superlative families) and founder-director chains are plentiful.
    if version == "v4":
        world = make_world(rng, n_films=26, n_orgs=14, version="v2")
    elif version == "v5":
        # v2 corpus renderers + the held-out relation extras appended AFTER
        # the base world build (base draws unchanged; v1-v4 stay byte-stable)
        world = make_world(rng, n_orgs=14, version="v2")
        attach_v5_extras(world, rng)
    elif version == "v6":
        # v2 world, then corpus-side paraphrase shift of profession/genre
        # surfaces (see V6_ATTR_VARIANTS): questions keep canonical words
        world = make_world(rng, n_orgs=14, version="v2")
        shift_vocabulary(world)
    else:
        world = make_world(rng, version="v2" if version == "v3" else version)
    families = {"v1": QUESTION_FAMILIES, "v2": V2_QUESTION_FAMILIES,
                "v3": V3_QUESTION_FAMILIES, "v4": V4_QUESTION_FAMILIES,
                "v5": V5_QUESTION_FAMILIES,
                "v6": V2_QUESTION_FAMILIES}[version]
    items: List[Dict[str, Any]] = []
    fam_idx = 0
    while len(items) < n_items:
        qtype, fn = families[fam_idx % len(families)]
        fam_idx += 1
        out = fn(world, rng)
        if out is None:
            continue  # family has no unambiguous candidates in this world
        q, answers, gold_titles, avoid = out
        if any(it["question"] == q for it in items):
            continue  # template+entity collision: resample
        if version == "v6":
            # the corpus renders shifted surfaces — accept either vocabulary
            answers = list(answers) + [V6_ATTR_VARIANTS[a] for a in answers
                                       if a in V6_ATTR_VARIANTS]
        n_dis = n_distractors + (2 if not gold_titles else 0)
        titles = list(gold_titles) + _pick_distractors(world, gold_titles,
                                                       avoid, rng, n_dis,
                                                       question=q)
        rng.shuffle(titles)
        items.append({
            "id": f"synth-{version}-{split}-{len(items):04d}" if version != "v1"
                  else f"synth-{split}-{len(items):04d}",
            "question": q,
            "answers": answers,
            "gold_titles": gold_titles,
            "qtype": qtype,
            "context": {"title": titles,
                        "sentences": [world["paragraphs"][t] for t in titles]},
        })
    return items


def make_shared_dataset(seed: int, n_items: int, split: str = "test",
                        version: str = "v4", n_people: int = 400,
                        n_films: int = 180, n_orgs: int = 80,
                        xl: bool = False
                        ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """ONE corpus-scale world plus context-free questions against it — the
    fullwiki-style configuration (shared KB, no per-question paragraphs; the
    whole corpus is the distractor set). Families keep their world-level
    uniqueness checks, so questions stay unambiguous even though every
    paragraph is present; ``avoid`` lists are unnecessary here because the
    attribute-description families pin (genre, year) pairs that are unique
    world-wide by construction. Returns (world, items); items carry no
    "context" key, which routes the benchmark harness to the shared graph."""
    rng = random.Random(seed)
    world = make_world(rng, n_people=n_people, n_films=n_films,
                       n_orgs=n_orgs, version="v2", xl=xl)
    families = {"v1": QUESTION_FAMILIES, "v2": V2_QUESTION_FAMILIES,
                "v3": V3_QUESTION_FAMILIES, "v4": V4_QUESTION_FAMILIES}[version]
    items: List[Dict[str, Any]] = []
    fam_idx = 0
    guard = 0
    while len(items) < n_items and guard < 60 * n_items:
        guard += 1
        qtype, fn = families[fam_idx % len(families)]
        fam_idx += 1
        out = fn(world, rng)
        if out is None:
            continue
        q, answers, gold_titles, _avoid = out
        if any(it["question"] == q for it in items):
            continue
        tag = "sharedxl" if xl else "shared"
        items.append({
            "id": f"synth-{version}-{tag}-{split}-{len(items):04d}",
            "question": q, "answers": answers,
            "gold_titles": gold_titles, "qtype": qtype,
        })
    return world, items


def write_shared_world(world: Dict[str, Any], corpus_path: str) -> int:
    """Corpus file in the '=== title ===' section layout the ingest CLI
    chunks on (cli/benchmark.py::context_to_corpus)."""
    with open(corpus_path, "w", encoding="utf-8") as f:
        for title, sents in world["paragraphs"].items():
            f.write(f"\n\n=== {title} ===\n" + " ".join(sents))
    return len(world["paragraphs"])


SPLIT_SEEDS = {"train": 11, "dev": 22, "test": 33}
# v2 uses distinct world seeds so v2 entities/attributes differ from v1's
# (heuristics tuned on v1 train/dev meet unseen entity-attribute bindings too)
SPLIT_SEEDS_V2 = {"train": 111, "dev": 222, "test": 333}
SPLIT_SEEDS_V3 = {"train": 1111, "dev": 2222, "test": 3333}
SPLIT_SEEDS_V4 = {"train": 11111, "dev": 22222, "test": 33333}
SPLIT_SEEDS_V5 = {"train": 51111, "dev": 52222, "test": 53333}
SPLIT_SEEDS_V6 = {"train": 61111, "dev": 62222, "test": 63333}


def main() -> None:
    ap = argparse.ArgumentParser(description="Generate frozen synthetic eval sets")
    ap.add_argument("--split", choices=list(SPLIT_SEEDS), default="test")
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--seed", type=int, default=None,
                    help="override the split seed (default: frozen per split)")
    ap.add_argument("--version", choices=["v1", "v2", "v3", "v4", "v5", "v6"],
                    default="v1")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shared-corpus", default=None,
                    help="also write a corpus-scale shared world to this "
                         "path and emit context-free items (fullwiki-style)")
    ap.add_argument("--shared-xl", action="store_true",
                    help="XL shared world: extended vocabulary pools, "
                         "1,200 people / 380 films / 220 orgs (~1,850 "
                         "paragraphs) unless overridden below")
    ap.add_argument("--shared-people", type=int, default=None)
    ap.add_argument("--shared-films", type=int, default=None)
    ap.add_argument("--shared-orgs", type=int, default=None)
    args = ap.parse_args()
    seeds = {"v1": SPLIT_SEEDS, "v2": SPLIT_SEEDS_V2,
             "v3": SPLIT_SEEDS_V3, "v4": SPLIT_SEEDS_V4,
             "v5": SPLIT_SEEDS_V5, "v6": SPLIT_SEEDS_V6}[args.version]
    seed = args.seed if args.seed is not None else seeds[args.split]
    if args.shared_corpus:
        xl = args.shared_xl
        sizes = {
            "n_people": args.shared_people or (1200 if xl else 400),
            "n_films": args.shared_films or (380 if xl else 180),
            "n_orgs": args.shared_orgs or (220 if xl else 80),
        }
        world, items = make_shared_dataset(seed + (700000 if xl else 500000),
                                           args.n, split=args.split,
                                           version=args.version,
                                           xl=xl, **sizes)
        n_paras = write_shared_world(world, args.shared_corpus)
        print(f"wrote {n_paras} paragraphs to {args.shared_corpus}")
    else:
        items = make_dataset(seed, args.n, split=args.split,
                             version=args.version)
    with open(args.out, "w", encoding="utf-8") as f:
        for it in items:
            f.write(json.dumps(it, ensure_ascii=False) + "\n")
    print(f"wrote {len(items)} items to {args.out} (split={args.split}, "
          f"seed={seed}, version={args.version})")


if __name__ == "__main__":
    main()
