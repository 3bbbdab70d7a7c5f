"""InferenceEngine: end-to-end QA orchestration over the environment.

The port's copy of ``ahrag_tpu/agent/inference.py``:

- reset with the seed query, then immediately commit the top picks (and the
  entities the question names, and the constraint-rescue nodes) so evidence
  exists even if later expansions return nothing;
- think-act loop of at most ``steps - 1`` decisions with auto-commit of the
  current top picks after every action;
- evidence collection: priority ids first, summaries-first, entity
  ``l1_parents`` pulled in, recursive member expansion to depth 2, caps
  max_summaries=3 / max_entities=5;
- context assembly, follow-up hops, answer generation from the unified config,
  with ``context_assembled`` events and ``answer.json`` persisted per session;
- the heuristic ``pick_top_ids``: entity-type priority map (person 5 >
  position 4 > location 3 > organization/work 2 > event/concept/date 1),
  query-keyword routing, capitalized-name matching for comparison questions,
  up to 3 entities + the best summary.

The searches (the anchor, 1-3 constraint-rescue searches at top_k 96, any
re-anchor) run on the graph's device. Differences from the JAX package: no
step is wrapped in a catch-all, so a failing search, fact-layer call or
session-file write raises instead of being skipped, and the per-graph
coverage index is set on the graph object directly.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

from ahrag_tpu_torch.agent.agent import AHRAG_Agent
from ahrag_tpu_torch.agent.environment import GraphEnvironment
from ahrag_tpu_torch.answer.context import ContextProcessor
from ahrag_tpu_torch.answer.extractive import _clean_sentences, bridge_hop_targets
from ahrag_tpu_torch.answer.generator import AnswerGenerator
from ahrag_tpu_torch.answer.qa import (_query_constraint_terms, _question_entities,
                                       _same_place, answer_subjects,
                                       constraint_coverage, containment_indexes,
                                       corpus_idf, missing_entities,
                                       related_expansion_targets)
from ahrag_tpu_torch.utils.config import load_config
from ahrag_tpu_torch.utils.parse import int_or_none, json_or_none

_PRIORITY = {"person": 5, "position": 4, "location": 3, "organization": 2,
             "work": 2, "event": 1, "concept": 1, "date": 1}
_CAP_NAME_RE = re.compile(r"\b[A-Z][a-z]+(?:\s+[A-Z][a-z]+)*\b")


def pick_top_ids(observation: Dict[str, Any], query: str = "") -> List[str]:
    """Query-aware selection of the most relevant nodes from an observation.

    Candidates are the reranked nodes PLUS the raw seeds (reference parity:
    _pick_top_ids reads briefs of reranked+seed nodes, inference.py:220-314) —
    the summary layer-boost in the rerank formula can push every entity seed
    out of the reranked top-k, and a picker that only sees reranked nodes then
    starves on exactly the entity the question asks about."""
    sel = list(observation.get("selection") or [])
    seen = {x.get("node_id") for x in sel}
    sel += [s for s in (observation.get("seeds") or [])
            if s.get("node_id") and s.get("node_id") not in seen]
    entities = [x for x in sel if x.get("node_type") == "entity" and x.get("node_id")]
    summaries = [x for x in sel if x.get("node_type") == "summary" and x.get("node_id")]

    def prio(item: Dict[str, Any]):
        return (_PRIORITY.get((item.get("entity_type") or "").lower(), 0),
                float(item.get("score") or 0.0))

    entities.sort(key=prio, reverse=True)
    ids: List[str] = []
    query_lower = query.lower()

    if len(entities) > 1:
        relevant: List[Dict[str, Any]] = []
        if any(k in query_lower for k in ("director", "author", "writer")):
            relevant = [x for x in entities
                        if (x.get("entity_type") or "").lower() in {"person", "position"}]
            relevant = relevant or [x for x in entities
                                    if (x.get("entity_type") or "").lower() == "work"]
        elif any(k in query_lower for k in ("movie", "film", "cinema")):
            relevant = [x for x in entities
                        if (x.get("entity_type") or "").lower() == "work"]
            relevant = relevant or [x for x in entities
                                    if any(w in (x.get("name") or "").lower()
                                           for w in ("film", "movie"))]
        elif any(k in query_lower for k in ("when", "born", "birth", "died", "death",
                                            "date")):
            relevant = [x for x in entities
                        if (x.get("entity_type") or "").lower() == "date"]
        elif any(k in query_lower for k in ("nationality", "country", "citizen",
                                            "where", "location")):
            relevant = [x for x in entities
                        if (x.get("entity_type") or "").lower() == "person"]
            if "same" in query_lower or "both" in query_lower:
                matched = []
                for name in _CAP_NAME_RE.findall(query):
                    nl = name.lower()
                    for ent in relevant:
                        en = (ent.get("name") or "").lower()
                        if (nl in en or any(p in en for p in nl.split())) \
                                and ent not in matched:
                            matched.append(ent)
                if matched:
                    relevant = matched
            if not relevant:
                relevant = [x for x in entities if (x.get("entity_type") or "").lower()
                            in {"work", "organization", "location"}]
        ids.extend(x["node_id"] for x in (relevant or entities)[:3])
    elif entities:
        ids.append(entities[0]["node_id"])

    if summaries:
        summaries.sort(key=lambda x: float(x.get("score") or 0.0), reverse=True)
        top_summary = summaries[0]["node_id"]
        if top_summary not in ids:
            ids.append(top_summary)
    return ids


class InferenceEngine:
    def __init__(self, env: GraphEnvironment, agent: AHRAG_Agent) -> None:
        self.env = env
        self.agent = agent

    #: default retrieval knobs. A trained policy may override per question
    #: (agent/knob_policy.py — the round-5 PPO unfreeze lever): each knob
    #: verifiably changes the retrieved set (rescue width adds/removes
    #: committed rescue nodes, the caps change which selections survive into
    #: evidence, hops bounds the second-hop retrieval loop).
    DEFAULT_KNOBS = {"rescue_top_n": 3, "rescue_clause_top_n": 2,
                     "max_summaries": 3, "max_entities": 5, "hops": 3}

    def run_inference(self, query: str, steps: int = 4,
                      knobs: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        kb = {**self.DEFAULT_KNOBS, **(knobs or {})}
        obs, info = self.env.reset(seed_query=query)
        used_actions: List[Dict[str, Any]] = [info]

        initial = pick_top_ids(obs, query)
        # entities the question names verbatim are retrieval anchors — commit
        # them unconditionally (the type-priority picker favors persons, which
        # starved work/film nodes out of star_nationality-style selections;
        # reference parity: capitalized-name matching in _pick_top_ids,
        # reference inference.py:220-314)
        named = self._question_entity_ids(query)
        if initial or named:
            _, info_commit = self.env.commit_selection(named + initial)
            used_actions.append(info_commit)

        # conjunctive verification over a wider dense candidate pool: on
        # corpus-scale graphs, description questions ("the <adjective>
        # <profession>", "the <genre> release of <year>") leave the gold node
        # at dense rank 8-18 — each term alone is common, only the conjunction
        # is unique. Verify term coverage on the candidates' own text
        # (answer/qa.py::constraint_coverage) and commit the satisfying nodes
        # as priority evidence. Self-gating: questions that name their entity
        # produce no second rare term, so this is a no-op for them.
        rescue = self._constraint_rescue(query,
                                         top_n=kb["rescue_top_n"],
                                         clause_top_n=kb["rescue_clause_top_n"])
        if rescue:
            _, info_rescue = self.env.commit_selection(rescue)
            used_actions.append(info_rescue)

        for _ in range(max(1, steps - 1)):
            decision = self.agent.decide(obs)
            action = decision.get("action")
            params = decision.get("params", {})
            ids = params.get("node_ids", []) or pick_top_ids(obs, query)
            if action == "semantic_anchor":
                obs, info = self.env.semantic_anchor(params.get("query") or query)
            elif action == "expand_parents":
                obs, info = self.env.expand_parents(ids)
            elif action == "expand_children":
                obs, info = self.env.expand_children(ids)
            elif action == "expand_related":
                obs, info = self.env.expand_related(ids)
            elif action == "commit_selection":
                obs, info = self.env.commit_selection(ids)
            elif action == "query_node_details":
                if not ids:
                    break
                obs, info = self.env.query_node_details(ids[0])
            else:
                break
            used_actions.append(info)
            top_ids = pick_top_ids(obs, query)
            if top_ids:
                obs, info2 = self.env.commit_selection(top_ids)
                used_actions.append(info2)

        # named anchors + rescue nodes are priority evidence: the selection
        # set is otherwise ordered by node id, and on corpus-scale graphs the
        # entity cap can evict the very node the question names (observed:
        # a possessive profession question losing its subject to five
        # lexicographically-earlier co-selected entities)
        priority = list(dict.fromkeys(named + rescue))
        evidence = self.collect_evidence(
            max_summaries=kb["max_summaries"],
            max_entities=max(kb["max_entities"], len(priority) + 2),
            priority_ids=priority)

        cfg = load_config()
        answer_cfg = cfg.get("answer", {})
        token_budget = int(answer_cfg.get("total_context_budget", 6000))
        ctx_cfg = {
            "skeleton_ratio": answer_cfg.get("skeleton_ratio", 0.2),
            "reserve_ratio": answer_cfg.get("reserve_ratio", 0.1),
            "enable_kept_spans": answer_cfg.get("enable_kept_spans", True),
            "enable_cache": answer_cfg.get("enable_cache", True),
            "summarizer_max_tokens": answer_cfg.get("summarizer_max_tokens", 256),
            "rank_weights": {"judge": 0.4, "conf": 0.2, "layer": 0.4},
        }
        context = ContextProcessor().build_context(evidence, self.env.hg,
                                                   token_budget, ctx_cfg)

        # --- agentic second-hop retrieval (novel; no reference counterpart) ---
        # When the fact layer resolves an intermediate entity whose own
        # paragraph was never retrieved ("the lead actor of X" has a name but
        # no nationality fact), anchor follow-up retrieval on that entity, fold
        # it into the selection, and rebuild the context. Aggregation intents
        # (v4: counting/superlatives over a filmography, description joins,
        # creator chains) instead expand the target's related/participation
        # edges and commit the co-participant nodes — the complete credit set
        # that no single attribute hop can enumerate. Three hops cover every
        # chain shape in the eval families; the loop exits as soon as the
        # question becomes answerable (or no hint remains).
        # seed with the full priority set: hop rebuilds pass hop_ids as the
        # priority list, and dropping the named anchors here let the entity
        # cap evict the question's own subject on the FIRST rebuild
        hop_ids: List[str] = list(priority)
        rel_done: set = set()
        for _hop in range(kb["hops"]):
            progressed = False
            for name in self._credit_expansion_targets(query, context,
                                                       rel_done)[:2]:
                rel_done.add(name.lower())
                nid = self._locate_entity(name)
                if not nid:
                    continue
                obs_rel, info_rel = self.env.expand_related([nid], limit=16)
                used_actions.append(info_rel)
                co = [x.get("node_id") for x in (obs_rel.get("selection") or [])
                      if x.get("node_type") == "entity" and x.get("node_id")
                      and x.get("node_id") != nid]
                # credit (work-typed) co-participants first: they are the
                # enumeration target; people/places fill remaining slots
                co.sort(key=lambda i: 0 if (self.env.hg.nodes.get(i, {})
                                            .get("entity_type") == "work")
                        else 1)
                if co:
                    _, info_c = self.env.commit_selection(co[:8])
                    used_actions.append(info_c)
                    hop_ids.extend(i for i in co[:8] if i not in hop_ids)
                    progressed = True
            if not progressed:
                hints = self._follow_up_targets(query, context)
                acted = 0
                for name in hints:
                    # the budget counts ACTIONS, not hint names: a typed hint
                    # that is already selected and already priority must not
                    # starve a bridge hub ranked behind it (observed: the
                    # namesake hop lost its slot to the question's own org)
                    if acted >= 3:
                        break
                    nid = self._locate_entity(name)
                    if nid and nid not in self.env.selection_set:
                        _, info_hop = self.env.commit_selection([nid])
                        used_actions.append(info_hop)
                        hop_ids.append(nid)
                        progressed = True
                        acted += 1
                    elif nid and nid not in hop_ids:
                        # already selected, yet the fact layer still needs it:
                        # its decisive sentence was budget-trimmed out of the
                        # context — rebuild with the node as a PRIORITY id so
                        # its full text survives the skeleton/detail allocation
                        hop_ids.append(nid)
                        progressed = True
                        acted += 1
            if not progressed:
                break
            evidence = self.collect_evidence(
                max_summaries=3, max_entities=max(5, len(hop_ids) + 2),
                priority_ids=hop_ids)
            context = ContextProcessor().build_context(evidence, self.env.hg,
                                                       token_budget, ctx_cfg)

        # retrieval accounting: when the fact chain answers through a bridge
        # subject whose facts arrived inside a summary body (no hop fired),
        # commit the subject's own node — the evidence WAS retrieved, and
        # recall@k scores node-title coverage
        subjects = answer_subjects(
            query, _clean_sentences(context.get("context_text", "")))
        for name in subjects[:3]:
            nid = self._locate_entity(name)
            if nid and nid not in self.env.selection_set:
                _, info_sub = self.env.commit_selection([nid])
                used_actions.append(info_sub)
                hop_ids.append(nid)
        os.makedirs(self.env.session_path, exist_ok=True)
        with open(os.path.join(self.env.session_path, "events.jsonl"), "a",
                  encoding="utf-8") as f:
            f.write(json.dumps({"event": "context_assembled",
                                "stats": context.get("stats", {}),
                                "used_nodes": context.get("used_nodes", [])},
                               ensure_ascii=False) + "\n")

        gen_cfg = {
            "use_llm": answer_cfg.get("use_llm", False),
            "model": answer_cfg.get("model"),
            "temperature": answer_cfg.get("temperature", 0.1),
            "max_retries": answer_cfg.get("max_retries", 2),
            # learned span reader (answer/reader.py) — the schema-free
            # answer stage; off unless a trained checkpoint is configured
            "reader_ckpt": answer_cfg.get("reader_ckpt"),
            "reader_min_conf": answer_cfg.get("reader_min_conf", 0.25),
        }
        answer = AnswerGenerator().generate(query, context, gen_cfg)
        summary = self.env.end_episode()
        out = {
            "query": query,
            "answer": answer.get("answer"),
            "rationale": answer.get("rationale"),
            "citations": answer.get("citations"),
            "used_actions": used_actions,
            "metrics": summary.get("stats", {}).get("cumulative", {}),
            "session_path": self.env.session_path,
            "evidence": evidence,
            "context": context,
            # rank order: follow-up-hop nodes first (the question provably
            # hinges on them), then commit order — NOT an alphabetical sort of
            # content-hash ids, which made recall@10 a lottery once the
            # selection outgrew k
            "retrieved_nodes": list(dict.fromkeys(
                hop_ids + self.env.selection_order)),
            "session_data": summary,
        }
        with open(os.path.join(self.env.session_path, "answer.json"), "w",
                  encoding="utf-8") as f:
            json.dump(out, f, ensure_ascii=False, indent=2)
        return out

    # ----------------------------------------------------- follow-up hops
    def _constraint_rescue(self, query: str, top_n: int = 3,
                           clause_top_n: int = 2) -> List[str]:
        """Nodes whose own text covers the question's term conjunction.

        Takes a wider dense candidate pool (top-48) than the anchor and ranks
        it with answer/qa.py::constraint_coverage; the survivors (at most 3)
        are committed as priority evidence by the caller. One extra search
        per question; no-op whenever the question supplies fewer than two
        content terms or no candidate covers two of them.

        A coordinated question ("the <desc-A> at the helm and the <desc-B> in
        the lead") is TWO conjunctions bridged by an unnamed answer node: no
        single paragraph covers both descriptor groups, so whole-question
        coverage ranks accumulation hubs above either true satisfier. Each
        coordination clause with two-plus content terms of its own is rescued
        independently and the per-clause winners are merged in after the
        whole-question survivors. Clauses whose content terms all belong to
        multiword capitalized names self-gate (entity comparisons stay on the
        named-anchor path)."""
        if top_n <= 0:
            return []
        out = self._rescue_one(query, top_n=top_n)
        clauses = [c for c in re.split(r"\band\b|\bwith\b|,\s+", query)
                   if c and c.strip()]
        if len(clauses) >= 2:
            eligible = [c for c in clauses
                        if len(_query_constraint_terms(c)) >= 2]
            if len(eligible) >= 2:
                for c in eligible:
                    out += self._rescue_one(c, top_n=clause_top_n)
        return list(dict.fromkeys(out))

    def _rescue_one(self, query: str, top_n: int) -> List[str]:
        terms = _query_constraint_terms(query)
        if len(terms) < 2:
            return []
        hg = self.env.hg
        # demonym->place augmentation for the terms-only pool: the corpus
        # may state the COUNTRY ("from Nigeria") where the question uses the
        # ADJECTIVE ("Nigerian") — lexically disjoint for the dense encoder,
        # so the only satisfier never enters the pool. Resolve capitalized
        # terms against the corpus's own capitalized vocabulary (_same_place
        # morphology — no gazetteer) and search with the resolved surface
        # forms too. The coverage verifier already equates the pair; this
        # makes the POOL reachable as well.
        _, caps_vocab = self._coverage_state()
        aug = [t for t, _ in terms]
        for t, cap in terms:
            if cap:
                aug += [tok for tok in caps_vocab
                        if tok.lower() != t.lower() and _same_place(t, tok)]
        res = list(hg.search(query, top_k=96))
        # second pool biased to the content terms alone and restricted to
        # ENTITY nodes: the scaffolding vocabulary of the full question
        # can push the conjunction's only satisfier below the dense cut,
        # and hyperedge/summary nodes (which repeat the same fact
        # sentences) otherwise fill most of the 96 slots before the
        # entity filter below gets to keep anything
        res += hg.search(" ".join(aug), top_k=96, type_filter=["entity"])
        cands = []
        seen_ids: set = set()
        for r in res:
            nid = r.get("node_id")
            if not nid or nid in seen_ids:
                continue
            seen_ids.add(nid)
            d = hg.nodes.get(nid, {})
            if d.get("node_type") == "entity":
                cands.append((nid, str(d.get("description") or "")))
        if not cands:
            return []
        ranked = constraint_coverage(query, [text for _, text in cands],
                                     idf=self._corpus_idf(query))
        return [cands[i][0] for i, _, _ in ranked[:top_n]]

    def _coverage_state(self):
        """(containment indexes, capitalized vocabulary) over every entity
        description in the graph — term-independent, cached ON the graph
        object because shared-KB runs reuse one graph across hundreds of
        questions."""
        hg = self.env.hg
        state = getattr(hg, "_coverage_doc_index", None)
        if state is None:
            texts = [str(d.get("description") or "")
                     for d in hg.nodes.values()
                     if d.get("node_type") == "entity"]
            idxs = containment_indexes(texts)
            caps_vocab = sorted(set().union(*(ix[2] for ix in idxs))
                                if idxs else set())
            state = (idxs, caps_vocab)
            hg._coverage_doc_index = state
        return state

    def _corpus_idf(self, query: str):
        """Corpus-GLOBAL term weights for the coverage verifier. The rescue
        pool is biased toward the query's own terms, so pool-relative df
        deflates exactly the rare descriptor the ranking hinges on; true
        document frequency over every entity description restores it."""
        idxs, _ = self._coverage_state()
        return corpus_idf(query, idxs)

    def _credit_expansion_targets(self, query: str, context: Dict[str, Any],
                                  done: set) -> List[str]:
        """Entities whose co-participant neighborhood the current question
        still needs (answer/qa.py::related_expansion_targets), minus the ones
        already expanded this episode."""
        sents = _clean_sentences(context.get("context_text", ""))
        return [n for n in related_expansion_targets(query, sents)
                if n.lower() not in done]

    def _follow_up_targets(self, query: str, context: Dict[str, Any]) -> List[str]:
        sents = _clean_sentences(context.get("context_text", ""))
        typed = missing_entities(query, sents)
        # schema-free complement: described-subject questions over
        # relations the fact tables don't model (the typed hook returns
        # nothing for them) hop to the evidence names most tied to the
        # question by co-occurrence
        return list(dict.fromkeys(typed + bridge_hop_targets(query, sents)))

    def _question_entity_ids(self, query: str) -> List[str]:
        """Graph entity ids for capitalized spans the question itself names
        (exact or substring match only — no semantic fallback, so the cost is
        O(spans) host lookups and no extra device dispatch)."""
        hg = self.env.hg
        out: List[str] = []
        for name in _question_entities(query)[:4]:
            nid = hg.find_entity(name)
            if not nid:
                for hid, d in hg.search_by_name_or_title(name):
                    if d.get("node_type") == "entity":
                        nid = hid
                        break
            if (not nid and len(name.split()) == 1
                    and hg.number_of_nodes() <= 65536):
                # demonym anchor: a lone capitalized adjective ("Norwegian")
                # names no graph entity, but the COUNTRY it derives from
                # usually does — people link to their origin country, so the
                # country node reaches the described person ("the Norwegian
                # glassblower") that no question token names. Morphological
                # stem match only (answer/qa.py::_same_place), no gazetteer.
                # Gated to mid-size graphs: this is an O(N) host scan, and on
                # corpus-scale graphs the anchor's value goes to the search.
                for hid, d in hg.nodes.items():
                    nm = d.get("name")
                    if (d.get("node_type") == "entity" and nm
                            and len(str(nm).split()) == 1
                            and str(nm).lower() != name.lower()
                            and _same_place(name, str(nm))):
                        nid = hid
                        break
            if nid and nid not in out:
                out.append(nid)
        return out

    def _locate_entity(self, name: str) -> Optional[str]:
        """Graph node for a follow-up entity: exact name, substring search,
        then a semantic anchor on the name (env-logged query)."""
        hg = self.env.hg
        nid = hg.find_entity(name)
        if nid:
            return nid
        for hid, d in hg.search_by_name_or_title(name):
            if d.get("node_type") == "entity":
                return hid
        obs, _ = self.env.semantic_anchor(name)
        for item in (obs.get("reranked") or obs.get("selection") or []):
            if item.get("node_type") == "entity" and \
                    name.lower() in (item.get("name") or "").lower():
                return item.get("node_id")
        return None

    # ------------------------------------------------------------- evidence
    def collect_evidence(self, max_summaries: int = 3,
                         max_entities: int = 5,
                         priority_ids: Optional[List[str]] = None
                         ) -> Dict[str, Any]:
        hg = self.env.hg
        # priority ids (follow-up hops) go first so the max_entities cap can
        # never evict the node the question hinges on; set order is arbitrary
        selection_ids = list(dict.fromkeys(
            (priority_ids or []) + sorted(self.env.selection_set)))
        summaries: List[str] = []
        entities: List[str] = []
        for nid in selection_ids:
            d = hg.nodes.get(nid, {})
            if d.get("node_type") == "summary":
                summaries.append(nid)
            elif d.get("node_type") == "entity":
                entities.append(nid)
                parents = d.get("l1_parents") or {}
                if isinstance(parents, str):
                    parents = json_or_none(parents) or {}
                for tid in parents:
                    tid = int_or_none(tid)
                    if tid is None:
                        continue
                    sid = hg.topic_to_summary_id.get(tid)
                    if sid and sid not in summaries:
                        summaries.append(sid)
        summaries = list(dict.fromkeys(summaries))[:max_summaries]
        entities = list(dict.fromkeys(entities))[:max_entities]

        def brief(nid: str) -> Dict[str, Any]:
            d = hg.nodes.get(nid, {})
            return {"node_id": nid, "node_type": d.get("node_type"),
                    "title": (d.get("title") or d.get("name") or "")[:120],
                    "summary": (d.get("summary_text") or d.get("summary")
                                or d.get("description") or "")[:240]}

        summary_briefs = [brief(n) for n in summaries]
        entity_briefs = [brief(n) for n in entities]

        def add_members(summary_id: str, depth: int = 0) -> None:
            if depth > 2 or len(entity_briefs) >= max_entities:
                return
            members = hg.nodes.get(summary_id, {}).get("members") or []
            if isinstance(members, str):
                members = json_or_none(members) or []
            for member in members:
                if len(entity_briefs) >= max_entities:
                    return
                if isinstance(member, str) and member.startswith("sum:"):
                    add_members(member, depth + 1)
                    continue
                ent_id = hg.name_to_entity_id.get(member) if isinstance(member, str) \
                    else None
                if ent_id and ent_id not in entities:
                    entity_briefs.append(brief(ent_id))
                    entities.append(ent_id)

        if len(entity_briefs) < max_entities:
            for sid in summaries:
                add_members(sid)
                if len(entity_briefs) >= max_entities:
                    break
        return {"summaries": summary_briefs, "entities": entity_briefs}
