"""The port's GraphEnvironment, AHRAG_Agent, InferenceEngine, NaiveRAG,
``RetrievalService.answer`` and the env/agent/answer CLIs against the JAX
package's, on the CPU.

Both packages answer over the same graph: the film graph of
``tests/helpers.py`` built by each, and the XL dev world
(``samples/synth_v4_sharedxl_*``, 1,868 nodes) built and saved once by the
JAX package and loaded by the port, for 24 dev questions. Every field is held
equal except these, which are left out of every comparison: ``time_s`` (in
``used_actions``, ``metrics`` and the session summary), ``session_path``, and
the session's ids and timestamps (``session_id``, ``created_at``, ``ts``).
Scores and semantic scores are held within 1e-4 (the result entries round to
four decimals); everything else is equal. Session files are written under a
temporary working directory, where neither package finds
``configs/ahrag.yaml``, so both read the same default configuration.
"""
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import pytest

from ahrag_tpu.agent.agent import AHRAG_Agent as JA
from ahrag_tpu.agent.agent import run_agent_once as j_run_once
from ahrag_tpu.agent.environment import GraphEnvironment as JE
from ahrag_tpu.agent.inference import InferenceEngine as JI
from ahrag_tpu.agent.inference import pick_top_ids as j_pick
from ahrag_tpu.answer.generator import AnswerGenerator as JGen
from ahrag_tpu.baselines.naive import NaiveRAG as JNaive
from ahrag_tpu.cli import agent as jcli_agent
from ahrag_tpu.cli import answer as jcli_answer
from ahrag_tpu.cli import env as jcli_env
from ahrag_tpu.graph import HierarchicalGraph as JHG
from ahrag_tpu.serve import RetrievalService as JRS
from ahrag_tpu_torch import serve as tserve
from ahrag_tpu_torch.agent.agent import AHRAG_Agent as TA
from ahrag_tpu_torch.agent.agent import run_agent_once as t_run_once
from ahrag_tpu_torch.agent.environment import GraphEnvironment as TE
from ahrag_tpu_torch.agent.inference import InferenceEngine as TI
from ahrag_tpu_torch.agent.inference import pick_top_ids as t_pick
from ahrag_tpu_torch.answer.generator import AnswerGenerator as TGen
from ahrag_tpu_torch.baselines import NaiveRAG as TNaive
from ahrag_tpu_torch.cli import agent as tcli_agent
from ahrag_tpu_torch.cli import answer as tcli_answer
from ahrag_tpu_torch.cli import env as tcli_env
from ahrag_tpu_torch.graph import HierarchicalGraph as THG
from chip_smoke import xl_graph, xl_questions
from tests.test_torch_answer import (_fresh_port_llm, _jax_counts_tokens_natively,  # noqa: F401
                                     fake_llms, film, film_evidence)

VOLATILE = {"time_s", "session_path", "session_id", "created_at", "ts"}
SCORES = {"score", "semantic"}
FILM_QUERIES = ["Were Scott Derrickson and Tim Burton of the same nationality?",
                "Who directed Ed Wood?", "American films and directors", "Tim Burton",
                "Who is the director of Doctor Strange?", "When was Ed Wood released?"]
XL_QUESTIONS = xl_questions()[:24]


def assert_same(a, b, path="$"):
    """``a`` equals ``b`` but for the ``VOLATILE`` keys, with ``SCORES``
    within 1e-4."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            if k in VOLATILE:
                continue
            if k in SCORES and isinstance(a[k], float):
                assert isinstance(b[k], float) and abs(a[k] - b[k]) <= 1e-4, (path, k)
            else:
                assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def envs(film, tmp_path, **kw):
    jh, th = film
    return (JE(hg=jh, log_dir=str(tmp_path / "jax"), **kw),
            TE(hg=th, log_dir=str(tmp_path / "port"), **kw))


def session_files(env):
    out = {}
    for name in sorted(os.listdir(env.session_path)):
        text = open(os.path.join(env.session_path, name), encoding="utf-8").read()
        out[name] = ([json.loads(ln) for ln in text.splitlines()] if name.endswith(".jsonl")
                     else json.loads(text))
    return out


def drive(env, ids):
    """Every action of the environment, in an order that touches each branch;
    returns the (observation, info) or info of each step."""
    burton, wood = ids["Tim Burton"], ids["Ed Wood"]
    steps = [env.reset(), env.reset(seed_query="Who directed Ed Wood?")]
    top = steps[-1][0]["selection"][0]["node_id"]
    steps += [env.set_filters(type_filter=["entity", "summary"]),
              env.set_search_weights(alpha=0.7, top_k=4),
              env.semantic_anchor("Tim Burton", member_top_m=None),
              env.expand_parents([top, burton]),
              env.expand_children(["sum:0", "sum:1"], limit=3),
              env.expand_children(["nope", "sum:2"]),
              env.expand_related([burton, "sum:0"]),
              env.expand_related(["sum:1"], limit=2),
              env.expand_to_lca([burton, wood]),
              env.expand_to_lca([]),
              env.query_node_details(burton),
              env.query_node_details("sum:2"),
              env.query_node_details("nope"),
              env.commit_selection([burton, wood, "nope", burton]),
              env.set_debug(True),
              env.semantic_anchor("American cinema", top_k=3),
              env.set_filters(judge_overall_min=1.0, confidence_min=5.0),
              env.semantic_anchor("directors"),
              env.set_search_weights(beta=0.3, gamma=0.2, delta=0.0, member_top_m=2),
              env.semantic_anchor("films", type_filter=["summary"]),
              env.end_episode()]
    return steps


def test_environment_actions_match_jax(film, tmp_path):
    je, te = envs(film, tmp_path)
    ids = {n: film[0].find_entity(n) for n in ("Tim Burton", "Ed Wood")}
    assert ids == {n: film[1].find_entity(n) for n in ids}
    assert_same(drive(te, ids), drive(je, ids))
    assert_same(te.stats, je.stats)
    assert (te.selection_order, te.frontier_set) == (je.selection_order, je.frontier_set)
    jf, tf = session_files(je), session_files(te)
    assert set(tf) == set(jf) == {"session.json", "events.jsonl", "summary.json"}
    assert_same(tf, jf)


def test_environment_without_logging_or_debug_matches_jax(film, tmp_path):
    je, te = envs(film, tmp_path, logging_enabled=False, debug=True)
    for env in (je, te):
        assert not os.path.exists(env.session_path)
    ids = {n: film[0].find_entity(n) for n in ("Tim Burton", "Ed Wood")}
    assert_same(drive(te, ids), drive(je, ids))
    assert not os.path.exists(te.session_path)
    j_off, t_off = envs(film, tmp_path, log_level="off")
    assert_same(t_off.reset(seed_query="Ed Wood"), j_off.reset(seed_query="Ed Wood"))
    assert session_files(t_off).keys() == session_files(j_off).keys() == {"session.json"}


def test_environment_loads_its_graph_on_the_named_device(film, tmp_path):
    film[0].save(str(tmp_path / "g"))
    te = TE(graph_dir=str(tmp_path / "g"), log_dir=str(tmp_path / "s"), device="cpu")
    je = JE(graph_dir=str(tmp_path / "g"), log_dir=str(tmp_path / "s"))
    assert str(te.hg.device) == "cpu" and te.hg.number_of_nodes() == 10
    assert_same(te.reset(seed_query="Who directed Ed Wood?"),
                je.reset(seed_query="Who directed Ed Wood?"))


@pytest.mark.parametrize("query", FILM_QUERIES)
def test_rule_agent_and_run_agent_once_match_jax(film, tmp_path, query):
    je, te = envs(film, tmp_path)
    ja, ta = JA(je), TA(te)
    assert ta.use_llm is ja.use_llm is False
    for obs_j, obs_t in zip(drive(je, {n: film[0].find_entity(n)
                                       for n in ("Tim Burton", "Ed Wood")}),
                            drive(te, {n: film[1].find_entity(n)
                                       for n in ("Tim Burton", "Ed Wood")})):
        if isinstance(obs_j, tuple):
            assert ta.decide(obs_t[0]) == ja.decide(obs_j[0])
    je, te = envs(film, tmp_path / "once")
    assert_same(t_run_once(te, TA(te), query, steps=3), j_run_once(je, JA(je), query, steps=3))


@pytest.mark.parametrize("replies", [
    ['{"action": "expand_related", "params": {"node_ids": ["sum:0"]}}'],
    ["garbage not json", '{"action": "commit_selection", "params": ["x"]}'],
    ["garbage", "still garbage"],
    ['{"action": "semantic_anchor", "params": {"query": "Doctor Strange"}}',
     '{"action": "query_node_details", "params": {"node_ids": ["sum:1"]}}',
     '{"action": "expand_children", "params": {"node_ids": ["sum:2"]}}',
     '{"action": "end_episode", "thought": "done"}'],
], ids=["json", "second-attempt", "falls-back", "episode"])
def test_llm_agent_matches_jax(film, tmp_path, fake_llms, replies):
    out = []
    for E, A, run, env in ((JE, JA, j_run_once, envs(film, tmp_path)[0]),
                           (TE, TA, t_run_once, envs(film, tmp_path)[1])):
        fake_llms["responses"] = list(replies)
        fake_llms["n"] = 0
        agent = A(env, use_llm=True)
        assert agent.use_llm is True
        obs, _ = env.reset(seed_query="Tim Burton")
        first = agent.decide(obs)
        fake_llms["responses"] = list(replies)
        out.append((first, fake_llms["n"], run(env, agent, "Tim Burton", steps=3)))
    assert_same(out[1], out[0])


OBSERVATIONS = [
    ({"selection": [
        {"node_id": "e_film", "node_type": "entity", "entity_type": "work", "score": 0.9,
         "name": "Ed Wood"},
        {"node_id": "e_person", "node_type": "entity", "entity_type": "person",
         "score": 0.5, "name": "Tim Burton"},
        {"node_id": "s1", "node_type": "summary", "score": 0.8}]},
     "Who is the director of Ed Wood?"),
    ({"selection": [
        {"node_id": "e1", "node_type": "entity", "entity_type": "person", "score": 0.3,
         "name": "Tim Burton"},
        {"node_id": "e2", "node_type": "entity", "entity_type": "person", "score": 0.2,
         "name": "Scott Derrickson"},
        {"node_id": "e3", "node_type": "entity", "entity_type": "person", "score": 0.9,
         "name": "Unrelated Person"}]},
     "Were Scott Derrickson and Tim Burton of the same nationality?"),
    ({"selection": [
        {"node_id": "w1", "node_type": "entity", "entity_type": "work", "score": 0.4,
         "name": "Some Film"},
        {"node_id": "d1", "node_type": "entity", "entity_type": "date", "score": 0.1}],
      "seeds": [{"node_id": "s9", "node_type": "summary", "score": 0.7},
                {"node_id": "w1", "node_type": "entity"},
                {"node_id": "o1", "node_type": "entity", "entity_type": "organization",
                 "score": 0.6}]},
     "When was the movie born?"),
    ({"selection": [], "seeds": []}, "anything"),
]


@pytest.mark.parametrize("obs,query", OBSERVATIONS)
def test_pick_top_ids_matches_jax(obs, query):
    assert t_pick(obs, query) == j_pick(obs, query)
    for q in ("Which film?", "Where is the location?", "plain", ""):
        assert t_pick(obs, q) == j_pick(obs, q)


@pytest.mark.parametrize("caps", [(3, 5, []), (1, 1, []), (0, 0, []), (2, 8, ["sum:1"])])
def test_collect_evidence_matches_jax(film, tmp_path, caps):
    je, te = envs(film, tmp_path)
    engines = []
    for env, E in ((je, JI), (te, TI)):
        env.reset(seed_query="American films and directors")
        env.commit_selection(list(env.hg.nodes))
        engines.append(E(env, None))
    ms, me, prio = caps
    ev = engines[1].collect_evidence(max_summaries=ms, max_entities=me, priority_ids=prio)
    assert ev == engines[0].collect_evidence(max_summaries=ms, max_entities=me,
                                             priority_ids=prio)
    assert len(ev["summaries"]) <= ms and len(ev["entities"]) <= me


def assert_same_answers(t_out, j_out):
    assert_same(t_out, j_out)
    for k in ("answer", "rationale", "citations", "retrieved_nodes"):
        assert t_out[k] == j_out[k], k
    assert [e["node_id"] for e in t_out["evidence"]["entities"]] == \
        [e["node_id"] for e in j_out["evidence"]["entities"]]
    assert t_out["context"]["context_text"] == j_out["context"]["context_text"]


@pytest.mark.parametrize("steps", [4, 1])
@pytest.mark.parametrize("query", FILM_QUERIES)
def test_inference_on_the_film_graph_matches_jax(film, tmp_path, query, steps):
    je, te = envs(film, tmp_path)
    j_out = JI(je, JA(je)).run_inference(query, steps=steps)
    t_out = TI(te, TA(te)).run_inference(query, steps=steps)
    assert_same_answers(t_out, j_out)
    assert t_out["answer"] and t_out["retrieved_nodes"]
    jf, tf = session_files(je), session_files(te)
    assert set(tf) == set(jf) == {"session.json", "events.jsonl", "summary.json",
                                  "answer.json"}
    assert_same(tf, jf)
    assert any(e.get("event") == "context_assembled" for e in tf["events.jsonl"])


def test_inference_with_llm_decisions_matches_jax(film, tmp_path, fake_llms):
    replies = ['{"action": "expand_children", "params": {"node_ids": ["sum:0"]}}',
               '{"action": "semantic_anchor", "params": {"query": "Ed Wood"}}',
               "no json"]
    outs = []
    for E, A, I, env in ((JE, JA, JI, envs(film, tmp_path)[0]),
                         (TE, TA, TI, envs(film, tmp_path)[1])):
        fake_llms["responses"] = list(replies)
        outs.append(I(env, A(env, use_llm=True)).run_inference("Who directed Ed Wood?"))
    assert_same_answers(outs[1], outs[0])


@pytest.fixture(scope="module")
def xl(tmp_path_factory):
    """The XL dev world built and indexed once by the JAX package, saved, and
    loaded by the port onto the CPU."""
    jh = xl_graph(JHG(encoder_name="hashed"))
    jh.build_vector_index(layers=(0, 1, 2))
    d = tmp_path_factory.mktemp("xl")
    jh.save(str(d))
    th = THG.load(str(d), device="cpu")
    assert th.number_of_nodes() == jh.number_of_nodes() == 1868
    return jh, th, str(d)


@pytest.mark.parametrize("item", XL_QUESTIONS, ids=lambda it: it["id"])
def test_inference_on_the_xl_world_matches_jax(xl, tmp_path, item):
    jh, th, _ = xl
    je = JE(hg=jh, log_dir=str(tmp_path / "jax"), log_level="off")
    te = TE(hg=th, log_dir=str(tmp_path / "port"), log_level="off")
    j_out = JI(je, JA(je)).run_inference(item["question"])
    t_out = TI(te, TA(te)).run_inference(item["question"])
    assert_same_answers(t_out, j_out)


def test_service_answer_matches_jax(film, xl, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cases = [(film[0], film[1], FILM_QUERIES[:3]),
             (xl[0], xl[1], [it["question"] for it in XL_QUESTIONS[:4]])]
    for jh, th, queries in cases:
        jsvc, tsvc = JRS(hg=jh, max_wait_s=0.002), tserve.RetrievalService(
            hg=th, max_wait_s=0.002, device="cpu")
        for q in queries:
            t_ans = tsvc.answer(q)
            assert set(t_ans) == {"query", "answer", "rationale", "citations",
                                  "retrieved_nodes", "metrics"}
            assert_same(t_ans, jsvc.answer(q))
        assert "answer" in tsvc.stats()["timers"]
        jsvc.close()
        tsvc.close()
    sessions = os.listdir(tmp_path / "artifacts" / "sessions")
    assert len(sessions) == 2 * (3 + 4)


def _post(base, path, obj):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_answer(film, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    svc = tserve.RetrievalService(hg=film[1], max_wait_s=0.002, device="cpu")
    server = tserve.serve_http(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    for q in FILM_QUERIES[:2]:
        status, body = _post(base, "/answer", {"query": q, "steps": 3})
        assert status == 200
        assert_same(body, svc.answer(q, steps=3))
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/answer", {})
    assert err.value.code == 400
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()
    svc.close()


@pytest.mark.parametrize("query", FILM_QUERIES[:4])
@pytest.mark.parametrize("top_k", [5, 2])
def test_naive_rag_matches_jax(film, query, top_k):
    jh, th = film
    assert_same(TNaive(th, TGen()).run(query, top_k=top_k),
                JNaive(jh, JGen()).run(query, top_k=top_k))


@pytest.fixture(scope="module")
def film_dir(film, tmp_path_factory):
    d = tmp_path_factory.mktemp("film_graph")
    film[0].save(str(d))
    return str(d)


def _json_docs(text):
    """The JSON documents a CLI printed one after another."""
    dec, out, i = json.JSONDecoder(), [], 0
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        obj, i = dec.raw_decode(text, i)
        out.append(obj)
    return out


def _both_clis(jmod, tmod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["cli", *argv])
    jmod.main()
    j_docs = _json_docs(capsys.readouterr().out)
    tmod.main([*argv, "--device", "cpu"])
    t_docs = _json_docs(capsys.readouterr().out)
    assert t_docs and len(t_docs) == len(j_docs)
    assert_same(t_docs, j_docs)
    return t_docs


def test_env_cli_matches_jax(film, film_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    burton = film[0].find_entity("Tim Burton")
    docs = _both_clis(jcli_env, tcli_env,
                      ["Who directed Ed Wood?", "--graph", film_dir, "--filters",
                       "type=entity,summary", "judge>=0", "--weights", "alpha=0.7",
                       "top_k=4", "bogus", "--select", burton, "--expand", "related",
                       "--debug", "--end"], monkeypatch, capsys)
    assert docs[1]["added"] == [burton] and "stats" in docs[-1]
    _both_clis(jcli_env, tcli_env, ["Tim Burton", "--graph", film_dir, "--expand",
                                    "children"], monkeypatch, capsys)


def test_agent_cli_matches_jax(film_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    docs = _both_clis(jcli_agent, tcli_agent, ["Who directed Ed Wood?", "--graph",
                                                film_dir, "--steps", "2"],
                      monkeypatch, capsys)
    assert docs[0]["stats"]["cumulative"]["steps"] >= 2


def test_answer_cli_matches_jax(film, film_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ev.json").write_text(json.dumps(film_evidence(film[0])))
    for extra in ([], ["--budget", "60"]):
        docs = _both_clis(jcli_answer, tcli_answer,
                          ["Who directed Ed Wood?", "--evidence", str(tmp_path / "ev.json"),
                           "--graph", film_dir, *extra], monkeypatch, capsys)
        assert docs[0]["answer"]["answer"]
