"""The port's evaluation and benchmark driver against the JAX package's, on
the CPU: ``squad_f1_em``, ``normalize_text``, the rule judges, the
evaluator's diagnosis, ``recall_at_k``, ``run_benchmark``'s rows and
``eval_gate``'s exit code.

The evaluators score the cases of ``tests/test_eval.py``, ``test_judge.py``
and ``test_retrieval_metrics.py`` and the port's answers on the film graph.
The benchmark driver answers and scores three sets in both packages, each
over graphs its own pipeline builds: ``samples/mini_questions.jsonl``
over the graph of ``samples/mini_films.txt`` (``make report``'s first two
steps), ``samples/mini_hotpot.jsonl`` and the first 6 items of
``samples/synth_v4_dev.jsonl`` (a graph per question). Every per-item row
is held equal, field by field: its scores are Python arithmetic over equal
answers. Answers write session files under the working directory, so each
test works in a temporary one.
"""
import json
import sys

import pytest

from ahrag_tpu.cli import benchmark as jbench
from ahrag_tpu.cli import eval_gate as jgate
from ahrag_tpu.cli.demo import run_pipeline as j_pipeline
from ahrag_tpu.eval import answer_eval as jeval
from ahrag_tpu.eval import judge as jjudge
from ahrag_tpu.eval import retrieval as jret
from ahrag_tpu_torch.agent.agent import AHRAG_Agent as TA
from ahrag_tpu_torch.agent.environment import GraphEnvironment as TE
from ahrag_tpu_torch.agent.inference import InferenceEngine as TI
from ahrag_tpu_torch.cli import benchmark as tbench
from ahrag_tpu_torch.cli import eval_gate as tgate
from ahrag_tpu_torch.cli.demo import run_pipeline as t_pipeline
from ahrag_tpu_torch.eval import answer_eval as teval
from ahrag_tpu_torch.eval import judge as tjudge
from ahrag_tpu_torch.eval import retrieval as tret
from chip_smoke import SAMPLES
from tests.test_torch_answer import (_fresh_port_llm, _jax_counts_tokens_natively,  # noqa: F401
                                     fake_llms, film)
from tests.test_torch_build import MINI_FILMS

SQUAD = [("Paris", ["Paris"]), ("the city of Paris", ["Paris France"]), ("anything", []),
         ("", ["x"]), ("", [""]), ("The", ["a"]), ("Tim Burton", ["tim burton", "Burton"]),
         ("1994.", ["1994"]), ("Ed Wood (film)", ["Ed Wood"]), ("Yes", ["Yes", "yes"]),
         ("  Café, naïve—résumé!  ", ["cafe naive resume", "Café naïve résumé"]),
         ("a b a b", ["a b b"]), ("Doctor Strange", ["Doctor   Strange", None])]


@pytest.mark.parametrize("pred,golds", SQUAD)
def test_squad_f1_em_and_normalize_text_match_jax(pred, golds):
    assert teval.squad_f1_em(pred, golds) == jeval.squad_f1_em(pred, golds)
    for text in [pred, *(g for g in golds if g)]:
        assert teval.normalize_text(text) == jeval.normalize_text(text)


def _obj(answer, evidence_text, citations=None, used=None, rationale="", evidence=None):
    return {"answer": answer, "rationale": rationale, "citations": citations or [],
            "context": {"context_text": evidence_text, "used_nodes": used or [],
                        "stats": {"tokens_used": 10}},
            "evidence": evidence or {"summaries": [], "entities": []}}


def _session():
    return {"stats": {"cumulative": {"steps": 2, "expansions": 1, "time_s": 0.1},
                      "actions": [{"action": "expand_parents", "inputs": ["ent:1"]},
                                  {"action": "semantic_anchor", "returned_nodes": ["sum:0"]},
                                  {"action": "expand_children", "inputs": ["sum:2"]}]}}


_EV = "Tim Burton directed Ed Wood. The film premiered in 1994."
JUDGE_CASES = [
    ("Who directed Ed Wood?", _obj("Tim Burton", _EV)),
    ("Who directed Ed Wood?", _obj("Stanley Kubrick", _EV)),
    ("When did the film come out?", _obj("1994", _EV)),
    ("When did the film come out?", _obj("1987", _EV)),
    ("Who directed Ed Wood?", _obj("Tim Burton", _EV, ["ent:1"], ["ent:1"])),
    ("Who directed Ed Wood?", _obj("Tim Burton", _EV, ["ent:999"], ["ent:1"])),
    ("Who directed Ed Wood?", _obj("", "evidence")),
    ("Who directed the film?", _obj("in 1994 the film premiered and many watched", _EV)),
    ("Are A Person and B Person from the same country?", _obj("yes", _EV)),
    ("Were Tim Burton and Ed Wood of the same nationality?",
     _obj("No", _EV, rationale="Tim Burton is American; Ed Wood is a film")),
    ("Who directed Ed Wood?", _obj("Ed Wood", _EV)),
    ("What is the film about?", _obj(
        "The film is a 1994 film directed by someone and it stars many people and it was "
        "released to wide acclaim and the story follows a director through production", _EV)),
    ("How many films did he direct?", _obj("three", _EV)),
    ("Who directed Ed Wood?", _obj("unanswerable", _EV)),
    ("Who directed Ed Wood?", _obj("Marcus Webb", "Marcus Webb fired ceramic bowls in a "
                                   "mountain kiln.\n\n- [sum:8] geology\nGranite weathers.",
                                   ["sum:9"], ["sum:9", "sum:8"], evidence={
                                       "summaries": [
                                           {"node_id": "sum:9", "title": "pottery",
                                            "summary": "ceramic bowls fired in a kiln"},
                                           {"node_id": "sum:8", "title": "geology",
                                            "summary": "granite weathers slowly"}],
                                       "entities": []})),
    ("Who directed Ed Wood?", _obj("Yes, Tim Burton", _EV)),
    ("Which studio produced the film that Tim Burton directed?",
     _obj("Touchstone", "Tim Burton directed Ed Wood. Ed Wood was made by Touchstone.\n"
          "Alice Smith works at Touchstone.")),
]


@pytest.mark.parametrize("case", range(len(JUDGE_CASES)))
def test_rule_judges_and_evaluator_match_jax(case):
    question, obj = JUDGE_CASES[case]
    assert tjudge.judge_faithfulness(obj) == jjudge.judge_faithfulness(obj)
    for fn in ("judge_answer_relevancy", "judge_answer_grounding",
               "judge_contextual_precision"):
        assert getattr(tjudge, fn)(question, obj) == getattr(jjudge, fn)(question, obj), fn
    full = {**obj, "query": question, "gold_answers": ["Tim Burton"],
            "retrieved_nodes": (obj["context"]["used_nodes"] or ["ent:1"]),
            "session_data": _session()}
    for system in ("ah_rag", "naive_rag", "other"):
        for cfg in ({}, {"evaluation": {"judge": {"mode": "parity"}}}):
            assert (teval.AnswerEvaluator(system).evaluate(full, graph=None, config=cfg)
                    == jeval.AnswerEvaluator(system).evaluate(full, graph=None, config=cfg))


@pytest.mark.parametrize("faith,rel,recall,cprec,ground,gold,f1", [
    (0.8, 0.3, 0.9, 1.0, 1.0, 0.0, 0.0), (0.3, 0.8, 0.9, 1.0, 1.0, 0.0, 0.0),
    (0.3, 0.3, 0.9, 1.0, 1.0, 0.0, 0.0), (0.8, 0.8, 0.3, 1.0, 1.0, 0.0, 0.0),
    (0.8, 0.8, 0.9, 0.1, 1.0, 1.0, 0.0), (0.8, 0.8, 0.9, 0.5, 0.25, 1.0, 0.0),
    (0.8, 0.8, 0.9, 0.5, 1.0, 1.0, 40.0), (0.8, 0.8, 0.9, 0.5, 1.0, 1.0, 100.0),
    (0.7, 0.5, 0.5, 0.25, 0.5, 0.0, 60.0)])
def test_diagnosis_formula_matches_jax(faith, rel, recall, cprec, ground, gold, f1):
    m = {"faithfulness": faith, "answer_relevancy": rel, "contextual_recall": recall,
         "contextual_precision": cprec, "answer_grounding": ground, "gold_available": gold,
         "f1": f1}
    assert (teval.AnswerEvaluator().apply_diagnosis_formula(m)
            == jeval.AnswerEvaluator().apply_diagnosis_formula(m))


@pytest.mark.parametrize("reply", [
    '{"correctness": 8, "coverage": 7, "clarity": 9, "overall": 8}',
    'Scores: {"correctness": "6", "coverage": 5.5} done', '{"correctness": "high"}',
    "no json", '{"correctness": 8, "coverage": [1]}', "{broken"])
def test_llm_judge_matches_jax(fake_llms, reply):
    cfg = {"evaluation": {"judge": {"use_llm": True, "max_retries": 2}}}
    outs = []
    for mod in (teval, jeval):
        fake_llms["responses"] = [reply, reply, '{"correctness": 3, "coverage": 4}']
        ev = mod.AnswerEvaluator()
        outs.append((ev.evaluate_qualitative({"answer": "x"}, "q?", cfg),
                     ev.evaluate_generator({"query": "q?"}, {}, "q?", cfg)))
    assert outs[0] == outs[1]


def test_efficiency_readback_matches_jax(tmp_path):
    p = tmp_path / "summary.json"
    p.write_text(json.dumps({"stats": {"cumulative": {"steps": 4, "expansions": 3,
                                                      "time_s": 0.137, "tokens_total": 9}}}))
    for path in (str(p), str(tmp_path / "missing.json")):
        assert (teval.AnswerEvaluator().evaluate_efficiency(path)
                == jeval.AnswerEvaluator().evaluate_efficiency(path))


def test_recall_at_k_matches_jax(film):
    jh, th = film
    golds = [["Tim Burton", "Ed Wood (film)"], ["Tim Burton", "Kathryn Bigelow"], [],
             ["Ed Wood"], ["", "Doctor Strange"], ["American films"]]
    nodes = list(jh.nodes)
    assert nodes == list(th.nodes)
    for retrieved in ([], nodes[:3], nodes[::-1], ["nope", *nodes[2:9]]):
        for g in golds:
            for k in (None, 1, 3, 10):
                assert (tret.recall_at_k(retrieved, g, th, k)
                        == jret.recall_at_k(retrieved, g, jh, k))
                assert (tret.hit_rate_at_k(retrieved, g, th, k)
                        == jret.hit_rate_at_k(retrieved, g, jh, k))
    for nid in nodes:
        assert tret.node_texts(th, nid) == jret.node_texts(jh, nid)


FILM_QUESTIONS = [("Who directed Ed Wood?", ["Tim Burton"]),
                  ("Were Scott Derrickson and Tim Burton of the same nationality?", ["yes"]),
                  ("When was Doctor Strange released?", ["2016"]),
                  ("Which film did Tim Burton direct?", ["Ed Wood"]),
                  ("What is the nationality of Adam Collis?", ["American"])]


@pytest.mark.parametrize("question,golds", FILM_QUESTIONS)
def test_evaluator_scores_port_answers_as_jax(film, tmp_path, question, golds):
    """The port's answers on the film graph (the PR-10 parity set), scored by
    both evaluators and both ``evaluate_item``s."""
    th = film[1]
    env = TE(hg=th, log_dir=str(tmp_path), log_level="off")
    ans = TI(env, TA(env)).run_inference(question)
    item = {"id": "f", "question": question, "answers": golds,
            "gold_titles": ["Tim Burton", "Ed Wood"], "qtype": "film"}
    for cfg in ({}, {"evaluation": {"judge": {"mode": "parity"}}}):
        assert (tbench.evaluate_item(item, "ah_rag", ans, th, cfg, False)
                == jbench.evaluate_item(item, "ah_rag", ans, th, cfg, False))


# ------------------------------------------------------------ the driver
def _bench_both(tmp_path, monkeypatch, **kw):
    monkeypatch.chdir(tmp_path)
    j = jbench.run_benchmark("local", **kw)
    t = tbench.run_benchmark("local", device="cpu", **kw)
    return j, t


def assert_same_report(j, t):
    assert len(t["items"]) == len(j["items"]) > 0
    for a, b in zip(j["items"], t["items"]):
        assert b == a, {k: (a[k], b[k]) for k in a if a[k] != b.get(k)}
    assert t == j


@pytest.fixture(scope="module")
def film_graphs(tmp_path_factory):
    """``make report``'s first step in each package: the mini_films graph."""
    root = tmp_path_factory.mktemp("report")
    j_pipeline(MINI_FILMS, artifacts_dir=str(root / "ja"), graph_dir=str(root / "jg"))
    t_pipeline(MINI_FILMS, artifacts_dir=str(root / "ta"), graph_dir=str(root / "tg"),
               device="cpu")
    return str(root / "jg"), str(root / "tg")


def test_benchmark_over_the_pipeline_graph_matches_jax(film_graphs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = str(SAMPLES / "mini_questions.jsonl")
    j = jbench.run_benchmark("local", system="both", limit=5, data_path=data,
                             graph_dir=film_graphs[0], judge_sample=0.0)
    ms = []
    t = tbench.run_benchmark("local", system="both", limit=5, data_path=data,
                             graph_dir=film_graphs[1], judge_sample=0.0, device="cpu",
                             item_ms=ms, out=str(tmp_path / "r.json"))
    assert_same_report(j, t)
    assert len(ms) == 5 and min(ms) > 0
    assert json.loads((tmp_path / "r.json").read_text()) == json.loads(json.dumps(t))
    assert tbench.to_markdown(t["aggregate"], "local") == jbench.to_markdown(
        j["aggregate"], "local")


@pytest.mark.parametrize("data,limit,system", [("mini_hotpot.jsonl", 6, "both"),
                                               ("synth_v4_dev.jsonl", 6, "both")])
def test_benchmark_per_question_graphs_match_jax(tmp_path, monkeypatch,
                                                 data, limit, system):
    j, t = _bench_both(tmp_path, monkeypatch, system=system, limit=limit,
                       data_path=str(SAMPLES / data))
    assert_same_report(j, t)
    assert {r["system"] for r in t["items"]} == {"ah_rag", "naive"}


def test_benchmark_refuses_network_datasets_and_knob_policy(film, tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="network"):
        tbench.run_benchmark("hotpotqa", device="cpu")
    with pytest.raises(ValueError, match="Unsupported"):
        tbench.load_dataset("squad")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "kp.msgpack").write_bytes(b"")
    cfg = {"rl": {"inference": {"use_knob_policy": True,
                                "knob_policy_path": str(tmp_path / "kp.msgpack")}}}
    with pytest.raises(NotImplementedError, match="knob policy"):
        tbench.run_system("ah_rag", "Who directed Ed Wood?", cfg, film[1])


def _exit_code(main) -> int:
    try:
        main()
    except SystemExit as e:
        return e.code
    return 0


@pytest.mark.parametrize("bars,passed", [(["--f1-min", "50", "--faith-min", "0.5"], True),
                                         (["--f1-min", "101"], False)])
def test_eval_gate_exit_code_matches_jax(tmp_path, monkeypatch, capsys,
                                         bars, passed):
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "local", "--data", str(SAMPLES / "mini_hotpot.jsonl"),
            "--limit", "1", "--out", str(tmp_path / "gate.json"), *bars]
    monkeypatch.setattr(sys, "argv", ["eval_gate", *argv])
    runs = []
    for main in (jgate.main, lambda: tgate.main([*argv, "--device", "cpu"])):
        code = _exit_code(main)
        out = capsys.readouterr().out
        runs.append((code, json.loads(out[out.rindex("{\n"):])))
    assert runs[1] == runs[0]
    assert runs[1] == (0 if passed else 1, {**runs[1][1], "passed": passed})
