"""The port's answer layer against the JAX package's, on the same inputs.

``qa``, ``extractive``, ``context`` and ``generator`` of ``ahrag_tpu_torch``
are copies of the JAX package's modules; here both run on the film graph of
``tests/helpers.py`` and on contexts built from the XL dev world
(``samples/synth_v4_sharedxl_*``) for 24 dev questions, and everything they
return is held equal: strings, ids, lists, fact tables and integer counts. No
float is compared with a tolerance here: the coverage weights are the same
Python arithmetic in both packages, and are equal.

Token counts decide which evidence survives a context's budget, so the JAX
package counts on the path it takes wherever ``tiktoken`` cannot load its
vocabulary (which needs the network): its native estimator. The module fixture
below pins that path: ``tiktoken`` off, and the JAX package's loader pointed at
a library compiled from the JAX package's own ``ahrag_native.cpp`` into a
temporary directory, never at the port's build. A test holds the two
``count_tokens`` equal on every text the parity tests build, and another holds
the port's copy of the source equal to the JAX package's.
"""
import os
import subprocess

import pytest

import ahrag_tpu.utils.tokens as jtokens
from ahrag_tpu import native as jnative
from ahrag_tpu.answer import context as jctx
from ahrag_tpu.answer import extractive as jext
from ahrag_tpu.answer import generator as jgen
from ahrag_tpu.answer import qa as jqa
from ahrag_tpu.graph import HierarchicalGraph as JHG
from ahrag_tpu.utils import llm as jllm
from ahrag_tpu_torch import native
from ahrag_tpu_torch.answer import context as tctx
from ahrag_tpu_torch.answer import extractive as text
from ahrag_tpu_torch.answer import generator as tgen
from ahrag_tpu_torch.answer import qa as tqa
from ahrag_tpu_torch.graph import HierarchicalGraph as THG
from ahrag_tpu_torch.utils import llm as tllm
from ahrag_tpu_torch.utils import tokens as ttokens
from chip_smoke import xl_graph, xl_paragraphs, xl_questions
from tests.helpers import build_film_graph
from tests.test_torch_host import port_film_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL_QUESTIONS = xl_questions()[:24]
FILM_QUERIES = ["Who directed Ed Wood?", "Who directed the film Ed Wood?",
                "Were Scott Derrickson and Tim Burton of the same nationality?",
                "When was Doctor Strange released?", "Which film did Tim Burton direct?",
                "What is the nationality of Adam Collis?", "Kathryn Bigelow"]
CTX_CFG = {"skeleton_ratio": 0.2, "reserve_ratio": 0.1, "enable_kept_spans": True,
           "enable_cache": True, "summarizer_max_tokens": 256,
           "rank_weights": {"judge": 0.4, "conf": 0.2, "layer": 0.4}}


JAX_NATIVE_SOURCE = os.path.join(ROOT, "ahrag_tpu", "native", "ahrag_native.cpp")


@pytest.fixture(scope="module", autouse=True)
def _jax_counts_tokens_natively(tmp_path_factory):
    """The JAX package counts tokens with a library built from its own source."""
    so = tmp_path_factory.mktemp("jax_native") / "libahrag_native.so"
    subprocess.run([native.find_cxx(), *native.CXX_FLAGS, "-o", str(so),
                    JAX_NATIVE_SOURCE, "-lpthread"], check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtokens, "tiktoken", None)
        mp.setattr(jnative, "_SO", str(so))
        mp.setattr(jnative, "_tried", False)
        mp.setattr(jnative, "_lib", None)
        assert jnative.available()
        yield


@pytest.fixture(autouse=True)
def _fresh_port_llm():
    """The port's own process-wide LLM manager, reset around every test (the
    shared conftest resets the JAX package's)."""
    tllm.reset_llm_manager()
    yield
    tllm.reset_llm_manager()


@pytest.fixture
def fake_llms():
    """One deterministic fake backend installed in both packages' managers;
    yields its recorder (``responses`` are popped in call order, across both)."""
    calls = {"n": 0, "responses": [], "default": '{"ok": true}'}

    def backend(model, messages, temperature, max_tokens):
        calls["n"] += 1
        return calls["responses"].pop(0) if calls["responses"] else calls["default"]

    jllm.get_llm_manager().set_backend(backend)
    tllm.get_llm_manager().set_backend(backend)
    yield calls
    jllm.get_llm_manager().set_backend(None)
    tllm.get_llm_manager().set_backend(None)


@pytest.fixture(scope="module")
def film():
    jh, th = build_film_graph(), port_film_graph()
    jh.build_vector_index(layers=(0, 1, 2))
    th.build_vector_index(layers=(0, 1, 2))
    return jh, th


@pytest.fixture(scope="module")
def xl_nodes():
    """The XL dev world's nodes in both packages' graphs (no vector index:
    context assembly reads only the node table)."""
    return xl_graph(JHG(encoder_name="hashed")), xl_graph(THG(encoder_name="hashed",
                                                               device="cpu"))


def film_evidence(hg):
    """The evidence of ``tests/test_answer.py``: two summaries, two entities."""
    def brief(nid):
        d = hg.nodes[nid]
        return {"node_id": nid, "title": (d.get("title") or d.get("name") or "")[:120],
                "summary": (d.get("summary_text") or d.get("description") or "")[:240]}
    return {"summaries": [brief("sum:0"), brief("sum:2")],
            "entities": [brief(hg.find_entity("Tim Burton")),
                         brief(hg.find_entity("Ed Wood"))]}


def xl_evidence(hg, item):
    """A question's gold paragraphs, the two paragraphs after each and their
    topic summary (the first eight paragraphs for a question without gold)."""
    order = list(hg.name_to_entity_id)
    idx = [order.index(t) for t in item["gold_titles"] if t in hg.name_to_entity_id]
    ents = list(dict.fromkeys(order[j] for i in idx for j in (i, i + 1, i + 2)
                              if j < len(order))) or order[:8]
    nids = [hg.name_to_entity_id[n] for n in ents]
    sums = list(dict.fromkeys(f"sum:{order.index(n) // 64}" for n in ents))
    return {"summaries": [{"node_id": s} for s in sums],
            "entities": [{"node_id": n} for n in nids]}


def both_contexts(jh, th, evidence_of, budget, cfg=CTX_CFG):
    jc = jctx.ContextProcessor().build_context(evidence_of(jh), jh, budget, dict(cfg))
    tc = tctx.ContextProcessor().build_context(evidence_of(th), th, budget, dict(cfg))
    assert tc == jc
    return tc


def assert_fact_layer_equal(query, context_text):
    """Every fact-layer and span function the answer path calls, both packages."""
    sents = text._clean_sentences(context_text)
    assert sents == jext._clean_sentences(context_text)
    assert vars(tqa.extract_facts(sents)) == vars(jqa.extract_facts(sents))
    for fn in ("answer_from_facts", "missing_entities", "related_expansion_targets",
               "unanswerable", "answer_subjects"):
        assert getattr(tqa, fn)(query, sents) == getattr(jqa, fn)(query, sents), fn
    assert text.bridge_hop_targets(query, sents) == jext.bridge_hop_targets(query, sents)
    for span_scoring in (True, False):
        assert text.extract_answer(query, context_text, allow_span_scoring=span_scoring) == \
            jext.extract_answer(query, context_text, allow_span_scoring=span_scoring)
    assert tqa._query_constraint_terms(query) == jqa._query_constraint_terms(query)
    assert tqa._question_entities(query) == jqa._question_entities(query)


def assert_counts_equal(texts):
    for t in texts:
        assert ttokens.count_tokens(t) == jtokens.count_tokens(t), t


@pytest.mark.parametrize("budget", [800, 120, 60, 25])
def test_film_context_and_fact_layer_match_jax(film, budget):
    jh, th = film
    ctx = both_contexts(jh, th, film_evidence, budget)
    if budget == 800:
        assert "[DETAIL:" in ctx["context_text"] and len(ctx["used_nodes"]) == 4
    for q in FILM_QUERIES:
        assert_fact_layer_equal(q, ctx["context_text"])
    assert_counts_equal([ctx["context_text"], *ctx["context_text"].splitlines()])


def test_context_cache_kept_spans_and_brief_match_jax(film):
    jh, th = film
    jcp, tcp = jctx.ContextProcessor(), tctx.ContextProcessor()
    first = tcp.build_context(film_evidence(th), th, 120, {})
    assert tcp.build_context(film_evidence(th), th, 120, {}) is first     # cached
    assert first == jcp.build_context(film_evidence(jh), jh, 120, {})
    uncached = tcp.build_context(film_evidence(th), th, 120, {"enable_cache": False})
    assert uncached == first and uncached is not first
    samples = ["Born 1958-08-25 in Burbank; not in 1959.", "Revenue rose 12.5% in 2016",
               "2016年5月3日 不 没有", "no numbers never", ""]
    for s in samples:
        assert tctx.extract_kept_spans(s) == jctx.extract_kept_spans(s)
    long = ("Tim Burton is an American filmmaker. He directed Ed Wood; the film won "
            "two Academy Awards. " * 6)
    for limit in (20, 60, 160, 400):
        assert tcp._brief(long, limit) == jcp._brief(long, limit)
    for target in (0, 5, 12, 40):
        assert tcp._compress(long, target, subject="Ed Wood") == \
            jcp._compress(long, target, subject="Ed Wood")
    for x in (None, "7.5", 12, "abc", [1], float("nan")):
        assert tctx._normalize_float(x) == jctx._normalize_float(x)


@pytest.mark.parametrize("item", XL_QUESTIONS, ids=lambda it: it["id"])
def test_xl_context_and_fact_layer_match_jax(xl_nodes, item):
    jh, th = xl_nodes
    q = item["question"]
    for budget in (6000, 300):
        ctx = both_contexts(jh, th, lambda hg: xl_evidence(hg, item), budget)
        assert_fact_layer_equal(q, ctx["context_text"])
        assert_counts_equal([ctx["context_text"], *ctx["context_text"].splitlines()])
        assert tgen.AnswerGenerator().generate(q, ctx, {}) == \
            jgen.AnswerGenerator().generate(q, ctx, {})


def test_coverage_verifier_matches_jax(xl_nodes):
    """containment_indexes over every XL paragraph, corpus_idf and
    constraint_coverage for each question, and _same_place's morphology."""
    texts = [body for _, body in xl_paragraphs()]
    tix, jix = tqa.containment_indexes(texts), jqa.containment_indexes(texts)
    assert tix == jix
    for item in XL_QUESTIONS:
        q = item["question"]
        idf = tqa.corpus_idf(q, tix)
        assert idf == jqa.corpus_idf(q, jix)
        assert tqa.constraint_coverage(q, texts[:400], idf=idf) == \
            jqa.constraint_coverage(q, texts[:400], idf=idf)
        assert tqa.constraint_coverage(q, texts[:50]) == jqa.constraint_coverage(q, texts[:50])
    for a, b in (("Nigerian", "Nigeria"), ("Kenyan", "Kenya"), ("French", "France"),
                 ("Chile", "Chilean"), ("Leipzig", "Lyon")):
        assert tqa._same_place(a, b) == jqa._same_place(a, b)
    assert text._STOPWORDS == jext._STOPWORDS


@pytest.mark.parametrize("query", FILM_QUERIES)
def test_generator_fallback_matches_jax(film, query):
    jh, th = film
    ctx = both_contexts(jh, th, film_evidence, 800)
    out = tgen.AnswerGenerator().generate(query, ctx, {"use_llm": False})
    assert out == jgen.AnswerGenerator().generate(query, ctx, {"use_llm": False})
    assert set(out) == {"answer", "rationale", "citations"}
    assert all(c in ctx["used_nodes"] for c in out["citations"])


@pytest.mark.parametrize("ctx", [
    {"context_text": "# Evidence Skeleton\n"
                     "- [e1] (entity) Tim Burton :: American filmmaker and director\n"
                     "- [e2] (entity) Scott Derrickson :: American director of horror films\n",
     "used_nodes": ["e1", "e2"], "stats": {}},
    {"context_text": "- [e1] (entity) Somebody :: nothing of note here\n"
                     "- [s1] (summary) Things :: unrelated words only\n",
     "used_nodes": ["e1", "s1"], "stats": {}},
    {"context_text": "", "used_nodes": [], "stats": {}},
], ids=["two-entities", "irrelevant", "empty"])
@pytest.mark.parametrize("query", ["Are Tim Burton and Scott Derrickson of the same "
                                   "nationality?", "Which film did he direct?",
                                   "What country is it in?", "plain words only"])
def test_generator_synthesis_matches_jax(ctx, query):
    assert tgen.AnswerGenerator().generate(query, ctx, {}) == \
        jgen.AnswerGenerator().generate(query, ctx, {})


@pytest.mark.parametrize("reply,calls", [
    ('{"answer": "Tim Burton", "rationale": "The evidence states it.", '
     '"citations": ["sum:0", "bogus:1"]}', 1),
    ('prefix {"answer": 12, "rationale": null, "citations": "sum:0"} suffix', 1),
    ("no json here at all", 3),
    ('{"answer": "missing keys"}', 3),
    ("{not: json}", 3),
], ids=["json", "odd-types", "no-json", "missing-keys", "bad-json"])
def test_generator_llm_path_matches_jax(film, fake_llms, reply, calls):
    jh, th = film
    ctx = both_contexts(jh, th, film_evidence, 800)
    fake_llms["default"] = reply
    cfg = {"use_llm": True, "max_retries": 2}
    out = tgen.AnswerGenerator().generate("Who directed Ed Wood?", ctx, cfg)
    assert fake_llms["n"] == calls
    assert out == jgen.AnswerGenerator().generate("Who directed Ed Wood?", ctx, cfg)
    assert fake_llms["n"] == 2 * calls
    if calls == 1 and "Tim Burton" in reply:
        assert out == {"answer": "Tim Burton", "rationale": "The evidence states it.",
                       "citations": ["sum:0"]}    # citations whitelisted


def test_generator_refuses_a_reader_checkpoint(film):
    jh, th = film
    ctx = both_contexts(jh, th, film_evidence, 800)
    with pytest.raises(NotImplementedError, match="span reader is not ported"):
        tgen.AnswerGenerator().generate("Who directed Ed Wood?", ctx,
                                        {"reader_ckpt": "checkpoints/reader.msgpack"})
    # reader_only without a checkpoint answers nothing from spans, as in JAX
    cfg = {"reader_only": True}
    assert tgen.AnswerGenerator().generate("Who directed Ed Wood?", ctx, cfg) == \
        jgen.AnswerGenerator().generate("Who directed Ed Wood?", ctx, cfg)


def test_native_source_is_the_jax_package_copy():
    """The port's ``ahrag_native.cpp`` is the JAX package's plus one comment line,
    so ``token_estimate`` (and the featurizer) are the same code in both."""
    port = native.SOURCE.read_text().splitlines(keepends=True)
    with open(JAX_NATIVE_SOURCE) as f:
        jax_src = f.read()
    assert port[0].startswith("// Copied verbatim from ahrag_tpu/native/ahrag_native.cpp")
    assert "".join(port[1:]) == jax_src
    assert "int64_t token_estimate(const char* text, int64_t len) {" in jax_src


def test_count_tokens_matches_jax_native_estimator():
    assert jnative._SO != native.build()["path"]
    assert os.path.dirname(jnative._SO) != str(native.BUILD_DIR)
    texts = ["", "a", "Tim Burton directed Ed Wood in 1994.", "東京タワー 😀 naïve",
             "x" * 999, " ".join(body for _, body in xl_paragraphs()[:40])]
    assert ttokens.count_tokens("") == 0
    assert_counts_equal(texts)
    for t in texts[1:]:
        assert ttokens.count_tokens(t) == native.token_estimate(t) >= 1


MODULES = ["knowledge_extraction", "semantic_aggregation", "agent_decision",
           "answer_generation", "evaluation_judge", "unknown_module"]


def _managers(cfg_overlay=None):
    from ahrag_tpu.utils.config import load_config as jload
    from ahrag_tpu_torch.utils.config import load_config as tload
    return (jllm.LLMClientManager(jload(overrides=cfg_overlay)),
            tllm.LLMClientManager(tload(overrides=cfg_overlay)))


@pytest.mark.parametrize("module", MODULES)
def test_llm_module_config_and_switches_match_jax(module, monkeypatch):
    for overlay in (None, {"llm": {"enabled": True,
                                   "modules": {"answer_generation": {"enabled": True,
                                                                     "retry_wait": 0.5}}}}):
        jm, tm = _managers(overlay)
        assert tm.model_config(module) == jm.model_config(module)
        assert tm.is_enabled(module) == jm.is_enabled(module)
        enum = [m for m in tllm.LLMModule if m.value == module]
        if enum:
            assert tm.is_enabled(enum[0]) == jm.is_enabled(jllm.LLMModule(module))
    for key in ("DEEPSEEK_API_KEY", "KIMI_API_KEY", "OPENAI_API_KEY"):
        monkeypatch.delenv(key, raising=False)
    jm, tm = _managers({"llm": {"enabled": True, "modules": {module: {"enabled": True}}}})
    msgs = [{"role": "user", "content": "hi"}]
    for m in (jm, tm):
        with pytest.raises(RuntimeError) as err:
            m.chat(module, msgs)
        assert "No LLM client available" in str(err.value) or \
            "LLM disabled" in str(err.value)
    assert tm.chat_or_none(module, msgs) is None
    jm, tm = _managers()
    for m in (jm, tm):
        with pytest.raises(RuntimeError, match="LLM disabled"):
            m.chat(module, msgs)
    assert tm.chat_or_none(module, msgs) is None


def test_llm_fake_backend_and_singleton_match_jax(fake_llms):
    msgs = [{"role": "user", "content": "hi"}]
    fake_llms["responses"] += ["first", "second"]
    assert tllm.get_llm_manager().chat(tllm.LLMModule.AGENT_DECISION, msgs) == "first"
    assert jllm.chat(jllm.LLMModule.AGENT_DECISION, msgs) == "second"
    assert tllm.get_llm_manager().is_enabled("anything") and jllm.is_llm_enabled("anything")
    assert tllm.get_llm_manager().chat_or_none("x", msgs) == '{"ok": true}'
    mgr = tllm.get_llm_manager()
    assert tllm.get_llm_manager() is mgr
    assert tllm.get_llm_manager({"llm": {}}) is not mgr
    tllm.reset_llm_manager()
    assert not tllm.get_llm_manager().is_enabled("answer_generation")


class _FlakyClient:
    """An OpenAI-shaped client whose first ``fails`` calls raise ``error``."""

    def __init__(self, fails, error):
        self.fails, self.error, self.calls = fails, error, 0
        self.chat = self
        self.completions = self

    def create(self, **kw):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.error

        class _R:
            choices = [type("C", (), {"message": type("M", (), {"content": "pong"})})]
        return _R


@pytest.mark.parametrize("fails,error", [
    (0, None), (2, ConnectionError("reset by peer")),
    (2, RuntimeError("429 Too Many Requests")), (9, TimeoutError("timed out")),
], ids=["first", "retried", "rate-limited", "gives-up"])
def test_llm_network_retry_matches_jax(fails, error, monkeypatch):
    overlay = {"llm": {"enabled": True, "modules": {"answer_generation": {
        "enabled": True, "max_retries": 3, "retry_wait": 0.25, "rate_limit_wait": 1.5}}}}
    waits = []
    monkeypatch.setattr(tllm.time, "sleep", waits.append)    # one module for both
    msgs = [{"role": "user", "content": "ping"}]
    out = {}
    for name, mgr in zip(("jax", "port"), _managers(overlay)):
        client = _FlakyClient(fails, error)
        mgr._clients["deepseek-chat"] = client
        waits.clear()
        if fails > 3:
            with pytest.raises(type(error)):
                mgr.chat("answer_generation", msgs)
            out[name] = (client.calls, None, list(waits))
        else:
            text = mgr.chat("answer_generation", msgs)
            out[name] = (client.calls, text, list(waits))
    assert out["port"] == out["jax"]
    assert out["port"][0] == min(fails, 3) + 1
    _, tm = _managers(overlay)
    tm._clients["deepseek-chat"] = _FlakyClient(fails, error)
    assert tm.chat_or_none("answer_generation", msgs) == (None if fails > 3 else "pong")


def test_audit_passes_on_the_port_copies(monkeypatch):
    """The eval-marker audit of ``tools/audit_synth_disjoint.py`` over the
    port's ``qa.py`` and ``extractive.py`` instead of the JAX package's."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import audit_synth_disjoint as audit
    monkeypatch.setattr(audit, "ANSWER_SOURCES",
                        ["ahrag_tpu_torch/answer/qa.py",
                         "ahrag_tpu_torch/answer/extractive.py"])
    report = audit.run_audit(ROOT)
    assert report["ok"], report["violations"]
    assert report["answer_sources"] == audit.ANSWER_SOURCES
    assert report["source_literal_tokens"] > 0
