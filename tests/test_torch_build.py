"""The port's build pipeline against the JAX package's, on the CPU: the
schema, chunking, extraction, spherical k-means, community detection, the
aggregator, ``run_pipeline`` and the question fleet.

Both packages build from the same text, each with its own encoder: the port
draws the JAX package's Gaussian projection without JAX
(``utils/jax_random.py``, held against ``jax.random`` here). Token counts
decide the chunks, so the JAX package counts with its own native estimator
(``tests/test_torch_answer.py``).

Tolerances: everything that is not a float is held equal (strings, ids,
cluster assignments, members, edges, ints, key order). Floats are held within
1e-6: the port accumulates the entity embeddings and k-means in float64 (so
that the card and the CPU agree to the bit) where the JAX package sums in
float32, which differs in the last place, and its Gaussian lies within 6e-6
of JAX's relatively.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ahrag_tpu import schema as jschema
from ahrag_tpu.agent.fleet import build_question_fleet as j_fleet
from ahrag_tpu.aggregate.community import greedy_modularity_communities as j_comm
from ahrag_tpu.cli.demo import run_pipeline as j_pipeline
from ahrag_tpu.extract.chunking import smart_chunks as j_chunks
from ahrag_tpu.extract.extractor import HypergraphExtractor as JX
from ahrag_tpu.models.encoder import create_encoder as j_encoder
from ahrag_tpu.ops.kmeans import spherical_kmeans as j_kmeans
from ahrag_tpu.utils.config import load_config as j_config
from ahrag_tpu_torch import schema as tschema
from ahrag_tpu_torch.agent.fleet import build_question_fleet as t_fleet
from ahrag_tpu_torch.aggregate.community import greedy_modularity_communities as t_comm
from ahrag_tpu_torch.cli import demo as tdemo
from ahrag_tpu_torch.extract.chunking import smart_chunks as t_chunks
from ahrag_tpu_torch.extract.extractor import HypergraphExtractor as TX
from ahrag_tpu_torch.models.encoder import create_encoder as t_encoder
from ahrag_tpu_torch.ops.kmeans import spherical_kmeans as t_kmeans
from ahrag_tpu_torch.utils import jax_random
from ahrag_tpu_torch.utils.config import load_config as t_config
from chip_smoke import SAMPLES
from tests.test_torch_answer import (_fresh_port_llm, _jax_counts_tokens_natively,  # noqa: F401
                                     fake_llms)

TOL = 1e-6
MINI_FILMS = str(SAMPLES / "mini_films.txt")
XL_CORPUS = SAMPLES / "synth_v4_sharedxl_corpus_dev.txt"


def xl_text(n: int) -> str:
    """The first ``n`` titled paragraphs of the XL dev world, as the corpus
    file has them."""
    blocks = XL_CORPUS.read_text(encoding="utf-8").split("=== ")[1:n + 1]
    return "".join("=== " + b for b in blocks)


def assert_close(a, b, path="$", tol=TOL):
    """``a`` equals ``b`` in structure, key order, types and every value,
    floats within ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}", tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]", tol)
    elif isinstance(a, float):
        assert isinstance(b, float), (path, a, b)
        assert (math.isnan(a) and math.isnan(b)) or a == b or abs(a - b) <= tol, (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


# ------------------------------------------------------------------ schema
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-10 ** 20, 10 ** 20),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(alphabet="0123456789._+-eEinfatyINFx \t\n　\x1c", max_size=9),
    st.text(max_size=6), st.binary(max_size=4),
    st.lists(st.integers(0, 3), max_size=2), st.dictionaries(st.text(max_size=2),
                                                            st.integers(), max_size=1))


def _record(fields, nested=None):
    """A dict over ``fields`` (each present or missing) plus maybe an extra
    key; ``nested`` maps a field to the strategy of its value."""
    def build(draw):
        out = {}
        for f in fields:
            if draw(st.integers(0, 5)) == 0:
                continue
            out[f] = draw(nested[f] if nested and f in nested else _SCALARS)
        if draw(st.booleans()):
            out["extra"] = draw(_SCALARS)
        return out
    return st.composite(lambda draw: build(draw))()


_ENTITY = _record(("name", "type", "description"))
_EXTRACTION = _record(("hyperedge", "relation_type", "entities", "confidence_score"),
                      {"entities": st.one_of(st.lists(_ENTITY, max_size=3),
                                             st.tuples(_ENTITY), _SCALARS)})
_CASES = {
    "Entity": _ENTITY,
    "HypergraphExtraction": _EXTRACTION,
    "ExtractionResponse": _record(("extractions",), {"extractions": st.one_of(
        st.lists(_EXTRACTION, max_size=3), _SCALARS)}),
    "TopicSummary": _record(("topic_id", "title", "summary", "confidence")),
    "JudgeScore": _record(("id", "consistency", "accuracy", "informativeness", "overall",
                           "comments")),
    "AnswerObject": _record(("answer", "rationale", "citations"),
                            {"citations": st.one_of(st.lists(_SCALARS, max_size=3),
                                                    _SCALARS)}),
}


def _pydantic(model, obj):
    try:
        return model.model_validate(obj).model_dump()
    except Exception:       # pydantic's ValidationError: the refusal
        return None


@pytest.mark.parametrize("name", sorted(_CASES))
def test_schema_validates_as_pydantic(name):
    """Accept or refuse as pydantic does, and dump the same dict (types
    included), over generated dicts: wrong types, numeric strings, missing and
    extra fields, nested lists."""
    @settings(max_examples=400, deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(_CASES[name])
    def check(obj):
        want = _pydantic(getattr(jschema, name), obj)
        got = getattr(tschema, name).model_validate(obj)
        got = None if got is None else got.model_dump()
        assert json.dumps(got) == json.dumps(want), (obj, got, want)
    check()


@pytest.mark.parametrize("value", [8, 8.0, "8", " 8 ", "8.5", "1e3", "inf", "nan", "1_0",
                                   "1_0.0", " 1_0 ", "0x10", "", "１２", True, None, "8.0",
                                   "-0", 2 ** 70, 1.5, 1e19, b"8"])
def test_schema_numbers_as_pydantic(value):
    for name, obj in (("TopicSummary", {"topic_id": value, "title": "t", "summary": "s",
                                        "confidence": value}),
                      ("TopicSummary", {"topic_id": 1, "title": "t", "summary": "s",
                                        "confidence": value}),
                      ("JudgeScore", {"id": value, "consistency": 1, "accuracy": value,
                                      "informativeness": 2, "overall": 3})):
        want = _pydantic(getattr(jschema, name), obj)
        got = getattr(tschema, name).model_validate(obj)
        assert json.dumps(None if got is None else got.model_dump()) == json.dumps(want), obj


def test_schema_constructs_and_keeps_its_constants():
    e = tschema.Entity(name="Ed Wood", type="work")
    assert e.model_dump() == jschema.Entity(name="Ed Wood", type="work").model_dump()
    h = tschema.HypergraphExtraction(hyperedge="h", relation_type="R", entities=[e],
                                     confidence_score=5.0)
    assert h.model_dump() == jschema.HypergraphExtraction(
        hyperedge="h", relation_type="R", entities=[jschema.Entity(name="Ed Wood", type="work")],
        confidence_score=5.0).model_dump()
    assert tschema.CANONICAL_ENTITY_TYPES == jschema.CANONICAL_ENTITY_TYPES


# -------------------------------------------------------- chunks, extraction
TEXTS = {"mini_films": (SAMPLES / "mini_films.txt").read_text(encoding="utf-8"),
         "realtext": (SAMPLES / "realtext_corpus.txt").read_text(encoding="utf-8"),
         "xl20": xl_text(20)}
BUDGETS = [{}, {"model_ctx": 700, "max_output": 100, "buffer": 100},
           {"model_ctx": 60, "max_output": 20, "buffer": 10}]


@pytest.mark.parametrize("budget", BUDGETS, ids=["default", "500", "30"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_chunks_and_fallback_extraction_match_jax(name, budget):
    chunks = t_chunks(TEXTS[name], **budget)
    assert chunks == j_chunks(TEXTS[name], **budget)
    if budget.get("model_ctx") == 60:
        assert len(chunks) > 20
    jx, tx = JX(), TX()
    for chunk in chunks:
        assert ([e.model_dump() for e in tx.extract(chunk)]
                == [e.model_dump() for e in jx.extract(chunk)])


_ENT = '{"name": "Tim Burton", "type": "director", "description": "American filmmaker"}'
_EX = ('{"hyperedge": "Tim Burton directed Ed Wood", "relation_type": "Directed", '
       '"entities": [' + _ENT + ', {"name": "Ed Wood", "type": "film"}], '
       '"confidence_score": %s}')
RAW_OUTPUTS = [
    '{"extractions": [' + _EX % 9 + "]}",
    "Sure! Here it is:\n```json\n{\"extractions\": [" + _EX % '"8"' + "]}\n```\nDone.",
    '{"extractions": [' + _EX % '"高"' + ", " + _EX % '"低"' + "]}",
    '{"extractions": [' + _EX % '"中"' + ", " + _EX % '"very sure"' + "]}",
    '{"extractions": [' + _EX % 42 + ", " + _EX % -3 + "]}",
    '{"extractions": [' + _EX % 7 + ", " + (_EX % 5)[:60],                  # truncated
    'prefix {"extractions": [' + _EX % 7 + "], trailing garbage",
    '"extractions": [' + _EX % 6 + ", " + _EX % 6 + "]",
    _EX % 7 + " and then " + _EX % 3,                                      # bare objects
    '{"extractions": [{"hyperedge": "h", "relation_type": "R", "entities": '
    '[{"name": 5, "type": "person"}], "confidence_score": 5}]}',           # refused name
    '{"extractions": [{"hyperedge": "h", "entities": [], "confidence_score": 5}]}',
    '{"extractions": [{"hyperedge": "Ed Wood premiered", "relation_type": "Premiere", '
    '"entities": [{"name": "Ed Wood", "type": "WORK"}, {"name": "1994", "type": "year"}]},'
    ' {"hyperedge": "x", "relation_type": "Y", "entities": [{"name": "Burbank", '
    '"type": "place", "description": "a city"}], "confidence_score": null}]}',
    "{" + ", ".join([_EX % i for i in range(1, 11)]) + "}",               # 10 objects
    '{"hyperedge": "a", "relation_type": "B", "entities": [' + _ENT + '], '
    '"confidence_score": 4} , {"hyperedge": "c", "relation_type": "D", "entities": [' + _ENT,
    "no json at all", "{}", "{not json}", "",
    '{"extractions": "none"}',
    '{"extractions": [' + _EX % 7 + ", 17]}",
]
SOURCE = ("=== Tim Burton ===\nTim Burton is an American filmmaker. He directed Ed Wood "
          "in 1994. The film was shot in Burbank.")


@pytest.mark.parametrize("raw", RAW_OUTPUTS, ids=range(len(RAW_OUTPUTS)))
def test_parse_response_matches_jax(raw):
    t_out = TX().parse_response(raw, SOURCE)
    j_out = JX().parse_response(raw, SOURCE)
    assert [e.model_dump() for e in t_out] == [e.model_dump() for e in j_out]


def test_extract_with_model_replies_matches_jax(fake_llms):
    """``extract`` through each package's manager: parsed replies, and the
    fallback where a reply does not parse."""
    for raw in RAW_OUTPUTS[:8] + ["no json at all", ""]:
        fake_llms["responses"] = [raw, raw]
        t_out = TX().extract(SOURCE)
        j_out = JX().extract(SOURCE)
        assert [e.model_dump() for e in t_out] == [e.model_dump() for e in j_out]


# --------------------------------------------------------------------- kmeans
_SPECIAL_NS = {1, 2, 3, 5, 7, 64, 255, 256, 1000, 1023, 1024, 4095, 65535, 65536, 65537,
               131071, 999_999, 1_048_575, 1 << 20}
_SPREAD = [int(x) for x in np.unique(np.geomspace(1, 1 << 20, 120).round().astype(np.int64))
           if x not in _SPECIAL_NS]
# the special spans (powers of two and their neighbours, where the uint32
# products wrap) and 31 more spread evenly in log n: 50 values of n
_NS = sorted(_SPECIAL_NS | {_SPREAD[i] for i in np.linspace(
    0, len(_SPREAD) - 1, 50 - len(_SPECIAL_NS)).round().astype(int)})


def test_kmeans_start_matches_jax_randint():
    assert len(_NS) == 50 and _NS[0] == 1 and _NS[-1] == 1 << 20
    seeds, ns = np.meshgrid(np.arange(64), np.array(_NS), indexing="ij")
    want = jax.jit(jax.vmap(lambda s, n: jax.random.randint(
        jax.random.PRNGKey(s), (), 0, n)))(jnp.asarray(seeds.ravel()), jnp.asarray(ns.ravel()))
    got = [jax_random.randint(int(s), int(n)) for s, n in zip(seeds.ravel(), ns.ravel())]
    assert got == np.asarray(want).tolist()


@pytest.mark.parametrize("seed,shape", [(7, (16384, 384)), (0, (3, 5)), (123, (1000,)),
                                        (2 ** 31 - 1, (64, 8))])
def test_jax_normal_matches_jax_random(seed, shape):
    """The draws to the bit; the Gaussian (float64 ``erfinv`` against XLA's
    float32 polynomial) within 6e-6 relatively, and the hashed encoder's
    projection with it."""
    key = jax.random.PRNGKey(seed)
    n = int(np.prod(shape))
    np.testing.assert_array_equal(jax_random._bits(jax_random._key(seed), n),
                                  np.asarray(jax.random.bits(key, (n,))))
    want = np.asarray(jax.random.normal(key, shape))
    got = jax_random.normal(seed, shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=6e-6, atol=0)
    if shape == (16384, 384):
        assert (got == want).mean() > 0.4
        np.testing.assert_allclose(t_encoder(t_config(), device="cpu")._proj.numpy(),
                                   np.asarray(j_encoder(j_config())._proj), rtol=6e-6, atol=0)


def _clusters(n, k, d, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, d)).astype(np.float32)
    return (c[rng.integers(0, k, n)] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)


def _ties(n, d, distinct):
    """Rows from ``distinct`` basis vectors (cosines exactly 0 or 1): every
    argmin and argmax meets exact ties."""
    x = np.zeros((n, d), np.float32)
    x[np.arange(n), np.arange(n) % distinct] = 1.0
    return x


KMEANS_CASES = [("clusters", 64, 1, 16), ("clusters", 64, 8, 16), ("clusters", 257, 5, 32),
                ("clusters", 1000, 16, 64), ("clusters", 4096, 64, 64),
                ("clusters", 2048, 32, 384), ("ties", 64, 4, 8), ("ties", 128, 8, 8),
                ("ties", 96, 12, 16), ("duplicates", 200, 6, 16)]


@pytest.mark.parametrize("kind,n,k,d", KMEANS_CASES)
def test_kmeans_matches_jax(kind, n, k, d):
    if kind == "clusters":
        x = _clusters(n, k, d, seed=n + k)
    elif kind == "ties":
        x = _ties(n, d, distinct=k // 2 if k > 4 else k)   # more clusters than points
    else:
        x = np.repeat(_clusters(n // 4, k, d, seed=1), 4, axis=0)
    for seed in (0, 42):
        ja, jc = j_kmeans(x, k=k, seed=seed)
        ta, tc = t_kmeans(torch.from_numpy(x), k=k, seed=seed)
        assert ta.dtype == torch.int32 and tc.dtype == torch.float32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)


def test_kmeans_numpy_input_needs_a_device():
    x = _clusters(64, 4, 8, seed=3)
    assign, _ = t_kmeans(x, k=4, device="cpu")
    np.testing.assert_array_equal(assign.numpy(), np.asarray(j_kmeans(x, k=4)[0]))


@pytest.mark.parametrize("edges", [
    [], [("a", "b", 1.0)],
    [(0, 1, 0.5), (1, 2, 0.4), (2, 0, 0.3), (3, 4, 0.9), (4, 5, 0.2), (5, 3, 0.7), (2, 3, 0.05)],
    [(i, (i * 7 + 3) % 12, 0.1 + (i % 5) / 10) for i in range(12)] + [(0, 0, 1.0)],
])
def test_communities_match_jax(edges):
    nodes = sorted({u for u, _, _ in edges} | {v for _, v, _ in edges}) or [1, 2]
    assert t_comm(nodes, edges) == j_comm(nodes, edges)


# ------------------------------------------------------------------ pipeline
def _read(d):
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".json"):
            out[name] = json.loads(open(path, encoding="utf-8").read())
        elif name.endswith(".npy"):
            out[name] = np.load(path)
        else:
            z = np.load(path)
            out[name] = {k: z[k] for k in z.files}
    return out


def assert_same_build(j_dir, t_dir):
    """Artifacts and saved graphs of the two packages: the same files, JSON
    equal (floats within ``TOL``), arrays of the same shape and type within
    ``TOL``, ids and int tables equal."""
    for sub in ("artifacts", "graph"):
        j, t = _read(os.path.join(j_dir, sub)), _read(os.path.join(t_dir, sub))
        assert list(j) == list(t), sub
        for name in j:
            a, b = j[name], t[name]
            if isinstance(a, np.ndarray):
                a, b = {"": a}, {"": b}
            if name.endswith(".npz") or name.endswith(".npy"):
                assert list(a) == list(b)
                for k in a:
                    assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (name, k)
                    if a[k].dtype.kind == "f":
                        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TOL)
                    else:
                        np.testing.assert_array_equal(b[k], a[k])
            else:
                assert_close(a, b, f"{sub}/{name}")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """mini_films and the first 200 XL paragraphs through both pipelines."""
    root = tmp_path_factory.mktemp("builds")
    out = {}
    for name, text in (("mini_films", None), ("xl200", xl_text(200))):
        src = MINI_FILMS
        if text is not None:
            src = str(root / f"{name}.txt")
            open(src, "w", encoding="utf-8").write(text)
        dirs = (str(root / name / "jax"), str(root / name / "port"))
        j_hg = j_pipeline(src, artifacts_dir=os.path.join(dirs[0], "artifacts"),
                          graph_dir=os.path.join(dirs[0], "graph"))
        timings = {}
        t_hg = tdemo.run_pipeline(src, artifacts_dir=os.path.join(dirs[1], "artifacts"),
                                  graph_dir=os.path.join(dirs[1], "graph"), device="cpu",
                                  timings=timings)
        out[name] = (j_hg, t_hg, dirs, timings)
    return out


@pytest.mark.parametrize("name", ["mini_films", "xl200"])
def test_pipeline_builds_the_jax_artifacts_and_graph(builds, name):
    j_hg, t_hg, (j_dir, t_dir), timings = builds[name]
    assert_same_build(j_dir, t_dir)
    assert t_hg.stats() == j_hg.stats()
    assert list(t_hg.nodes) == list(j_hg.nodes)
    assert set(timings) == {"extract_s", "aggregate_s", "kmeans_s", "graph_s", "index_s",
                            "save_s"}
    assert 0 < timings["kmeans_s"] < timings["aggregate_s"]


def test_xl200_pipeline_clusters_at_scale(builds):
    """The 200-paragraph build takes the adaptive path: k-means, merges and the
    outlier cut all act, and the L1 graph has relations."""
    _, t_hg, (_, t_dir), _ = builds["xl200"]
    topics = json.load(open(os.path.join(t_dir, "artifacts", "topics.json")))
    assert len(topics["l1_nodes"]) >= 4
    assert json.load(open(os.path.join(t_dir, "artifacts", "l1_edges.json")))
    assert t_hg.tensors().n_pad >= t_hg.number_of_nodes()


def test_pipeline_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """``cli.demo`` with the REPL on standard input: two queries, then the
    end of the input."""
    import io
    import sys

    from ahrag_tpu.cli import demo as jdemo
    outs = []
    for mod, extra in ((jdemo, []), (tdemo, ["--device", "cpu"])):
        sub = tmp_path / mod.__name__.split(".")[0]
        argv = [MINI_FILMS, "--artifacts", str(sub / "a"), "--graph", str(sub / "g")]
        monkeypatch.setattr(sys, "stdin", io.StringIO("Who directed Ed Wood?\nTim Burton\n"))
        if mod is jdemo:
            monkeypatch.setattr(sys, "argv", ["demo", *argv])
            mod.main()
        else:
            mod.main(argv + extra)
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert outs[1].count("query> ") == 3


def test_pipeline_and_aggregator_refuse_without_a_card_before_writing(tmp_path):
    """No card and no ``device``: nothing is read or written."""
    if torch.cuda.is_available():
        pytest.skip("this check runs without a card")
    from ahrag_tpu_torch.aggregate import SemanticAggregator
    with pytest.raises(RuntimeError, match="CUDA"):
        tdemo.run_pipeline(MINI_FILMS, str(tmp_path / "a"), str(tmp_path / "g"))
    with pytest.raises(RuntimeError, match="CUDA"):
        SemanticAggregator(artifact_dir=str(tmp_path / "a"))
    assert os.listdir(tmp_path) == []


LLM_REPLIES = [
    '{"topic_id": 3, "title": "Films and directors", "summary": "About films.", '
    '"confidence": "8"}',
    '{"title": 5, "summary": "refused: a number for a title", "confidence": 7}',
    "no json here",
    'Sure: {"title": "Directors", "summary": "People.", "confidence": 6.5} done',
    '{"title": "Community", "summary": "s", "confidence": 1e999}',
    '{"title": "Community", "summary": "s", "confidence": ' + "9" * 400 + "}",
    '{"title": "Community", "summary": "s", "confidence": "high"}',
    '{"id": Infinity, "consistency": 7, "accuracy": "8", "informativeness": 6, '
    '"overall": 7.5}',
    '{"id": "3", "consistency": 7, "accuracy": 8, "informativeness": 6, "overall": "9"}',
    '{"id": 2.7, "consistency": 7, "accuracy": 8, "informativeness": 6, "overall": 5}',
    '{"id": 1, "consistency": "x", "accuracy": 8, "informativeness": 6, "overall": 5}',
]


@pytest.mark.parametrize("shift", range(4))
def test_aggregator_with_model_replies_matches_jax(tmp_path, fake_llms,
                                                   shift):
    """Every stage of the aggregator that asks the model (topic and community
    summaries, the judges, escalation) over mini_films' extractions, with
    replies that parse, are refused or overflow, in four rotations."""
    from ahrag_tpu.aggregate import SemanticAggregator as JAgg
    from ahrag_tpu_torch.aggregate import SemanticAggregator as TAgg
    chunks = j_chunks(TEXTS["mini_films"])
    outs = []
    for agg_cls, x_cls, kw, sub in ((JAgg, JX, {}, "jax"), (TAgg, TX, {"device": "cpu"}, "port")):
        fake_llms["responses"] = (LLM_REPLIES[shift:] + LLM_REPLIES[:shift]) * 4
        fake_llms["default"] = LLM_REPLIES[(shift + 7) % len(LLM_REPLIES)]
        exs = [e for c in chunks for e in x_cls().extract(c)]
        agg = agg_cls(artifact_dir=str(tmp_path / sub), **kw)
        agg.embed_l0_entities(exs)
        clust = agg.cluster_entities(n_topics=4)
        summaries = agg.summarize_topics(clust["l1_nodes"])
        edges = agg.generate_l1_relations(clust["l1_nodes"], min_overlap=1,
                                          min_jaccard=0.05, min_cosine=0.0)
        l2 = agg.aggregate_level2_via_communities(clust["l1_nodes"], min_comm_size=1,
                                                  edge_weight_min=0.0)
        judged = agg.judge_samples(clust["l1_nodes"], edges)
        levels = agg.escalate(clust["l1_nodes"], max_levels=3, min_comm_size=1)
        metrics = agg.compute_escalation_metrics(clust["l1_nodes"], l2)
        outs.append((json.loads(json.dumps([s.model_dump() for s in summaries])), l2,
                     {k: [s.model_dump() for s in v] for k, v in judged.items()}, levels,
                     metrics, _read(str(tmp_path / sub))))
    assert fake_llms["n"] > 10
    for a, b in zip(outs[0][:5], outs[1][:5]):
        assert_close(a, b)
    assert list(outs[0][5]) == list(outs[1][5])
    for name, a in outs[0][5].items():
        if name.endswith(".json"):
            assert_close(a, outs[1][5][name], name)


# --------------------------------------------------------------------- fleet
def test_question_fleet_matches_jax(tmp_path):
    items = [json.loads(ln) for ln in (SAMPLES / "synth_v4_dev.jsonl").read_text()
             .splitlines()[:4]]
    jb, jq, jg, jm = j_fleet(items, workdir=str(tmp_path), log=lambda *_: None)
    tb, tq, tg, tm = t_fleet(items, workdir=str(tmp_path), log=lambda *_: None,
                             device="cpu")
    assert tm == jm and tb.n_nodes == tuple(jb.n_nodes)
    for name in ("emb", "node_type", "level", "judge", "has_judge", "conf", "has_conf",
                 "indexed", "valid", "parents", "children", "related", "hyperedges",
                 "members"):
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tg, jg)
    assert tg.any(axis=1).all()
    assert os.listdir(tmp_path) == []
