"""The port's HierarchicalGraph against the JAX package's.

Both packages build the same graph by the same calls (``tests.helpers.
build_film_graph`` with the class swapped), or one loads what the other
saved. Tolerances: ids, stats, hashes and flags exactly; embeddings 1e-5
(float32 projection and scatter order); search scores 1e-4 (the result
entries round to four decimals).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.helpers as helpers
from chip_smoke import corpus_graph, sample_questions
from ahrag_tpu.graph import HierarchicalGraph as JHG
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu_torch import convert
from ahrag_tpu_torch.graph import HierarchicalGraph as THG
from ahrag_tpu_torch.graph import tensors as ttensors

QUERIES = ["Who directed Ed Wood?", "American film directors", "Doctor Strange",
           "Tim Burton", "Kathryn Bigelow", "superhero film 2016"]


def port_film_graph() -> THG:
    """``build_film_graph`` through the port's class, on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(helpers, "HierarchicalGraph",
                   lambda encoder_name=None: THG(encoder_name, device="cpu"))
        return helpers.build_film_graph()


def ids(results):
    return [r["node_id"] for r in results]


def assert_same_results(a, b):
    assert ids(a) == ids(b)
    for x, y in zip(a, b):
        assert abs(x["score"] - y["score"]) <= 1e-4
        assert abs(x["semantic"] - y["semantic"]) <= 1e-4
        assert {k: v for k, v in x.items() if k not in ("score", "semantic")} == \
            {k: v for k, v in y.items() if k not in ("score", "semantic")}


@pytest.fixture(scope="module")
def film_pair():
    jh, th = helpers.build_film_graph(), port_film_graph()
    jh.build_vector_index(layers=(0, 1, 2))
    th.build_vector_index(layers=(0, 1, 2))
    return jh, th


@pytest.fixture(scope="module")
def jax_film_dir(tmp_path_factory, film_pair):
    d = tmp_path_factory.mktemp("jax_film")
    film_pair[0].save(str(d), meta={"source": "jax"})
    return str(d)


def test_stats_validators_queries_and_hash_match_jax(film_pair):
    jh, th = film_pair
    assert th.stats() == jh.stats()
    assert th.validate_belongs_to_dag() == jh.validate_belongs_to_dag() is True
    assert th.validate_required_attributes() == jh.validate_required_attributes()
    assert th._graph_snapshot_hash() == jh._graph_snapshot_hash()
    assert list(th.nodes) == list(jh.nodes) and th.nodes == jh.nodes
    for nid in jh.nodes:
        for q in ("get_belongs_to", "get_summary_members", "get_parents", "get_children",
                  "get_hyperedge_participants", "get_entity_hyperedges", "get_related",
                  "get_siblings", "node_judge_overall", "node_confidence", "node_layer"):
            assert getattr(th, q)(nid) == getattr(jh, q)(nid), (q, nid)
    for name in ("Tim Burton", "Ed Wood", "nobody"):
        assert th.find_entity(name) == jh.find_entity(name)
    assert [th.find_summary(t) for t in range(4)] == [jh.find_summary(t) for t in range(4)]
    for q in ("film", "american", "burton", "zzz"):
        assert th.search_by_name_or_title(q) == jh.search_by_name_or_title(q)
        assert th.search_by_name_or_title(q, limit=1) == jh.search_by_name_or_title(q, limit=1)
        assert th.summaries_with_top_word(q) == jh.summaries_with_top_word(q)
    assert (th.number_of_nodes(), th.number_of_edges()) == \
        (jh.number_of_nodes(), jh.number_of_edges())
    assert list(th._iter_edges_in_order()) == list(jh._iter_edges_in_order())


def test_mutation_semantics_match_jax():
    """Entity merge on re-add, duplicate edges, a belongs_to cycle and the
    hash moving with content, in both packages."""
    out = []
    for hg in (JHG(encoder_name="hashed"), THG(encoder_name="hashed", device="cpu")):
        nid = hg.add_entity("X", description=None, entity_type=None)
        hg.add_entity("X", description="first", entity_type="person")
        hg.add_entity("X", description="second", l1_parents={"0": 0.5})
        a = hg.add_summary(0, "A", "a", judge_scores=json.dumps({"overall": "7.5"}))
        b = hg.add_summary(1, "B", "b", confidence="not a number")
        hg.add_belongs_to(nid, a, prob=0.3)
        hg.add_belongs_to(nid, a, prob=0.6)     # duplicate: attrs update, no new edge
        hg.add_belongs_to(a, b)
        dag = hg.validate_belongs_to_dag()
        h1 = hg._graph_snapshot_hash()
        hg.add_belongs_to(b, a)
        out.append((dict(hg.nodes), hg.stats(), dag, hg.validate_belongs_to_dag(), h1,
                    hg._graph_snapshot_hash(), hg.node_judge_overall(a),
                    hg.node_confidence(b), dict(hg._edge_attrs)))
    assert out[0] == out[1]
    assert out[0][2] is True and out[0][3] is False and out[0][6] == 7.5


def test_build_vector_index_matches_jax(film_pair):
    jh, th = film_pair
    assert set(th._embeddings) == set(jh._embeddings)
    for nid in jh._embeddings:
        np.testing.assert_allclose(th._embeddings[nid], jh._embeddings[nid], rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(th._idf, jh._idf)
    np.testing.assert_array_equal(th._lsa, jh._lsa)
    assert (th._assoc is None) == (jh._assoc is None)
    if jh._assoc is not None:
        for a, b in zip(th._assoc, jh._assoc):
            np.testing.assert_array_equal(a, b)
    assert (th.query_assoc() is None) == (jh.query_assoc() is None)
    assert th.vector_index == jh.vector_index
    np.testing.assert_allclose(th.encode_query(QUERIES), jh.encode_query(QUERIES),
                               rtol=0, atol=1e-5)


def test_incremental_indexing_matches_jax():
    counts = []
    for hg in (helpers.build_film_graph(), port_film_graph()):
        first = hg.build_vector_index(layers=(0, 1, 2))
        again = hg.build_vector_index(layers=(0, 1, 2))
        hg.nodes[hg.find_entity("Tim Burton")]["description"] = "changed description"
        changed = hg.build_vector_index(layers=(0, 1, 2))
        counts.append((first, again, changed, hg.vector_index["indexed_nodes"]))
    assert counts[0] == counts[1] == (8, 0, 1, 8)


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("return_cluster", [False, True])
def test_jax_saved_graph_searches_alike_in_the_port(film_pair, jax_film_dir, query,
                                                    return_cluster):
    jh = film_pair[0]
    th = THG.load(jax_film_dir, device="cpu")
    assert not th.dirty and th.stats() == jh.stats()
    a = jh.search(query, top_k=5, return_cluster=return_cluster)
    b = th.search(query, top_k=5, return_cluster=return_cluster)
    if not return_cluster:
        assert_same_results(b, a)
        return
    assert_same_results(b["reranked"], a["reranked"])
    for key in ("seeds", "expanded"):
        assert ids(b[key]) == ids(a[key])
        for x, y in zip(b[key], a[key]):
            assert abs(x["semantic"] - y["semantic"]) <= 1e-4


@pytest.mark.parametrize("kw", [dict(type_filter=["summary"]), dict(judge_overall_min=5.0),
                                dict(confidence_min=6.8), dict(top_k=3, member_top_m=1),
                                dict(alpha=1.0, beta=0.0, gamma=0.0, delta=0.0)],
                         ids=["type_filter", "judge_min", "conf_min", "top3_m1", "alpha_only"])
def test_search_parameters_match_jax(film_pair, kw):
    jh, th = film_pair
    for q in QUERIES:
        assert_same_results(th.search(q, **kw), jh.search(q, **kw))


def test_port_saved_graph_loads_in_jax(film_pair, tmp_path):
    th = film_pair[1]
    th.search_params["type_filter"] = ["summary", "entity"]
    th.save(str(tmp_path), meta={"source": "port"})
    th.search_params["type_filter"] = None
    jh = JHG.load(str(tmp_path))
    t2 = THG.load(str(tmp_path), device="cpu")
    assert jh.stats() == th.stats() and jh.search_params["type_filter"] == ["summary", "entity"]
    assert json.loads((tmp_path / "meta.json").read_text())["source"] == "port"
    for q in QUERIES:
        assert_same_results(t2.search(q), jh.search(q))
        assert_same_results(th.search(q, type_filter=["summary", "entity"]), jh.search(q))


def test_build_from_artifacts_matches_jax(tmp_path):
    """Artifacts with L1 topics, a colliding L2 community id, an L3 level,
    judge scores and an unparsable level map key, in both packages."""
    art = tmp_path / "artifacts"
    art.mkdir()
    files = {
        "extractions.json": [
            {"hyperedge": "Tim Burton directed Ed Wood", "relation_type": "Directed",
             "confidence_score": 9.0, "id": "h1",
             "entities": [{"name": "Tim Burton", "type": "person",
                           "description": "American director", "role": "director"},
                          {"name": "Ed Wood", "type": "work", "description": "1994 film"}]},
            {"hyperedge": "Scott Derrickson directed Doctor Strange",
             "relation_type": "Directed",
             "entities": [{"name": "Scott Derrickson", "type": "person",
                           "description": "American director"},
                          {"name": "Doctor Strange", "type": "work",
                           "description": "2016 superhero film"},
                          {"name": "Tim Burton", "description": "filmmaker"}]}],
        "topics.json": {"entity_to_parents": {
            "Tim Burton": [{"topic_id": 0, "prob": 0.9}],
            "Ed Wood": [{"topic_id": 1, "prob": 0.8}],
            "Scott Derrickson": [{"topic_id": 0, "prob": 0.7}],
            "Doctor Strange": [{"topic_id": 1, "prob": 0.6}]}},
        "l1_nodes.json": [
            {"topic_id": 0, "title": "Directors", "summary": "American directors",
             "confidence": 7.0, "top_words": ["director"], "members": ["Tim Burton"]},
            {"topic_id": 1, "title": "Films", "summary_text": "American films",
             "confidence": 6.0, "top_words": ["film"], "members": ["Ed Wood"]}],
        "l1_edges.json": [{"source": 0, "target": 1, "weight": 0.5, "jaccard": 0.2,
                           "cosine": 0.6, "overlap": 1, "confidence": 5.0}],
        "l1_judge_nodes.json": [{"id": 0, "overall": 7.5}, {"id": 1, "overall": "n/a"}],
        "l1_judge_edges.json": [{"source": 0, "target": 1, "score": 3}],
        "l2_nodes.json": [{"topic_id": 0, "title": "Cinema", "summary": "American cinema",
                           "confidence": 8.0, "top_words": ["cinema"]}],
        "l1_to_l2.json": {"0": 0, "1": 0, "x": 0},
        "l3_nodes.json": [{"topic_id": 10, "title": "Arts", "summary": "The arts"}],
        "l2_to_l3.json": {"2": 10, "bad": "also bad"},
    }
    for name, obj in files.items():
        (art / name).write_text(json.dumps(obj))
    jh = JHG(encoder_name="hashed")
    th = THG(encoder_name="hashed", device="cpu")
    jh.build_from_artifacts(str(art))
    th.build_from_artifacts(str(art))
    assert th.nodes == jh.nodes and list(th.nodes) == list(jh.nodes)
    assert th.stats() == jh.stats() and th.judge_edges == jh.judge_edges
    assert list(th._iter_edges_in_order()) == list(jh._iter_edges_in_order())
    assert th._edge_attrs == jh._edge_attrs
    assert th._graph_snapshot_hash() == jh._graph_snapshot_hash()
    assert th.find_summary(2) == "sum:2" and th.node_layer("sum:10") == 3
    jh.build_vector_index(layers=(0, 1, 2))
    th.build_vector_index(layers=(0, 1, 2))
    for q in QUERIES:
        assert_same_results(th.search(q), jh.search(q))


@pytest.mark.parametrize("emb_dtype", [None, "float32", "bfloat16"])
def test_emb_dtype_switch_matches_jax(film_pair, monkeypatch, emb_dtype):
    """``AHRAG_EMB_DTYPE`` chooses the storage type of a graph compiled
    without one, in both packages; search ids agree under each value."""
    if emb_dtype is None:
        monkeypatch.delenv("AHRAG_EMB_DTYPE", raising=False)
    else:
        monkeypatch.setenv("AHRAG_EMB_DTYPE", emb_dtype)
    jh, th = film_pair
    jh._tensors = th._tensors = None
    jgt, tgt = jh.tensors(), th.tensors()
    want = emb_dtype or "float32"
    assert jgt.emb.dtype == jnp.dtype(want)
    assert tgt.emb.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[want]
    for q in QUERIES:
        assert ids(th.search(q)) == ids(jh.search(q)), q
    jh._tensors = th._tensors = None


@pytest.mark.parametrize("pack", [None, "0", "1"])
def test_pack_children_switch_matches_jax(monkeypatch, pack):
    """``AHRAG_PACK_CHILDREN=0`` turns off the automatic child packing of a
    graph of 4,096 nodes or more, in both packages."""
    if pack is None:
        monkeypatch.delenv("AHRAG_PACK_CHILDREN", raising=False)
    else:
        monkeypatch.setenv("AHRAG_PACK_CHILDREN", pack)
    rng = np.random.default_rng(3)
    n_ent, n_sum = 4096, 64
    n = n_ent + n_sum
    emb = rng.standard_normal((n, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    kw = dict(embeddings=emb, node_types=[0] * n_ent + [1] * n_sum,
              levels=[0] * n_ent + [1] * n_sum, judges=[None] * n, confs=[None] * n,
              indexed=[True] * n,
              parents={i: [n_ent + i % n_sum] for i in range(n_ent)},
              children={n_ent + s: list(range(s, n_ent, n_sum)) for s in range(n_sum)},
              related={}, hyperedges={}, members={})
    jgt = jtensors.build_graph_tensors(**kw)
    tgt = ttensors.build_graph_tensors(**kw, device="cpu")
    assert (tgt.child_pack_emb is None) == (jgt.child_pack_emb is None) == (pack == "0")
    if jgt.child_pack_ids is not None:
        np.testing.assert_array_equal(tgt.child_pack_ids.numpy(),
                                      np.asarray(jgt.child_pack_ids))
    assert tgt.emb_binpack is None     # built only on the card, as on the TPU only


@pytest.mark.parametrize("binpack", [None, "0", "1"])
def test_binpack_switch(monkeypatch, binpack):
    """``AHRAG_BINPACK=0`` drops the bin-packed corpus copy that the card
    builds from 65,536 nodes (the JAX package's switch, read at its point)."""
    if binpack is None:
        monkeypatch.delenv("AHRAG_BINPACK", raising=False)
    else:
        monkeypatch.setenv("AHRAG_BINPACK", binpack)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ttensors.wants_binpack(cuda, 65536, 65536) == (binpack != "0")
    assert not ttensors.wants_binpack(cuda, 65535, 65536)
    assert not ttensors.wants_binpack(cuda, 70000, 70000)      # n_pad % 1024 != 0
    assert not ttensors.wants_binpack(cpu, 65536, 65536)


def test_graph_saved_without_lsa_is_refused_unless_its_projection_is_given(tmp_path):
    """Without an ``lsa`` basis the documents were projected through the JAX
    encoder's ``jax.random`` Gaussian: loading refuses, unless that projection
    is passed; then search and the service rank as the JAX package does."""
    from ahrag_tpu.serve import RetrievalService as JRS
    from ahrag_tpu_torch.serve import RetrievalService as TRS
    jh = helpers.build_film_graph()
    jh.build_vector_index(layers=(0, 1, 2), fit_lsa=False)
    assert jh._lsa is None
    jh.save(str(tmp_path))
    with pytest.raises(ValueError, match="no 'lsa' basis"):
        THG.load(str(tmp_path), device="cpu")
    proj, _ = convert.projection_from_numpy(np.asarray(jh._encoder()._proj), jh._idf,
                                            device="cpu")
    th = THG.load(str(tmp_path), device="cpu", projection=proj)
    np.testing.assert_allclose(th.encode_query(QUERIES), jh.encode_query(QUERIES),
                               rtol=0, atol=1e-5)
    jsvc = JRS(hg=jh, max_wait_s=0.001)
    tsvc = TRS(hg=th, max_wait_s=0.001, device="cpu")
    assert tsvc._proj_dev is th.query_basis()
    for q, jr, tr in zip(QUERIES, jsvc.search_many(QUERIES), tsvc.search_many(QUERIES)):
        assert_same_results(th.search(q), jh.search(q))
        assert_same_results(tr, jr)
    jsvc.close()
    tsvc.close()


def test_graph_indexed_by_the_port_without_lsa_is_consistent(tmp_path):
    """A graph the port indexes itself without an ``lsa`` basis uses its own
    Gaussian for documents and queries alike, and is not refused; saved,
    it loads again given that projection."""
    th = port_film_graph()
    th.build_vector_index(layers=(0, 1, 2), fit_lsa=False)
    assert th._lsa is None and th.query_basis() is None
    enc = th._encoder()
    for nid in ("sum:0", th.find_entity("Ed Wood")):
        emb = enc.encode([th._embedding_text(nid)], idf=th._idf)[0]
        np.testing.assert_allclose(emb, th._embeddings[nid], rtol=0, atol=1e-6)
    th.save(str(tmp_path))
    t2 = THG.load(str(tmp_path), device="cpu", projection=enc._proj)
    for q in QUERIES:
        assert_same_results(t2.search(q), th.search(q))


@pytest.fixture(scope="module")
def corpus_pair(tmp_path_factory):
    jh = corpus_graph(JHG(encoder_name="hashed"))
    jh.build_vector_index(layers=(0, 1, 2), train_expansion=False, fit_lsa=False)
    d = tmp_path_factory.mktemp("corpus")
    jh.save(str(d))
    proj = np.asarray(jh._encoder()._proj)
    return jh, THG.load(str(d), device="cpu", projection=proj)


def test_corpus_graph_of_4122_nodes_searches_alike(corpus_pair):
    """The sample corpus as a 4,122-node graph (n_pad 5,120, child packing on):
    saved by the JAX package, loaded by the port, the same ids for 16 sample
    questions, scores within 1e-4."""
    jh, th = corpus_pair
    assert th.number_of_nodes() == 4122 and th.tensors().n_pad == 5120
    assert th.tensors().child_pack_emb is not None
    for q in sample_questions(16):
        assert_same_results(th.search(q), jh.search(q))


def test_tensors_compile_once_under_eight_cold_threads(monkeypatch):
    """Eight threads that call ``tensors()`` on a cold graph together get one
    compile and the same object."""
    import sys
    import threading
    th = port_film_graph()
    th.build_vector_index(layers=(0, 1, 2))
    calls = []
    orig = th._compile_tensors
    monkeypatch.setattr(th, "_compile_tensors", lambda: calls.append(1) or orig())
    barrier = threading.Barrier(8)
    got = []

    def worker():
        barrier.wait()
        got.append(th.tensors())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 8 and all(g is got[0] for g in got)
