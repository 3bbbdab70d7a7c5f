"""The port's beam search against ``ahrag_tpu.graph.beam`` on the same state.

The film graph (compiled by each package from the same saved snapshot) and a
seeded 4,096-entity bench graph (the JAX ``GraphTensors`` carried across leaf
by leaf), in float32 and bf16 storage; the same query embeddings go to both.
Validity and ``visited_count`` must be equal, scores and cosines within
1e-5 (float32 accumulation order), and the evidence ids equal slot by slot,
except that two nodes whose JAX scores lie within ``NEAR_TIE`` of each other
may trade places: beam scores are not flushed near zero as hybrid search's
are, so nodes with no relation to the query score float32 noise (about
1e-8), whose order depends on the summation order. Such swaps are counted,
and every id must still appear in the same row.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.helpers as helpers
from ahrag_tpu.graph import beam as jbeam
from ahrag_tpu.graph import search as jsearch
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu_torch import bench_data, convert
from ahrag_tpu_torch.graph import HierarchicalGraph as THG
from ahrag_tpu_torch.graph import beam as tbeam
from ahrag_tpu_torch.graph import search as tsearch

FILM_QUERIES = ["Who directed the film Ed Wood?", "American directors", "Doctor Strange",
                "Tim Burton", "superhero film 2016", "no overlap with anything qqq"]
PARAMS = [(8, 3, 10), (4, 2, 5), (2, 1, 3), (1, 4, 8), (16, 0, 12)]
NEAR_TIE = 1e-6
WEIGHTS = {"default": {}, "summary_only": {"type_filter": ["summary"]},
           "judge_min": {"judge_min": 5.0}}


@pytest.fixture(scope="module")
def film(tmp_path_factory):
    jh = helpers.build_film_graph()
    jh.build_vector_index(layers=(0, 1, 2))
    d = tmp_path_factory.mktemp("film")
    jh.save(str(d))
    return jh, THG.load(str(d), device="cpu"), np.array(jh.encode_query(FILM_QUERIES))


@pytest.fixture(scope="module")
def bench():
    arrs = bench_data.build_bench_arrays(4096, 64, d=64)
    q = bench_data.bench_queries(arrs, 6)
    return arrs, q


def _bench_pair(arrs, emb_dtype):
    empty = np.empty((0, 0), np.int32)
    jgt = jtensors.build_graph_tensors(
        emb_dtype=emb_dtype, embeddings=arrs.emb, node_types=arrs.node_type,
        levels=arrs.level, judges=arrs.judge, confs=arrs.conf,
        indexed=np.ones(arrs.n, bool), parents=arrs.parents_ell,
        children=arrs.children_ell, related=arrs.related_ell, hyperedges=empty,
        members=empty)
    leaves = {f.name: (getattr(jgt, f.name) if f.name in ("n_nodes", "n_edges", "mask_trivial")
                       else None if getattr(jgt, f.name) is None
                       else np.asarray(getattr(jgt, f.name)))
              for f in dataclasses.fields(jgt)}
    return jgt, convert.graph_tensors_from_numpy(leaves, device="cpu")


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _compare(jres, tres) -> int:
    """Hold the port's ``BeamResult`` against the JAX one; returns the number
    of near-tie swaps."""
    np.testing.assert_array_equal(tres.evidence_valid.numpy(), np.asarray(jres.evidence_valid))
    np.testing.assert_array_equal(tres.visited_count.numpy(), np.asarray(jres.visited_count))
    np.testing.assert_allclose(_as_np(tres.evidence_score), np.asarray(jres.evidence_score),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_as_np(tres.evidence_sem), np.asarray(jres.evidence_sem),
                               rtol=0, atol=1e-5)
    j_idx = np.atleast_2d(np.asarray(jres.evidence_idx))
    t_idx = np.atleast_2d(tres.evidence_idx.numpy())
    j_score = np.atleast_2d(np.asarray(jres.evidence_score))
    swaps = 0
    for jr, tr, js in zip(j_idx, t_idx, j_score):
        assert sorted(jr) == sorted(tr)
        for pos in np.flatnonzero(jr != tr):
            where = int(np.flatnonzero(jr == tr[pos])[0])
            assert abs(js[where] - js[pos]) <= NEAR_TIE, (jr, tr, js)
            swaps += 1
    return swaps


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", PARAMS, ids=lambda p: "bw{}-d{}-k{}".format(*p))
@pytest.mark.parametrize("wname", sorted(WEIGHTS))
def test_beam_batch_on_the_film_graph_matches_jax(film, monkeypatch, emb_dtype, params,
                                                  wname):
    jh, th, q = film
    monkeypatch.setenv("AHRAG_EMB_DTYPE", emb_dtype)
    jh._tensors = th._tensors = None
    bw, depth, k = params
    jres = jbeam.beam_search_batch(jh.tensors(), jnp.asarray(q),
                                   jsearch.SearchWeights.create(**WEIGHTS[wname]),
                                   beam_width=bw, depth=depth, top_k=k)
    tres = tbeam.beam_search_batch(th.tensors(), torch.from_numpy(q),
                                   tsearch.SearchWeights.create(**WEIGHTS[wname],
                                                                device="cpu"),
                                   beam_width=bw, depth=depth, top_k=k)
    jh._tensors = th._tensors = None
    assert tres.evidence_idx.shape == (len(FILM_QUERIES), k)
    _compare(jres, tres)


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", PARAMS[:3], ids=lambda p: "bw{}-d{}-k{}".format(*p))
def test_beam_batch_on_the_bench_graph_matches_jax(bench, emb_dtype, params):
    arrs, q = bench
    jgt, tgt = _bench_pair(arrs, emb_dtype)
    bw, depth, k = params
    jres = jbeam.beam_search_batch(jgt, jnp.asarray(q), jsearch.SearchWeights.create(),
                                   beam_width=bw, depth=depth, top_k=k)
    tres = tbeam.beam_search_batch(tgt, torch.from_numpy(q),
                                   tsearch.SearchWeights.create(device="cpu"),
                                   beam_width=bw, depth=depth, top_k=k)
    assert _compare(jres, tres) == 0           # distinct scores: no tie to trade
    assert (tres.visited_count > bw).all()     # the beam left its seeds


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_single_query_beam_matches_jax(film, bench, emb_dtype):
    jh, th, q = film
    jh._tensors = th._tensors = None
    arrs, bq = bench
    jgt, tgt = _bench_pair(arrs, emb_dtype)
    for j_gt, t_gt, qs in ((jh.tensors(), th.tensors(), q), (jgt, tgt, bq)):
        for row in qs[:3]:
            jres = jbeam.beam_search(j_gt, jnp.asarray(row), jsearch.SearchWeights.create(),
                                     beam_width=4, depth=3, top_k=8)
            tres = tbeam.beam_search(t_gt, torch.from_numpy(row),
                                     tsearch.SearchWeights.create(device="cpu"),
                                     beam_width=4, depth=3, top_k=8)
            assert tres.evidence_idx.shape == (8,) and tres.visited_count.dim() == 0
            _compare(jres, tres)


def test_beam_climbs_the_hierarchy(film):
    """As ``tests/test_beam.py`` asks of the JAX package: an L2 summary only
    reachable through parents is in the evidence, scores descend."""
    _, th, q = film
    res = tbeam.beam_search(th.tensors(), torch.from_numpy(q[0]),
                            tsearch.SearchWeights.create(device="cpu"),
                            beam_width=4, depth=3, top_k=8)
    found = [th.idx_to_id(int(i)) for i, ok in zip(res.evidence_idx, res.evidence_valid)
             if ok]
    assert "sum:2" in found and th.find_entity("Ed Wood") in found
    s = res.evidence_score[res.evidence_valid]
    assert bool((s[1:] <= s[:-1]).all())
