"""The port's graph tensors and hybrid search against the JAX package.

Both packages search the same state: the port's ``GraphTensors`` is carried
across from the JAX build leaf by leaf (``convert.graph_tensors_from_numpy``).
Tolerances: ids and flags exactly; scores 1e-5 (float32 accumulation order
and sigmoid implementations differ in the last bits).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ahrag_tpu.graph import search as jsearch
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu_torch import bench_data, convert
from ahrag_tpu_torch.graph import search as tsearch
from ahrag_tpu_torch.graph import tensors as ttensors

SEARCH_FIELDS = ("seed_idx", "seed_sim", "seed_valid", "reranked_idx",
                 "reranked_score", "reranked_sem", "reranked_valid", "cand_idx",
                 "cand_sem", "cand_win")


@pytest.fixture(scope="module")
def arrs():
    return bench_data.build_bench_arrays(4096, 64, d=64)


def _jax_gt(arrs, emb_dtype):
    n = arrs.n
    empty = np.empty((0, 0), np.int32)
    return jtensors.build_graph_tensors(
        emb_dtype=emb_dtype, embeddings=arrs.emb, node_types=arrs.node_type,
        levels=arrs.level, judges=arrs.judge, confs=arrs.conf,
        indexed=np.ones(n, bool), parents=arrs.parents_ell,
        children=arrs.children_ell, related=arrs.related_ell, hyperedges=empty,
        members=empty, n_edges=7)


def _leaves(jgt) -> dict:
    return {f.name: (None if getattr(jgt, f.name) is None
                     else np.asarray(getattr(jgt, f.name))
                     if f.name not in ("n_nodes", "n_edges", "mask_trivial")
                     else getattr(jgt, f.name))
            for f in dataclasses.fields(jgt)}


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_bench_arrays_match_bench_py(arrs):
    ref = bench.build_bench_arrays(4096, 64, d=64)
    for name in ("emb", "node_type", "level", "judge", "conf", "parents_ell",
                 "children_ell", "related_ell"):
        np.testing.assert_array_equal(getattr(arrs, name), getattr(ref, name))
    assert (arrs.n_topics, arrs.n_l2) == (ref.n_topics, ref.n_l2)


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_build_graph_tensors_matches_jax_leaf_by_leaf(arrs, emb_dtype):
    jgt = _jax_gt(arrs, emb_dtype)
    tgt = bench_data.bench_tensors(arrs, emb_dtype, device="cpu")
    tgt = dataclasses.replace(tgt, n_edges=7)
    for f in dataclasses.fields(jgt):
        jv, tv = getattr(jgt, f.name), getattr(tgt, f.name)
        if f.name in ("n_nodes", "n_edges", "mask_trivial"):
            assert jv == tv, f.name
        elif jv is None:
            assert tv is None, f.name
        else:
            np.testing.assert_array_equal(_as_np(tv), np.asarray(jv, np.float32)
                                          if jv.dtype == jnp.bfloat16
                                          else np.asarray(jv), err_msg=f.name)
            assert tv.shape == jv.shape, f.name
    assert tgt.emb.dtype == (torch.bfloat16 if emb_dtype == "bfloat16" else torch.float32)
    assert tgt.n_pad == 5120 and tgt.mask_trivial


def test_build_graph_tensors_dict_adjacency_matches_jax():
    """The dict (per-node list) adjacency path, None judges and a partial
    index, on a small graph."""
    rng = np.random.default_rng(3)
    n, d = 300, 16
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    children = {i: list(rng.integers(0, n, size=int(rng.integers(1, 12))))
                for i in range(0, n, 7)}
    parents = {i: [int(rng.integers(0, n))] for i in range(n) if i % 3}
    kw = dict(embeddings=emb, node_types=[i % 3 for i in range(n)],
              levels=[i % 2 for i in range(n)],
              judges=[None if i % 4 else 7.5 for i in range(n)],
              confs=[float(i % 9) if i % 5 else None for i in range(n)],
              indexed=[i % 11 != 0 for i in range(n)], parents=parents,
              children=children, related={1: [2, 3], 2: [1]}, hyperedges={},
              members={}, n_edges=42)
    jgt = jtensors.build_graph_tensors(**kw, pack_children=True)
    tgt = ttensors.build_graph_tensors(**kw, pack_children=True, device="cpu")
    for name, jv in _leaves(jgt).items():
        tv = getattr(tgt, name)
        if isinstance(jv, np.ndarray):
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)
        else:
            assert tv == jv, name


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_hybrid_search_batch_matches_jax(arrs, emb_dtype):
    jgt = _jax_gt(arrs, emb_dtype)
    tgt = convert.graph_tensors_from_numpy(_leaves(jgt), device="cpu")
    jw = jsearch.SearchWeights.create(judge_min=6.0)
    tw = convert.search_weights_from_numpy(jw._asdict(), device="cpu")
    q = bench_data.bench_queries(arrs, 24)
    jres = jsearch.hybrid_search_batch(jgt, jnp.asarray(q), jw)
    tres = tsearch.hybrid_search_batch(tgt, torch.from_numpy(q), tw)
    for name in SEARCH_FIELDS:
        jv, tv = np.asarray(getattr(jres, name)), getattr(tres, name).numpy()
        assert tv.shape == jv.shape, name
        if jv.dtype.kind == "f":
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=name)


def test_hybrid_search_single_matches_batch_row(arrs):
    tgt = bench_data.bench_tensors(arrs, "float32", device="cpu")
    w = tsearch.SearchWeights.create(device="cpu")
    q = torch.from_numpy(bench_data.bench_queries(arrs, 3))
    batch = tsearch.hybrid_search_batch(tgt, q, w)
    one = tsearch.hybrid_search(tgt, q[2], w)
    for name in SEARCH_FIELDS:
        # float32 sums over another batch shape may differ in the last bit
        np.testing.assert_allclose(getattr(one, name).numpy(),
                                   getattr(batch, name)[2].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_hybrid_search_matches_cpu_reference(arrs, emb_dtype):
    a = bench_data.build_bench_arrays(4096, 64, d=64)
    if emb_dtype == "bfloat16":
        a.emb = bench_data.round_bf16(a.emb)
    q = bench_data.bench_queries(a, 16)
    if emb_dtype == "bfloat16":
        q = bench_data.round_bf16(q)
    gt = bench_data.bench_tensors(a, emb_dtype, device="cpu")
    res = tsearch.hybrid_search_batch(gt, torch.from_numpy(q),
                                      tsearch.SearchWeights.create(device="cpu"))
    for b in range(16):
        ids = [int(i) for i, ok in zip(res.reranked_idx[b], res.reranked_valid[b]) if ok]
        assert ids == [i for i, _ in bench_data.cpu_reference_search(a, q[b])]
    audit = bench_data.certificate_audit(gt, torch.from_numpy(q), res, n_audit=16)
    assert audit == {"audited_queries": 16, "audit_mismatches": 0}


def test_type_filter_and_thresholds_match_jax(arrs):
    jgt = _jax_gt(arrs, "float32")
    tgt = convert.graph_tensors_from_numpy(_leaves(jgt), device="cpu")
    jw = jsearch.SearchWeights.create(type_filter=["entity"], conf_min=6.0)
    tw = tsearch.SearchWeights.create(type_filter=["entity"], conf_min=6.0,
                                      device="cpu")
    q = bench_data.bench_queries(arrs, 8)
    jres = jsearch.hybrid_search_batch(jgt, jnp.asarray(q), jw)
    tres = tsearch.hybrid_search_batch(tgt, torch.from_numpy(q), tw)
    np.testing.assert_array_equal(tres.reranked_valid.numpy(),
                                  np.asarray(jres.reranked_valid))
    np.testing.assert_array_equal(tres.reranked_idx.numpy(),
                                  np.asarray(jres.reranked_idx))
