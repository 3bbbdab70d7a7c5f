"""The port's hashed encoder and fused encode + search against the JAX package.

The encoders' projections differ by construction (``jax.random`` vs a
``torch.Generator``), so the JAX projection and an IDF vector are carried
across with ``convert.projection_from_numpy``. Tolerances: feature counts
1e-6 (float32 sums of the same weights), embeddings 1e-5 and result scores
1e-5 (float32 projection and scatter order), ids and flags exactly.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ahrag_tpu import serve as jserve
from ahrag_tpu.graph import search as jsearch
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu.models.encoder import hashed as jhashed
from ahrag_tpu.utils.profiling import Timers
from ahrag_tpu_torch import bench_data, convert
from ahrag_tpu_torch import serve as tserve
from ahrag_tpu_torch.models.encoder import hashed as thashed

TEXTS = ["Who directed the 1994 biographical film Ed Wood?",
         "American superhero film directed by Scott Derrickson",
         "", "naïve café — unicode and punctuation!!", "a",
         "hierarchical retrieval over topic summaries and communities"]


def test_features_and_buckets_match_jax():
    for t in TEXTS:
        assert thashed._features(t) == jhashed._features(t)
        for f in thashed._features(t):
            assert thashed._bucket(f, 16384) == jhashed._bucket(f, 16384)


def test_count_matrix_matches_jax():
    jenc = jhashed.HashedNGramEncoder(dim=64)
    tenc = thashed.HashedNGramEncoder(dim=64, device="cpu")
    assert tenc.name == jenc.name
    np.testing.assert_allclose(tenc._count_matrix(TEXTS), jenc._count_matrix(TEXTS),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 6, 20])
def test_pack_queries_matches_jax_featurize_batch(n):
    """Same bucket, cap and layout as ``RetrievalService._featurize_batch``,
    and the same features up to the order of the nonzeros."""
    jenc = jhashed.HashedNGramEncoder(dim=64)
    tenc = thashed.HashedNGramEncoder(dim=64, device="cpu")
    queries = (TEXTS * 4)[:n]
    fake = SimpleNamespace(
        _bucket=jserve.RetrievalService._bucket, timers=Timers(),
        hg=SimpleNamespace(_encoder=lambda: jenc, query_assoc=lambda: None),
        _proj_dev=np.zeros((jenc.buckets, 1), np.float32))
    jn, jrows, jpacked = jserve.RetrievalService._featurize_batch(fake, queries)
    tn, trows, tpacked = tserve.pack_queries(queries, tenc)
    assert (tn, trows) == (jn, jrows) and tpacked.shape == jpacked.shape
    order = lambda p: p[np.lexsort(p.T[::-1])]  # noqa: E731
    np.testing.assert_allclose(order(tpacked), order(jpacked), rtol=0, atol=1e-6)


def test_batch_bucket_ladder():
    assert [tserve.batch_bucket(n) for n in (1, 2, 4, 5, 64, 65, 256, 257, 600)] == \
        [1, 4, 4, 16, 64, 256, 256, 512, 768]


def test_project_normalize_sparse_matches_jax():
    rng = np.random.default_rng(0)
    proj = (rng.standard_normal((512, 32)) / np.sqrt(32)).astype(np.float32)
    idf = rng.uniform(0.5, 2.0, 512).astype(np.float32)
    rows = np.concatenate([rng.integers(0, 6, 200), np.full(40, 6)]).astype(np.int32)
    cols = rng.integers(0, 512, 240).astype(np.int32)
    vals = rng.choice([0.3, 1.0, 2.0], 240).astype(np.float32)
    jout = jhashed._project_normalize_sparse(jnp.asarray(rows), jnp.asarray(cols),
                                             jnp.asarray(vals), jnp.asarray(proj),
                                             jnp.asarray(idf), 6)
    tout = thashed._project_normalize_sparse(
        torch.from_numpy(rows).long(), torch.from_numpy(cols).long(),
        torch.from_numpy(vals), torch.from_numpy(proj), torch.from_numpy(idf), 6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)


def _to_triplets(packed2: np.ndarray, buckets: int) -> np.ndarray:
    key = packed2[:, 0].astype(np.int64)
    return np.stack([key // buckets, key % buckets, packed2[:, 1]], axis=1).astype(np.float32)


@pytest.mark.parametrize("layout", [2, 3])
def test_encode_and_search_matches_jax(layout):
    arrs = bench_data.build_bench_arrays(4096, 64, d=64)
    empty = np.empty((0, 0), np.int32)
    jgt = jtensors.build_graph_tensors(
        embeddings=arrs.emb, node_types=arrs.node_type, levels=arrs.level,
        judges=arrs.judge, confs=arrs.conf, indexed=np.ones(arrs.n, bool),
        parents=arrs.parents_ell, children=arrs.children_ell,
        related=arrs.related_ell, hyperedges=empty, members=empty,
        emb_dtype="float32")
    leaves = {f.name: getattr(jgt, f.name) for f in dataclasses.fields(jgt)}
    leaves = {k: (v if k in ("n_nodes", "n_edges", "mask_trivial") or v is None
                  else np.asarray(v)) for k, v in leaves.items()}
    tgt = convert.graph_tensors_from_numpy(leaves, device="cpu")
    jenc = jhashed.HashedNGramEncoder(dim=64)
    idf = np.random.default_rng(1).uniform(0.5, 2.0, jenc.buckets).astype(np.float32)
    tproj, tidf = convert.projection_from_numpy(np.asarray(jenc._proj), idf, device="cpu")
    jw = jsearch.SearchWeights.create()
    tw = convert.search_weights_from_numpy(jw._asdict(), device="cpu")

    n, n_rows, packed = tserve.pack_queries(
        TEXTS[:5], thashed.HashedNGramEncoder(dim=64, device="cpu"))
    assert packed.shape[1] == 2
    if layout == 3:
        packed = _to_triplets(packed, jenc.buckets)
    jout = np.asarray(jserve._encode_and_search(
        jnp.asarray(packed), jenc._proj, jnp.asarray(idf), jgt, jw,
        n_rows=n_rows, top_k=5, member_top_m=5))
    tout = tserve.encode_and_search(packed, tproj, tidf, tgt, tw, n_rows=n_rows,
                                    top_k=5, member_top_m=5).numpy()
    assert tout.shape == jout.shape == (16, 5, 4)
    np.testing.assert_array_equal(tout[..., 0], jout[..., 0])
    np.testing.assert_array_equal(tout[..., 3], jout[..., 3])
    np.testing.assert_allclose(tout[..., 1:3], jout[..., 1:3], rtol=0, atol=1e-5)
