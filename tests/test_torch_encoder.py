"""The port's native featurizer and hashed encoder against the JAX package.

Featurization is held bit for bit: the port's C++ copy against the JAX
package's featurizer (its native library when that is built, else its Python
featurizer, which agrees with it bit for bit) and against the port's own
Python ``_count_matrix``. Corpus statistics (document frequencies,
associations, their expansion) are held exactly: they are integer counts and
the same numpy steps. Tolerances: embeddings 1e-5 (float32 projection and
scatter order); LSA basis columns 1e-5 up to sign where both packages compute
the same SVD of the same matrix, 1e-4 up to sign in the randomized branch
wherever a singular value is separated from its neighbours by 0.1% of the
largest (the two products differ in float32 summation order, ~1e-7 relative,
and a column moves by about that noise over its relative gap; measured under
1e-6); search ids exactly.
"""
import dataclasses
import json
import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ahrag_tpu import native as jnative
from ahrag_tpu import serve as jserve
from ahrag_tpu.graph import search as jsearch
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu.models.encoder import hashed as jhashed
from ahrag_tpu.utils.profiling import Timers
from ahrag_tpu_torch import bench_data, convert, native
from ahrag_tpu_torch import serve as tserve
from ahrag_tpu_torch.models.encoder import create_encoder
from ahrag_tpu_torch.models.encoder import hashed as thashed

SAMPLES = pathlib.Path(__file__).resolve().parents[1] / "samples"
QUESTIONS = [json.loads(ln)["question"]
             for ln in (SAMPLES / "synth_v4_shared_train.jsonl").read_text().splitlines()]
CORPUS = [ln for ln in (SAMPLES / "synth_v4_shared_corpus_train.txt").read_text().splitlines()
          if ln.strip()]
ODD = ["", "naïve café — ÜNÏCÖDÉ 東京タワー 😀 über-straße", "a", "  \t\n ",
       "A" * 5000, " ".join(f"w{i} x" for i in range(3000)),
       "Mixed CASE, punctuation!!! and 1234 5678 digits."]
TEXTS = QUESTIONS[:40] + ODD
BUCKETS, DIM = 2048, 64


def _coo_of(counts):
    rows, cols = np.nonzero(counts)
    return rows.astype(np.int32), cols.astype(np.int32), counts[rows, cols]


def _jax_coo(texts, buckets, cg):
    """The JAX package's sparse featurization: its native library, or (when
    that is unbuilt) its Python featurizer's counts in the same order."""
    coo = jnative.hash_features_coo(texts, buckets, cgram_weight=cg)
    if coo is None:
        enc = jhashed.HashedNGramEncoder(dim=8, buckets=buckets, cgram_weight=cg)
        coo = _coo_of(enc._count_matrix(texts))
    return coo


def _assert_coo_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a[0].dtype == np.int32 and a[1].dtype == np.int32 and a[2].dtype == np.float32


@pytest.mark.parametrize("cg", [0.3, 1.0, 0.0])
@pytest.mark.parametrize("buckets", [16384, 97])
def test_native_coo_matches_jax_and_python(cg, buckets):
    coo = native.hash_features_coo(TEXTS, buckets, cgram_weight=cg)
    _assert_coo_equal(coo, _jax_coo(TEXTS, buckets, cg))
    tenc = thashed.HashedNGramEncoder(dim=8, buckets=buckets, cgram_weight=cg,
                                      device="cpu")
    _assert_coo_equal(coo, _coo_of(tenc._count_matrix(TEXTS)))


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_native_coo_is_doc_major_for_any_thread_count(n_threads):
    rows, cols, vals = native.hash_features_coo(QUESTIONS, 16384, n_threads=n_threads,
                                                cgram_weight=0.3)
    key = rows.astype(np.int64) * 16384 + cols
    assert (np.diff(key) > 0).all()
    _assert_coo_equal((rows, cols, vals), _jax_coo(QUESTIONS, 16384, 0.3))


def test_native_counts_match_jax_and_python():
    counts = native.hash_features_counts(TEXTS, BUCKETS, cgram_weight=0.3)
    jenc = jhashed.HashedNGramEncoder(dim=DIM, buckets=BUCKETS)
    tenc = thashed.HashedNGramEncoder(dim=DIM, buckets=BUCKETS, device="cpu")
    np.testing.assert_array_equal(counts, jenc._count_matrix(TEXTS))
    np.testing.assert_array_equal(counts, tenc._count_matrix(TEXTS))
    unweighted = native.hash_features_counts(TEXTS[:5], BUCKETS)
    jun = jnative.hash_features_counts(TEXTS[:5], BUCKETS)
    if jun is None:   # the JAX library is unbuilt: its Python featurizer
        jun = jhashed.HashedNGramEncoder(dim=8, buckets=BUCKETS,
                                         cgram_weight=1.0)._count_matrix(TEXTS[:5])
    np.testing.assert_array_equal(unweighted, jun)


def test_token_estimate():
    # the C++ rule: words of <= 4 chars one token (longer ceil(len/4)),
    # digit pairs, each punctuation char and each CJK code point one token
    expect = {"": 0, "hello world": 4, "a, b.": 4, "1234 5": 3, "東京": 2,
              "   ": 1, "naïve": 2}
    assert {t: native.token_estimate(t) for t in expect} == expect
    if jnative.available():
        for t in TEXTS + list(expect):
            assert native.token_estimate(t) == jnative.token_estimate(t)


def _encoders(buckets=BUCKETS):
    jenc = jhashed.HashedNGramEncoder(dim=DIM, buckets=buckets)
    tenc = thashed.HashedNGramEncoder(dim=DIM, buckets=buckets, device="cpu")
    tenc._proj, _ = convert.projection_from_numpy(
        np.asarray(jenc._proj), np.ones(buckets, np.float32), device="cpu")
    return jenc, tenc


@pytest.fixture(scope="module")
def corpus_state():
    """IDF, associations and LSA basis trained by the JAX package on the sample
    corpus, handed to both packages."""
    jenc, _ = _encoders()
    df = jenc.document_frequencies(CORPUS)
    idf = (np.log((1.0 + len(CORPUS)) / (1.0 + df)) + 1.0).astype(np.float32)
    assoc = jenc.train_associations(CORPUS[:400])
    basis = jenc.fit_projection(CORPUS[:300], idf=idf)
    return {"idf": idf, "assoc": assoc, "basis": basis}


@pytest.mark.parametrize("chunk", [16, 1024])
@pytest.mark.parametrize("use", ["", "idf", "assoc", "basis", "idf+assoc+basis"])
def test_encode_device_matches_jax(chunk, use, corpus_state):
    jenc, tenc = _encoders()
    kw = {name: corpus_state[name] for name in ("idf", "assoc", "basis") if name in use}
    texts = CORPUS[:40] + ODD[:4]
    jout = np.asarray(jenc.encode_device(texts, chunk=chunk, **kw))
    tout = tenc.encode_device(texts, chunk=chunk, **kw)
    assert tout.dtype == torch.float32 and tout.shape == (len(texts), DIM)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [1, 20, 300])
def test_encode_picks_the_jax_chunk_ladder(n):
    jenc, tenc = _encoders()
    texts = (CORPUS * 2)[:n]
    np.testing.assert_allclose(tenc.encode(texts), jenc.encode(texts), rtol=0, atol=1e-5)
    assert tenc.encode_device([]).shape == (0, DIM)


def _assert_columns_match(a, b, cols, atol):
    for j in cols:
        sign = 1.0 if float(a[:, j] @ b[:, j]) >= 0 else -1.0
        np.testing.assert_allclose(a[:, j], sign * b[:, j], rtol=0, atol=atol,
                                   err_msg=f"basis column {j}")


@pytest.mark.parametrize("n", [40, 300])
def test_fit_projection_matches_jax(n, corpus_state):
    jenc, tenc = _encoders()
    texts, idf = CORPUS[:n], corpus_state["idf"]
    jb = jenc.fit_projection(texts, idf=idf)
    tb = tenc.fit_projection(texts, idf=idf)
    assert tb.shape == jb.shape == (BUCKETS, DIM) and tb.dtype == np.float32
    s = np.linalg.svd(jenc._tfidf_block(texts, idf), compute_uv=False)
    if n <= DIM:   # the row span: the same numpy SVD of the same matrix
        _assert_columns_match(tb, jb, range(DIM), 1e-5)
        assert not tb[:, int((s > s[0] * 1e-6).sum()):].any()
        return
    s = s[:DIM + 1]
    gap = np.minimum(np.abs(np.diff(s, prepend=np.inf)[:DIM]),
                     np.abs(np.diff(s)[:DIM])) / s[0]
    separated = np.flatnonzero(gap > 1e-3)
    assert len(separated) >= DIM // 2
    _assert_columns_match(tb, jb, separated, 1e-4)
    assert tenc.fit_projection(texts[:1]) is None


def test_document_frequencies_and_associations_match_jax():
    jenc, tenc = _encoders()
    np.testing.assert_array_equal(tenc.document_frequencies(CORPUS, chunk=256),
                                  jenc.document_frequencies(CORPUS, chunk=256))
    ja = jenc.train_associations(CORPUS, chunk=512, max_active=1500)
    ta = tenc.train_associations(CORPUS, chunk=512, max_active=1500)
    for x, y in zip(ta, ja):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (ta[0] >= 0).any()
    assert tenc.train_associations(CORPUS[:7]) is None
    coo = native.hash_features_coo(QUESTIONS[:16], BUCKETS, cgram_weight=0.3)
    jexp = jhashed.HashedNGramEncoder.expand_coo(*coo, ja)
    texp = thashed.HashedNGramEncoder.expand_coo(*coo, ta)
    assert len(texp[0]) > len(coo[0])
    for x, y in zip(texp, jexp):
        np.testing.assert_array_equal(x, y)


def _python_pack(queries, enc):
    """``pack_queries`` over the Python featurizer: dense counts and
    ``np.nonzero``, as the port packed before it had the native one."""
    padded = queries + [""] * (tserve.batch_bucket(len(queries)) - len(queries))
    packed = tserve.pack_coo(*_coo_of(enc._count_matrix(padded)), len(padded),
                             enc.buckets)
    return len(queries), len(padded), packed


@pytest.mark.parametrize("n", [3, 16, 64, 150])
def test_pack_queries_is_bit_identical_to_the_python_path(n):
    enc = thashed.HashedNGramEncoder(dim=DIM, device="cpu")
    n_, rows, packed = tserve.pack_queries(QUESTIONS[:n], enc)
    pn, prows, ppacked = _python_pack(QUESTIONS[:n], enc)
    assert (n_, rows) == (pn, prows)
    np.testing.assert_array_equal(packed, ppacked)


def _fake_service(jenc, assoc):
    return SimpleNamespace(
        _bucket=jserve.RetrievalService._bucket, timers=Timers(),
        hg=SimpleNamespace(_encoder=lambda: jenc, query_assoc=lambda: assoc),
        _proj_dev=np.zeros((jenc.buckets, 1), np.float32))


def test_pack_queries_with_assoc_matches_jax_and_searches_alike(corpus_state):
    jenc, tenc = _encoders()
    assoc = corpus_state["assoc"]
    queries = QUESTIONS[:13]
    jn, jrows, jpacked = jserve.RetrievalService._featurize_batch(
        _fake_service(jenc, assoc), queries)
    n, n_rows, packed = tserve.pack_queries(queries, tenc, assoc=assoc)
    assert (n, n_rows) == (jn, jrows)
    np.testing.assert_array_equal(packed, jpacked)
    assert not np.array_equal(packed, tserve.pack_queries(queries, tenc)[2])

    arrs = bench_data.build_bench_arrays(2048, 32, d=DIM)
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
    tproj, tidf = convert.projection_from_numpy(np.asarray(jenc._proj),
                                                corpus_state["idf"], device="cpu")
    jw = jsearch.SearchWeights.create()
    tw = convert.search_weights_from_numpy(jw._asdict(), device="cpu")
    jout = np.asarray(jserve._encode_and_search(
        jnp.asarray(packed), jenc._proj, jnp.asarray(corpus_state["idf"]), jgt, jw,
        n_rows=n_rows, top_k=5, member_top_m=5))
    tout = tserve.encode_and_search(packed, tproj, tidf, tgt, tw, n_rows=n_rows,
                                    top_k=5, member_top_m=5).numpy()
    np.testing.assert_array_equal(tout[..., 0], jout[..., 0])
    np.testing.assert_array_equal(tout[..., 3], jout[..., 3])
    np.testing.assert_allclose(tout[..., 1:3], jout[..., 1:3], rtol=0, atol=1e-5)


def test_create_encoder():
    enc = create_encoder({"encoder": {"dim": 32, "seed": 3}}, device="cpu")
    assert isinstance(enc, thashed.HashedNGramEncoder)
    assert enc.name == "hashed-ngram-b16384-d32-s3-cg0.3" and enc.device.type == "cpu"
    assert create_encoder({"encoder": {"dim": 32, "seed": 3}}, device="cpu") is enc
    for name in ("minilm", "learned"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            create_encoder(name=name, device="cpu")
