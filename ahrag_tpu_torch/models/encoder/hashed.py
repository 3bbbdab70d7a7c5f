"""Deterministic hashed n-gram encoder.

Port of ``ahrag_tpu/models/encoder/hashed.py``:

  text --host, C++--> sparse feature counts over ``buckets`` hash buckets
       --device--> sublinear TF x IDF, dense projection [buckets, dim], L2 normalise

Features are lowercased word unigrams and bigrams plus character 3..5-grams
(weighted by ``cgram_weight``), hashed with FNV-1a 64. The port's copy of the
threaded C++ featurizer (``ahrag_tpu_torch.native``) computes them on every
path; ``_count_matrix`` is the same featurizer in Python, kept as the plain
version the tests hold the native one against. The projection is the JAX
package's seeded Gaussian, ``jax.random.normal(PRNGKey(seed), (buckets,
dim)) / sqrt(dim)``, drawn without JAX by ``utils/jax_random.py`` (its
uniforms to the bit, its ``erf_inv`` within 6e-6 relatively), so the same
text embeds to the same entity embeddings and clusters in both packages.
Corpus statistics (IDF, the LSA basis,
bucket associations) are numpy arrays, as in the JAX package; their matrix
products run in float32 on the encoder's device.
"""
from __future__ import annotations

import math
import re
from typing import List

import numpy as np
import torch

from ahrag_tpu_torch import native
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.utils import jax_random

_WORD_RE = re.compile(r"[a-z0-9]+")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _fnv1a(data: bytes) -> int:
    """FNV-1a 64, bit-identical to the JAX package's hasher."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _bucket(feature: str, buckets: int) -> int:
    return _fnv1a(feature.encode("utf-8")) % buckets


def _features(text: str) -> List[str]:
    t = text.lower()
    words = _WORD_RE.findall(t)
    feats = list(words)
    feats += [f"{a}_{b}" for a, b in zip(words, words[1:])]
    compact = " ".join(words)
    for n in (3, 4, 5):
        feats += [f"c{n}:{compact[i:i + n]}" for i in range(max(0, len(compact) - n + 1))]
    return feats


def _project_normalize(counts: torch.Tensor, proj: torch.Tensor,
                       idf: torch.Tensor) -> torch.Tensor:
    """Sublinear TF (``min(c, 1) * (1 + log(max(c, 1)))``, so fractional
    char-gram counts ramp linearly) times IDF, projected in float32 and L2
    normalised. [B, buckets] -> [B, dim]."""
    tf = torch.clamp(counts, max=1.0) * (1.0 + torch.log(torch.clamp(counts, min=1.0)))
    emb = torch.matmul(tf * idf[None, :], proj)
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-9)


def _project_normalize_sparse(rows: torch.Tensor, cols: torch.Tensor,
                              vals: torch.Tensor, proj: torch.Tensor,
                              idf: torch.Tensor, n_rows: int) -> torch.Tensor:
    """COO variant: scatter-add the counts on the device, then project, in
    ``proj``'s type. Padding entries point at an extra dump row ``n_rows``."""
    counts = torch.zeros((n_rows + 1, proj.shape[0]), dtype=proj.dtype,
                         device=proj.device)
    counts.index_put_((rows, cols), vals, accumulate=True)
    return _project_normalize(counts[:n_rows], proj, idf)


class HashedNGramEncoder:
    def __init__(self, dim: int = 384, buckets: int = 16384, seed: int = 7,
                 cgram_weight: float = 0.3, device=None) -> None:
        """``cgram_weight`` scales char-gram occurrences relative to words
        (1.0); it is part of the encoder's identity (``name``), because an
        index built at one weight must be queried at the same weight."""
        tag = "" if cgram_weight == 1.0 else f"-cg{cgram_weight:g}"
        self.name = f"hashed-ngram-b{buckets}-d{dim}-s{seed}{tag}"
        self.dim = dim
        self.buckets = buckets
        self.seed = seed
        self.cgram_weight = float(cgram_weight)
        self.device = resolve_device(device)
        self._proj = torch.from_numpy(
            jax_random.normal(seed, (buckets, dim)) / np.float32(math.sqrt(dim))
        ).to(self.device)

    def _coo_block(self, texts: List[str]):
        """Sparse (rows, cols, vals) feature counts from the threaded C++
        featurizer: doc-major, ascending buckets within a doc."""
        return native.hash_features_coo(texts, self.buckets,
                                        cgram_weight=self.cgram_weight)

    def _count_matrix(self, texts: List[str]) -> np.ndarray:
        """Dense [len(texts), buckets] float32 feature counts in Python: the
        plain version of the native featurizer. Each weight is added as a
        float32, in the native featurizer's feature order, so the two agree
        bit for bit."""
        counts = np.zeros((len(texts), self.buckets), dtype=np.float32)
        cg = np.float32(self.cgram_weight)
        for i, text in enumerate(texts):
            for f in _features(text or ""):
                w = cg if f[:1] == "c" and f[2:3] == ":" else np.float32(1.0)
                if w:
                    counts[i, _bucket(f, self.buckets)] += w
        return counts

    # rows per encode chunk; a batch takes the smallest that covers it (see
    # encode_device), which bounds the distinct shapes a caller sees
    _CHUNKS = (16, 64, 256, 1024, 8192)

    def encode_device(self, texts: List[str], chunk: int | None = None,
                      idf: np.ndarray | None = None, assoc=None,
                      basis: np.ndarray | torch.Tensor | None = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Encode in fixed-size chunks: the native featurizer's COO triplets go
        to the device padded to a fixed nnz cap (``chunk * 256``, else the
        next power of two; padding entries point at a dump row), where they
        are scattered, weighted and projected. Returns [len(texts), dim]
        float32 on the encoder's device.

        ``chunk=None`` picks the smallest bucket of ``_CHUNKS`` covering the
        batch, unless it would more than double the padded work; then the
        largest bucket that fits is looped. ``idf`` ([buckets]) weights the
        features of documents and queries alike; ``assoc`` (from
        ``train_associations``) expands query features; ``basis``
        ([buckets, dim] numpy or tensor, from ``fit_projection`` or carried
        across from the JAX package) replaces the Gaussian. ``dtype`` is the
        type of the weighting, the product and the norm; the result is
        float32 either way. float64 makes it the same to the bit on the card
        and on the CPU (a float32 product sums in each device's own order, and
        differs in the last place); the build pipeline's entity embeddings,
        an artifact, take it."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        if chunk is None:
            up = [c for c in self._CHUNKS if c >= len(texts)]
            if up and (up[0] <= 2 * len(texts) or up[0] == self._CHUNKS[0]):
                chunk = up[0]
            else:
                chunk = max(c for c in self._CHUNKS if c <= len(texts))
        idf_v = (np.ones(self.buckets, np.float32) if idf is None
                 else np.asarray(idf, np.float32))
        idf_dev = torch.from_numpy(idf_v).to(self.device)
        if basis is None:
            proj = self._proj
        elif isinstance(basis, torch.Tensor):
            proj = basis.to(self.device, torch.float32)
        else:
            proj = torch.from_numpy(np.array(basis, np.float32)).to(self.device)
        proj, idf_dev = proj.to(dtype), idf_dev.to(dtype)
        fixed_cap = chunk * 256
        outs = []
        for i in range(0, len(texts), chunk):
            block = texts[i:i + chunk]
            rows, cols, vals = self._coo_block(block)
            if assoc is not None:   # query-side co-occurrence expansion
                rows, cols, vals = self.expand_coo(rows, cols, vals, assoc)
            nnz = len(rows)
            cap = fixed_cap if nnz <= fixed_cap else 1 << (nnz - 1).bit_length()
            pad = cap - nnz
            rows = np.concatenate([rows, np.full(pad, chunk)]).astype(np.int64)
            cols = np.concatenate([cols, np.zeros(pad)]).astype(np.int64)
            vals = np.concatenate([vals, np.zeros(pad)]).astype(np.float32)
            out = _project_normalize_sparse(
                torch.from_numpy(rows).to(self.device),
                torch.from_numpy(cols).to(self.device),
                torch.from_numpy(vals).to(self.device, dtype), proj, idf_dev,
                n_rows=chunk)
            outs.append(out[:len(block)].float())
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def encode(self, texts: List[str], idf: np.ndarray | None = None,
               assoc=None, basis: np.ndarray | torch.Tensor | None = None,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
        return self.encode_device(texts, idf=idf, assoc=assoc, basis=basis,
                                  dtype=dtype).cpu().numpy()

    def _tfidf_block(self, block: List[str], idf_v: np.ndarray) -> np.ndarray:
        """Dense sublinear-TF x IDF rows for ``block``: the weighting
        ``_project_normalize`` applies, on the host, for fitting."""
        counts = native.hash_features_counts(block, self.buckets,
                                             cgram_weight=self.cgram_weight)
        tf = (np.minimum(counts, 1.0)
              * (1.0 + np.log(np.maximum(counts, 1.0)))).astype(np.float32)
        return tf * idf_v[None, :]

    def _matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """``a @ b`` in float32 on the encoder's device, back as numpy."""
        return torch.matmul(torch.from_numpy(a).to(self.device),
                            torch.from_numpy(b).to(self.device)).cpu().numpy()

    def fit_projection(self, texts: List[str], idf: np.ndarray | None = None,
                       sample: int = 20000, oversample: int = 48,
                       chunk: int = 1024) -> np.ndarray | None:
        """Corpus-fitted LSA basis ([buckets, dim] float32) replacing the
        Gaussian projection for this corpus, or None below two documents.

        With at most ``dim`` documents it is an orthonormal basis of their row
        span (economy SVD), so inner products through it are the exact hashed
        TF-IDF cosines up to the query's out-of-span part. With more it is the
        top-``dim`` right singular subspace by a two-pass randomized SVD,
        seeded by ``self.seed``, over a stride sample of at most ``sample``
        documents, chunked so that the dense [n, buckets] matrix never
        exists."""
        n = len(texts)
        if n < 2:
            return None
        if n > sample:   # deterministic stride sample bounds the fitting cost
            step = n / sample
            texts = [texts[int(i * step)] for i in range(sample)]
            n = len(texts)
        idf_v = (np.ones(self.buckets, np.float32) if idf is None
                 else np.asarray(idf, np.float32))
        if n <= self.dim:
            A = np.concatenate([self._tfidf_block(texts[i:i + chunk], idf_v)
                                for i in range(0, n, chunk)], axis=0)
            _, s, vt = np.linalg.svd(A, full_matrices=False)
            r = int((s > (s[0] if s.size else 0.0) * 1e-6).sum())
            if r == 0:
                return None
            basis = np.zeros((self.buckets, self.dim), np.float32)
            basis[:, :r] = vt[:r].T
            return basis
        rng = np.random.default_rng(self.seed)
        k = min(self.dim + oversample, n)
        G = rng.standard_normal((self.buckets, k)).astype(np.float32)
        Y = np.empty((n, k), np.float32)
        for i in range(0, n, chunk):
            X = self._tfidf_block(texts[i:i + chunk], idf_v)
            Y[i:i + len(X)] = self._matmul(X, G)
        Q, _ = np.linalg.qr(Y)
        Bmat = np.zeros((k, self.buckets), np.float32)
        for i in range(0, n, chunk):
            X = self._tfidf_block(texts[i:i + chunk], idf_v)
            Bmat += self._matmul(np.ascontiguousarray(Q[i:i + len(X)].T), X)
        _, _, vt = np.linalg.svd(Bmat, full_matrices=False)
        basis = vt[: self.dim].T.astype(np.float32)
        if basis.shape[1] < self.dim:
            basis = np.pad(basis, ((0, 0), (0, self.dim - basis.shape[1])))
        return basis

    def document_frequencies(self, texts: List[str], chunk: int = 1024) -> np.ndarray:
        """Per-bucket document frequencies over ``texts`` ([buckets] int64):
        the native COO holds one triplet per (doc, bucket)."""
        df = np.zeros(self.buckets, np.int64)
        for i in range(0, len(texts), chunk):
            df += np.bincount(self._coo_block(texts[i:i + chunk])[1],
                              minlength=self.buckets)
        return df

    def train_associations(self, texts: List[str], m: int = 4,
                           max_active: int = 8192, beta: float = 0.35,
                           sample: int = 20000, chunk: int = 1024,
                           min_df: int = 2):
        """Corpus-trained bucket associations for query expansion: document
        co-occurrence counts ``C = X^T X`` of the binary incidence over the
        (at most ``max_active``) buckets with ``df >= min_df``, float32 on the
        encoder's device; PPMI weighting; the top ``m`` per bucket, scaled to
        ``beta`` at the row's best. Applied to queries only (``expand_coo``).

        Returns ``(assoc_idx [buckets, m] int32 (-1 pad), assoc_w [buckets, m]
        float32)``, or None when the corpus is too small to train on."""
        if len(texts) < 8:
            return None
        if len(texts) > sample:   # deterministic sample bounds the training cost
            step = len(texts) / sample
            texts = [texts[int(i * step)] for i in range(sample)]
        df = self.document_frequencies(texts, chunk=chunk)
        active = np.flatnonzero(df >= min_df)
        if active.size < 2:
            return None
        if active.size > max_active:
            order = np.argsort(-df[active], kind="stable")
            active = np.sort(active[order[:max_active]])
        amap = np.full(self.buckets, -1, np.int32)
        amap[active] = np.arange(active.size, dtype=np.int32)

        a = active.size
        C = torch.zeros((a, a), dtype=torch.float32, device=self.device)
        n_docs = 0
        for i in range(0, len(texts), chunk):
            block = texts[i:i + chunk]
            rows, cols, _ = self._coo_block(block)
            keep = amap[cols] >= 0
            X = np.zeros((len(block), a), np.float32)
            X[rows[keep], amap[cols[keep]]] = 1.0   # binary incidence
            Xd = torch.from_numpy(X).to(self.device)
            C += torch.matmul(Xd.T, Xd)
            n_docs += len(block)
        C = C.cpu().numpy()
        occ = np.maximum(np.diag(C), 1.0)
        with np.errstate(divide="ignore"):   # PPMI over document co-occurrence
            pmi = np.log((C * n_docs) / (occ[:, None] * occ[None, :]))
        pmi[~np.isfinite(pmi)] = 0.0
        np.fill_diagonal(pmi, 0.0)
        pmi = np.maximum(pmi, 0.0)
        top = np.argsort(-pmi, axis=1, kind="stable")[:, :m]
        top_w = np.take_along_axis(pmi, top, axis=1)
        row_max = np.maximum(top_w[:, :1], 1e-9)
        w = (beta * top_w / row_max).astype(np.float32)
        w[top_w <= 0.0] = 0.0
        assoc_idx = np.full((self.buckets, m), -1, np.int32)
        assoc_w = np.zeros((self.buckets, m), np.float32)
        assoc_idx[active] = active[top].astype(np.int32)
        assoc_w[active] = w
        return assoc_idx, assoc_w

    @staticmethod
    def expand_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   assoc) -> tuple:
        """Apply trained associations to COO feature triplets (query side):
        each (row, col, val) adds (row, assoc_idx[col, j], val * assoc_w[col, j])."""
        rows, cols = np.asarray(rows), np.asarray(cols)
        vals = np.asarray(vals, np.float32)
        assoc_idx, assoc_w = assoc
        ai = assoc_idx[cols]                       # [nnz, m]
        aw = assoc_w[cols]
        keep = (ai >= 0) & (aw > 0)
        if not keep.any():
            return rows, cols, vals
        r2 = np.broadcast_to(rows[:, None], ai.shape)[keep]
        c2 = ai[keep]
        v2 = (vals[:, None] * aw)[keep]
        return (np.concatenate([rows, r2]), np.concatenate([cols, c2]),
                np.concatenate([vals, v2]).astype(np.float32))
