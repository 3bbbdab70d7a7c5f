"""Deterministic hashed n-gram encoder.

Port of ``ahrag_tpu/models/encoder/hashed.py``:

  text --host--> sparse feature counts over ``buckets`` hash buckets
       --device--> sublinear TF x IDF, dense projection [buckets, dim], L2 normalise

Features are lowercased word unigrams and bigrams plus character 3..5-grams
(weighted by ``cgram_weight``), hashed with FNV-1a 64 exactly as the JAX
package and its native featurizer do, so both packages bucket a text
identically. The projection is a seeded Gaussian from a ``torch.Generator``;
it differs from the JAX package's ``jax.random`` draw, so state that must
match is carried across with ``convert.projection_from_numpy``.
"""
from __future__ import annotations

import math
import re
from typing import List

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device

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
    """COO variant: scatter-add the counts on the device, then project.
    Padding entries point at an extra dump row ``n_rows``."""
    counts = torch.zeros((n_rows + 1, proj.shape[0]), dtype=torch.float32,
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
        gen = torch.Generator().manual_seed(seed)
        self._proj = (torch.randn((buckets, dim), generator=gen, dtype=torch.float32)
                      / math.sqrt(dim)).to(self.device)

    def _count_matrix(self, texts: List[str]) -> np.ndarray:
        """Dense [len(texts), buckets] float32 feature counts on the host."""
        counts = np.zeros((len(texts), self.buckets), dtype=np.float32)
        for i, text in enumerate(texts):
            for f in _features(text or ""):
                w = self.cgram_weight if f[:1] == "c" and f[2:3] == ":" else 1.0
                if w:
                    counts[i, _bucket(f, self.buckets)] += w
        return counts
