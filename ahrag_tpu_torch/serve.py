"""Serving path: query text -> packed sparse features -> fused encode + search.

Port of the hashed-encoder serving path of ``ahrag_tpu/serve.py``:
``pack_queries`` is the featurize-and-pack half of
``RetrievalService._featurize_batch`` and ``encode_and_search`` is
``_encode_and_search``. The service, its micro-batcher and the HTTP front
end come with the port of ``HierarchicalGraph``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.graph.search import SearchWeights, hybrid_search_batch
from ahrag_tpu_torch.graph.tensors import GraphTensors
from ahrag_tpu_torch.models.encoder.hashed import (HashedNGramEncoder,
                                                   _project_normalize_sparse)

BATCH_BUCKETS = (1, 4, 16, 64, 256)


def batch_bucket(n: int) -> int:
    """Batches pad to a few fixed sizes (1, 4, 16, 64, 256, then multiples of
    256), which bounds the distinct shapes the device sees."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def pack_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int,
             buckets: int) -> np.ndarray:
    """Pack COO feature triplets of an ``n_rows`` batch into ONE float32 array.

    The nnz cap is ``max(4096, 128 * n_rows)``, doubled until the features
    fit. Layout ``[cap, 2]`` holds (row * buckets + col, val) while that key
    is exact in float32, ``(n_rows + 1) * buckets < 2**24``; otherwise
    ``[cap, 3]`` holds (row, col, val). Padding entries point at the dump row
    ``n_rows``."""
    nnz = len(rows)
    cap = max(4096, 128 * n_rows)
    while cap < nnz:
        cap *= 2
    if (n_rows + 1) * buckets < (1 << 24):
        packed = np.zeros((cap, 2), np.float32)
        packed[:nnz, 0] = rows.astype(np.int64) * buckets + cols.astype(np.int64)
        packed[:nnz, 1] = vals
        packed[nnz:, 0] = n_rows * buckets
    else:
        packed = np.zeros((cap, 3), np.float32)
        packed[:nnz, 0] = rows
        packed[:nnz, 1] = cols
        packed[:nnz, 2] = vals
        packed[nnz:, 0] = n_rows
    return packed


def pack_queries(queries: List[str], encoder: HashedNGramEncoder, assoc=None
                 ) -> Tuple[int, int, np.ndarray]:
    """Featurize on the host (the threaded C++ featurizer) and pack the sparse
    features into ONE float32 array (``pack_coo``), so a batch costs a single
    upload. Returns (n, n_rows, packed), where ``n_rows`` is the bucketed
    batch, padded with empty queries.

    ``assoc`` (from ``train_associations``) adds the query-side association
    expansion, as the JAX serving stage does when its graph carries one."""
    padded = queries + [""] * (batch_bucket(len(queries)) - len(queries))
    rows, cols, vals = encoder._coo_block(padded)
    if assoc is not None:
        rows, cols, vals = encoder.expand_coo(rows, cols, vals, assoc)
    return len(queries), len(padded), pack_coo(rows, cols, vals, len(padded),
                                               encoder.buckets)


def encode_and_search(coo_packed: np.ndarray, proj: torch.Tensor,
                      idf: torch.Tensor, gt: GraphTensors, w: SearchWeights, *,
                      n_rows: int, top_k: int, member_top_m: int) -> torch.Tensor:
    """Packed sparse query features -> embeddings -> hybrid search, on the
    graph's device. ``coo_packed`` (see ``pack_queries``) is uploaded once.

    Returns ONE [n_rows, top_k, 4] float32 tensor of (reranked_idx,
    reranked_score, reranked_sem, reranked_valid), so the result comes back
    in a single copy (ids are exact in float32 below 2**24 nodes)."""
    coo = torch.from_numpy(coo_packed).to(gt.device)
    if coo.shape[-1] == 2:
        buckets = proj.shape[0]
        key = coo[:, 0].long()
        rows = key // buckets
        cols = key - rows * buckets
        vals = coo[:, 1]
    else:
        rows = coo[:, 0].long()
        cols = coo[:, 1].long()
        vals = coo[:, 2]
    q = _project_normalize_sparse(rows, cols, vals, proj, idf, n_rows)
    res = hybrid_search_batch(gt, q, w, top_k=top_k, member_top_m=member_top_m)
    return torch.stack([res.reranked_idx.float(), res.reranked_score,
                        res.reranked_sem, res.reranked_valid.float()], dim=-1)
