"""Spherical k-means on the device: the build-time clustering primitive.

Port of ``ahrag_tpu/ops/kmeans.py`` (cosine k-means over normalised rows: a
greedy farthest-point init from a seeded start, then a fixed number of EM
steps; an empty cluster keeps its centroid; ties go to the lowest index). The
JAX function is ``jit`` plus ``lax.scan`` over two matrix products, outside
any Pallas kernel, so the port runs plain torch.

- **The start** is ``jax.random.randint(jax.random.PRNGKey(seed), (), 0, n)``
  reproduced without JAX (``utils/jax_random.randint``). Any other start
  gives another init, other clusters and other artifacts.
- **The products accumulate in float64** (the JAX package's run in float32),
  and the result is rounded to float32 at the end. A float32 product sums in
  each device's own order and differs in the last place between the card and
  the CPU; a near-tied argmax in an early step then spreads to every later
  step, and the artifacts built from the centroids differ. In float64 the two
  devices agree on every decision and on every float32 bit of the result but
  where a value lies within about 1e-16 of a float32 rounding boundary.
- **The cluster sums** are the one-hot product, as in JAX: a scatter with
  atomics (``index_add_``) would add in no fixed order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.utils import jax_random

def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def unit_rows(emb, device=None) -> torch.Tensor:
    """``emb [N, D]`` (numpy or a tensor) as L2-normalised float64 rows on
    ``device``: ``cuda`` unless the caller names another, or the device of a
    tensor given with no ``device``."""
    if isinstance(emb, torch.Tensor):
        dev = emb.device if device is None else resolve_device(device)
    else:
        dev, emb = resolve_device(device), torch.as_tensor(np.asarray(emb))
    return _normalize(emb.to(dev, torch.float64))


def kmeans_init(x: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """Farthest-point init over normalised float64 rows ``x [N, D]``: the
    seeded start, then ``k - 1`` times the row least similar to every chosen
    centroid (``argmin`` takes the lowest index of a tie). [k, D] float64."""
    n = x.shape[0]
    start = jax_random.randint(seed, n)
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[start]
    best = torch.mv(x, x[start])
    for c in range(1, k):
        nxt = torch.argmin(best)
        cents[c] = x[nxt]
        best = torch.maximum(best, torch.mv(x, x[nxt]))
    return cents


def kmeans_em(x: torch.Tensor, cents: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """``iters`` EM steps over normalised float64 rows: assign each row to its
    most similar centroid (``argmax``, lowest index of a tie), then move each
    centroid to its members' normalised sum (the one-hot product); an empty
    cluster keeps its centroid."""
    k = cents.shape[0]
    for _ in range(iters):
        assign = torch.argmax(x @ cents.T, dim=1)
        onehot = torch.zeros((x.shape[0], k), dtype=x.dtype, device=x.device)
        onehot.scatter_(1, assign[:, None], 1.0)
        sums = onehot.T @ x
        counts = onehot.sum(dim=0)[:, None]
        cents = torch.where(counts > 0, _normalize(sums), cents)
    return cents


def spherical_kmeans(emb, k: int, iters: int = 25, seed: int = 0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster the normalised rows of ``emb [N, D]`` (numpy or a tensor) into
    ``k`` cosine clusters on ``device`` (as ``unit_rows``). Returns
    (assignments [N] int32, centroids [k, D] float32, normalised)."""
    x = unit_rows(emb, device)
    cents = kmeans_em(x, kmeans_init(x, k, seed), iters)
    assign = torch.argmax(x @ cents.T, dim=1).to(torch.int32)
    return assign, cents.float()
