"""Certified exact top-k over a device-resident corpus.

Port of the non-kernel logic of ``ahrag_tpu/ops/topk.py``. The coarse stage
at scale is the streaming bin-max (``ops/binmax.py``, hand-written CUDA on the
card); selected candidates are re-scored exactly in float32 and each query
gets a certificate that no row outside the candidate set can belong in its
top-k. Queries whose certificate fails are recomputed by a full float32 pass.

Where the JAX package branched on ``jax.default_backend() == "tpu"`` the port
branches on ``emb.is_cuda``: on the CPU it takes the flat branch, as JAX on
the CPU does. All scores are float32 accumulations: bf16 operands are widened
first, so their products are exact (the JAX package's bf16 storage contract),
and float32 products run in IEEE float32 with TF32 off (``device.py``).

Ties resolve to the lowest index everywhere (``stable_topk``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ahrag_tpu_torch.device import f32_matmul, stable_topk
from ahrag_tpu_torch.ops.binmax import NEG_INF, dense_binmax, dense_binmax2
from ahrag_tpu_torch.ops.tile_topk import dense_topk_fused
from ahrag_tpu_torch.utils.once import locked_cache

# Queries per coarse pass on the card. It bounds the [tiles, B, 128] float32
# bin buffer (546 MB at 1M rows); each further chunk re-reads the corpus once.
_CUDA_CHUNK = 1024


def dense_topk_ref(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by a full float32 matmul (``dense_topk_xla``)."""
    scores = f32_matmul(q, emb.T)
    col = torch.arange(emb.shape[0], device=emb.device)[None, :]
    return stable_topk(torch.where(col < n_valid, scores, NEG_INF), k)


def dense_topk(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat exact top-k, dispatching as the JAX package's ``dense_topk`` does:
    the fused per-tile kernel when the corpus lies on the card and N is a
    positive multiple of 1024, else the full float32 matmul. The shape rule
    is the JAX package's own; nothing falls back on failure.
    Returns (vals [B, k] float32, idx [B, k] int64)."""
    n = emb.shape[0]
    if emb.is_cuda and n >= 1024 and n % 1024 == 0:
        return dense_topk_fused(q, emb, n_valid, k)
    return dense_topk_ref(q, emb, n_valid, k)


def masked_topk(scores: torch.Tensor, mask: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis restricted to ``mask`` (others -> NEG_INF)."""
    return stable_topk(torch.where(mask, scores, NEG_INF), k)


def _unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _calibration_inputs(device: str, d: int, n: int, bf16_in: bool):
    """Seeded unit vectors for the eps calibrations: 64 queries, ``n`` rows."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_unit_rows(rng, 64, d)).to(device)
    e = torch.from_numpy(_unit_rows(rng, n, d)).to(device)
    if bf16_in:
        q, e = q.to(torch.bfloat16), e.to(torch.bfloat16)
    return q, e


def _max_err(x: torch.Tensor, true: np.ndarray) -> float:
    return float(np.max(np.abs(x.double().cpu().numpy() - true)))


@locked_cache
def matmul_eps(device: str, d: int, bf16_in: bool) -> float:
    """Calibrated bound on |coarse - exact| for unit vectors of dimension ``d``
    on the flat branch (``matmul_eps`` in the JAX package).

    Both the coarse and the re-score product are measured against a float64
    host ground truth on seeded unit vectors:
    eps = 8 * (max|coarse - f64| + max|exact - f64|) + 1e-7. As in the JAX
    package this is an empirical band with an 8x margin, not a worst-case
    proof. On the port both products are the same float32 matmul (TF32 off),
    so the band is accumulation-order noise only. Cached per (device, d,
    bf16_in)."""
    q, e = _calibration_inputs(device, d, 2048, bf16_in)
    true = q.double().cpu().numpy() @ e.double().cpu().numpy().T
    coarse = f32_matmul(q, e.T)
    exact = f32_matmul(q, e.T)
    return 8.0 * (_max_err(coarse, true) + _max_err(exact, true)) + 1e-7


@locked_cache
def binmax_eps(device: str, d: int, tile_n: int, bf16_in: bool) -> float:
    """Coarse error band calibrated through the port's own bin-max kernels
    (``binmax_eps`` in the JAX package): with ``n_valid = 128`` exactly one row
    is live per bin, so a kernel's bin maxima are its per-row scores, compared
    one to one with a float64 ground truth. Both kernels are read, since they
    sum in different orders (``dense_binmax2``, which the certified path's
    coarse scores come from, on the tensor cores in bf16): ``dense_binmax`` on
    64 queries and ``dense_binmax2`` on 128 queries of their own seeded draw,
    over the same rows. The larger reading plus the re-score error, with the
    same 8x margin and 1e-7 floor, is the band. Cached per (device, d, tile_n,
    bf16_in): two small launches per process."""
    q, e = _calibration_inputs(device, d, tile_n, bf16_in)
    live = torch.ones(tile_n, dtype=torch.bool, device=e.device)
    e128 = e[:128].double().cpu().numpy()
    bm = dense_binmax(q, e, 128, live, tile_n=tile_n)
    err = _max_err(bm[:, :128], q.double().cpu().numpy() @ e128.T)
    q2 = torch.from_numpy(_unit_rows(np.random.default_rng(1), 128, d)).to(e.device, e.dtype)
    bins2, _ = dense_binmax2(q2, e, 128, live, tile_n=tile_n)
    err = max(err, _max_err(bins2[0], q2.double().cpu().numpy() @ e128.T))
    refine = f32_matmul(q, e[:128].T)
    return 8.0 * (err + _max_err(refine, q.double().cpu().numpy() @ e128.T)) + 1e-7


def _flush_tiny(s: torch.Tensor, eps: float) -> torch.Tensor:
    """Flush |score| < eps to exact 0.0, so that the order among scores that
    are pure matmul noise is the (stable) index order on every batch shape."""
    return torch.where(s.abs() < eps, 0.0, s)


def _full_highest_topk(q: torch.Tensor, emb: torch.Tensor, mask: torch.Tensor,
                       k: int, flush_eps: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Certainly exact fallback: full float32 matmul and a flat top-k."""
    scores = f32_matmul(q, emb.T)
    if flush_eps:
        scores = _flush_tiny(scores, flush_eps)
    return stable_topk(torch.where(mask[None, :], scores, NEG_INF), k)


def refined_masked_topk_cert(q: torch.Tensor, emb: torch.Tensor,
                             mask: torch.Tensor, k: int, margin: int = 16,
                             flush_eps: float = 0.0, mask_trivial: bool = False,
                             emb_binpack: torch.Tensor | None = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase top-k with a per-query exactness certificate.

    Coarse scores select ``m = k + margin`` candidates, which are re-scored
    exactly. Every row outside the candidates has a coarse score at most the
    coarse bound (``c_m`` flat, ``c_out`` binned), so its exact score is at
    most bound + ``eps``; when the k-th exact candidate value exceeds that,
    the result is certified exact. The branches follow the JAX function's
    order.

    q: [B, D], emb: [N, D], mask: [N] bool.
    Returns (vals [B, k] f32, idx [B, k] int64, certified [B] bool).
    """
    n = emb.shape[0]
    on_gpu = emb.is_cuda
    m = min(k + margin, n)
    is_bf16 = emb.dtype == torch.bfloat16
    if is_bf16:
        # bf16 storage: q rounds to bf16 once, so that every stage scores the
        # same bf16 x bf16 products, which are exact in float32 accumulation
        q = q.to(torch.bfloat16)
    B = q.shape[0]
    if on_gpu and n % 1024 == 0 and n >= 4096:
        # streaming bin-max kernel and hierarchical exact bin selection
        outs = [binned_refined_topk(q[s:s + _CUDA_CHUNK].contiguous(), emb,
                                    mask, k, margin=margin, tile_n=1024,
                                    select="hier", mask_trivial=mask_trivial,
                                    emb_binpack=emb_binpack)
                for s in range(0, B, _CUDA_CHUNK)]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))
    if on_gpu and is_bf16 and n >= 4096 and B >= 256 and B * n * 4 <= (4 << 30):
        # bf16 storage at an N the kernel does not take: one float32 pass over
        # the bf16 operands is the exact score, so no certificate is needed
        vals, idx = _full_highest_topk(q, emb, mask, k, flush_eps=flush_eps)
        return vals, idx, torch.ones(B, dtype=torch.bool, device=emb.device)
    if on_gpu and n < 4096:
        # small corpus: the full float32 matmul is cheap
        vals, idx = _full_highest_topk(q, emb, mask, k, flush_eps=flush_eps)
        return vals, idx, torch.ones(B, dtype=torch.bool, device=emb.device)
    coarse = f32_matmul(q, emb.T)
    if flush_eps:
        coarse = _flush_tiny(coarse, flush_eps)
    coarse = torch.where(mask[None, :], coarse, NEG_INF)
    cvals, cand = stable_topk(coarse, m)                            # [B, m]
    exact = torch.bmm(emb[cand].float(), q.float()[:, :, None])[..., 0]
    if flush_eps:
        exact = _flush_tiny(exact, flush_eps)
    exact = torch.where(mask[cand], exact, NEG_INF)
    vals, pos = stable_topk(exact, min(k, m))
    idx = cand.gather(1, pos)
    if k > m:
        vals = torch.nn.functional.pad(vals, (0, k - m), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - m))
    if m >= n:
        # the coarse set is the whole corpus: every row was re-scored exactly
        return vals, idx, torch.ones(B, dtype=torch.bool, device=emb.device)
    eps = matmul_eps(emb.device.type, emb.shape[1], is_bf16)
    c_m = cvals[:, -1]
    # fewer than m valid rows: every valid row was re-scored exactly
    cert = (vals[:, min(k, m) - 1] > c_m + eps) | (c_m <= NEG_INF / 2)
    return vals, idx, cert


def refined_masked_topk(q: torch.Tensor, emb: torch.Tensor, mask: torch.Tensor,
                        k: int, margin: int = 16, certify: bool = True,
                        flush_eps: float = 0.0, mask_trivial: bool = False,
                        emb_binpack: torch.Tensor | None = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Certified exact top-k (see ``refined_masked_topk_cert``). When any
    query's certificate fails, the whole batch is recomputed by the full
    float32 pass; deciding that costs one host sync per batch.
    ``certify=False`` returns the certified branch's result as it is."""
    if emb.dtype == torch.bfloat16:
        # the fallback must score the same bf16-rounded q as the other stages
        q = q.to(torch.bfloat16)
    vals, idx, cert = refined_masked_topk_cert(q, emb, mask, k, margin=margin,
                                               flush_eps=flush_eps,
                                               mask_trivial=mask_trivial,
                                               emb_binpack=emb_binpack)
    if not certify or bool(cert.all()):
        return vals, idx
    return _full_highest_topk(q, emb, mask, k, flush_eps=flush_eps)


def binned_rows_of(bin_idx: torch.Tensor, tile_n: int) -> torch.Tensor:
    """Corpus rows covered by global bin ids ([..., m] -> [..., m, G])."""
    g = tile_n // 128
    tile = bin_idx // 128
    lane = bin_idx % 128
    return ((tile * tile_n + lane)[..., None]
            + 128 * torch.arange(g, device=bin_idx.device))


def binned_refined_topk(q: torch.Tensor, emb: torch.Tensor, mask: torch.Tensor,
                        k: int, margin: int = 16, tile_n: int = 4096,
                        select: str = "exact", mask_trivial: bool = False,
                        emb_binpack: torch.Tensor | None = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified top-k through the streaming bin-max kernel
    (``binned_refined_topk`` / ``_binned_refined_topk`` in the JAX package).

    Coarse: the top ``m = k + margin`` bins by bin max; their rows are
    re-scored exactly and the top k taken. Every row outside the selected
    bins scores at most ``c_out``, the m-th selected bin max, so its exact
    score is at most ``c_out + eps`` with ``eps`` from ``binmax_eps``.

    ``select``: "hier" selects tiles by their supermax first, then bins within
    the selected tiles (v2, through ``dense_binmax2``, when B % 128 == 0; v1
    through ``dense_binmax`` otherwise). "exact" takes a flat top-m over all
    bins. "approx" (``lax.approx_max_k`` on the TPU) is exact selection here,
    which keeps the free ``c_out`` bound sound.

    Hier soundness (every non-selected bin max <= c_out): a non-selected bin
    either lost within a gathered tile, so m gathered bins beat it, or its
    tile lost the tile top-m, so m tiles each contribute a bin that beats it.

    Returns (vals [B, k], idx [B, k] int64, certified [B] bool).
    """
    eps = binmax_eps(emb.device.type, emb.shape[1], tile_n,
                     emb.dtype == torch.bfloat16)
    B, n = q.shape[0], emb.shape[0]
    dev = emb.device
    if emb.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16)
    num_tiles = n // tile_n
    nbins = num_tiles * 128
    m = min(k + margin, nbins)
    lanes = torch.arange(128, device=dev)
    if select == "hier" and m < nbins and nbins > 2 * 128 and B % 128 == 0:
        # v2: the kernel emits each tile's supermax, and only the selected
        # tiles' bins are read back
        tile_bins, smax = dense_binmax2(q, emb, n, mask, tile_n=tile_n,
                                        trivial=mask_trivial)
        s_take = min(m, num_tiles)
        _, sb_idx = stable_topk(smax, s_take)                       # [B, s]
        sub = tile_bins[sb_idx, torch.arange(B, device=dev)[:, None]]  # [B, s, 128]
        sub = sub.reshape(B, s_take * 128)
        bins_of = (sb_idx[:, :, None] * 128 + lanes).reshape(B, -1)
        bm_vals, sub_pos = stable_topk(sub, m)
        bm_idx = bins_of.gather(1, sub_pos)
    elif select == "hier" and m < nbins and nbins > 2 * 128:
        # v1: superbins of 128 consecutive bins (one tile each) from the
        # query-major bin array
        binmax = dense_binmax(q, emb, n, mask, tile_n=tile_n)
        bm3 = binmax.reshape(B, num_tiles, 128)                     # [B, S, 128]
        s_take = min(m, num_tiles)
        _, sb_idx = stable_topk(bm3.amax(dim=2), s_take)            # [B, s]
        sub = bm3.gather(1, sb_idx[:, :, None].expand(-1, -1, 128))
        sub = sub.reshape(B, s_take * 128)
        bins_of = (sb_idx[:, :, None] * 128 + lanes).reshape(B, -1)
        bm_vals, sub_pos = stable_topk(sub, m)
        bm_idx = bins_of.gather(1, sub_pos)
    else:
        binmax = dense_binmax(q, emb, n, mask, tile_n=tile_n)
        bm_vals, bm_idx = stable_topk(binmax, m)                    # [B, m]
    rows = binned_rows_of(bm_idx, tile_n).reshape(B, -1)            # [B, m*G]
    if emb_binpack is not None and tile_n == 1024:
        # bin-contiguous copy of emb: one contiguous block per selected bin
        cand_emb = emb_binpack[bm_idx].reshape(B, -1, emb.shape[1])
    else:
        cand_emb = emb[rows]                                        # [B, m*G, D]
    exact = torch.bmm(cand_emb.float(), q.float()[:, :, None])[..., 0]
    exact = torch.where(mask[rows], exact, NEG_INF)
    kk = min(k, exact.shape[1])
    vals, pos = stable_topk(exact, kk)
    idx = rows.gather(1, pos)
    if k > kk:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - kk))
    if m >= nbins:
        # every bin selected: all rows re-scored exactly
        return vals, idx, torch.ones(B, dtype=torch.bool, device=dev)
    c_out = bm_vals[:, m - 1]
    cert = (vals[:, kk - 1] > c_out + eps) | (c_out <= NEG_INF / 2)
    return vals, idx, cert
