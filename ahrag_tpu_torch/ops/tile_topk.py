"""Fused score + per-tile top-k: flat exact retrieval in one pass over the corpus.

Counterpart of ``dense_topk_pallas`` / ``_tile_topk_kernel``
(``ahrag_tpu/ops/topk.py``). For each ``tile_n``-row corpus tile and each query
the scores ``q . emb[r]`` (float32 accumulation) are masked (rows at or past
``n_valid``, or with ``mask`` false, score ``NEG_INF``) and reduced to the tile's
top ``kk = min(k, tile_n)`` by ``kk`` passes of max / lowest arg-max / set to
``NEG_INF``. Once a tile's eligible rows are used up, every later pass returns
``(NEG_INF, t * tile_n)``: column 0 again, as ``jnp.argmax`` does over a row of
equal values. A stable top-k over the candidates in tile order then merges the
tiles, so ties resolve to the lowest row.

The kernel scores a 32-query chunk against each tile into a score tile in
shared memory, bf16 products on the tensor cores (wgmma, fed by TMA) and
float32 ones as IEEE FMA on register tiles, and then runs the selection
passes over it.
``tile_topk`` launches the hand-written CUDA kernel (``csrc/tile_topk.cu``) for
a CUDA tensor, counting the launch in its ``launches`` attribute (under a
lock), and takes the plain PyTorch version (``dense_topk_fused_ref``) only for
a tensor on the CPU.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ahrag_tpu_torch.device import f32_matmul, stable_topk
from ahrag_tpu_torch.ops._build import SMEM_LIMIT, count_launch, launch_args
from ahrag_tpu_torch.ops.binmax import NEG_INF, ring_smem_bytes


def _smem(d: int, tile_n: int, is_bf16: bool, qc: int) -> int:
    """An ``ahrag_tile_topk`` block at query chunk ``qc``: the ring's bytes
    with the [qc, tile_n + 4] float32 score tile as the kernel's own area."""
    return ring_smem_bytes(d, qc, is_bf16, qc * (tile_n + 4) * 4)


def tile_topk_chunk(d: int, tile_n: int, is_bf16: bool) -> int:
    """Queries per ``ahrag_tile_topk`` block (``csrc/tile_topk.cu``): 32, or
    16 where the shared memory of 32 does not suffice."""
    return 32 if _smem(d, tile_n, is_bf16, 32) <= SMEM_LIMIT else 16


def tile_topk_smem_bytes(d: int, tile_n: int, is_bf16: bool) -> int:
    """Dynamic shared memory of one ``ahrag_tile_topk`` block at the chunk
    ``tile_topk_chunk`` picks."""
    return _smem(d, tile_n, is_bf16, tile_topk_chunk(d, tile_n, is_bf16))


def _kernel_check(q: torch.Tensor, emb: torch.Tensor, tile_n: int) -> None:
    """The shared-memory rule of ``ahrag_tile_topk`` beyond ``_check``'s:
    raises ValueError before anything launches."""
    D = emb.shape[1]
    is_bf16 = emb.dtype == torch.bfloat16
    if tile_topk_smem_bytes(D, tile_n, is_bf16) > SMEM_LIMIT:
        raise ValueError(f"tile_n={tile_n} at D={D} needs "
                         f"{tile_topk_smem_bytes(D, tile_n, is_bf16)} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} a block has")


def _check(q: torch.Tensor, emb: torch.Tensor, k: int, tile_n: int,
           mask: torch.Tensor | None) -> None:
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and emb {tuple(emb.shape)} must be "
                         "[B, D] and [N, D]")
    if tile_n % 128 or emb.shape[0] % tile_n or emb.shape[0] == 0:
        raise ValueError(f"N={emb.shape[0]} must be a positive multiple of "
                         f"tile_n={tile_n}, itself a multiple of 128")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if mask is not None and (mask.shape != (emb.shape[0],) or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool [N] tensor")
    if q.dtype != emb.dtype or emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q ({q.dtype}) and emb ({emb.dtype}) must share one "
                        "type, float32 or bfloat16")
    if q.device != emb.device or (mask is not None and mask.device != emb.device):
        raise ValueError("q, emb and mask must lie on one device")


def dense_topk_fused_ref(q: torch.Tensor, emb: torch.Tensor, n_valid: int, k: int,
                         tile_n: int = 1024, mask: torch.Tensor | None = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-tile stage: float32 matmul, ``where``, reshape to
    [B, T, tile_n] and ``kk`` explicit max / lowest arg-max / set-to-``NEG_INF``
    passes (not a sort, which would not repeat column 0 past the eligible rows).
    Returns (vals [T, B, kk] float32, idx [T, B, kk] int32 global rows)."""
    B, N = q.shape[0], emb.shape[0]
    t, kk = N // tile_n, min(k, tile_n)
    row = torch.arange(N, device=emb.device)
    ok = row < n_valid
    if mask is not None:
        ok = ok & mask
    s = torch.where(ok[None, :], f32_matmul(q, emb.T), NEG_INF).reshape(B, t, tile_n)
    col = torch.arange(tile_n, device=emb.device)
    vals, cols = [], []
    for _ in range(kk):
        best, arg = s.max(dim=2, keepdim=True)
        # lowest column among equal maxima, whatever max's own choice
        arg = torch.where(s == best, col, tile_n).amin(dim=2, keepdim=True)
        vals.append(best)
        cols.append(arg)
        s = torch.where(col == arg, NEG_INF, s)
    base = (torch.arange(t, device=emb.device) * tile_n)[None, :, None]
    v = torch.cat(vals, dim=2).permute(1, 0, 2).contiguous()
    i = (torch.cat(cols, dim=2) + base).to(torch.int32).permute(1, 0, 2).contiguous()
    return v, i


def tile_topk(q: torch.Tensor, emb: torch.Tensor, n_valid: int, k: int,
              tile_n: int = 1024, mask: torch.Tensor | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile top-k: ``[B, D] x [N, D] -> (vals [T, B, kk] float32,
    idx [T, B, kk] int32)`` with T = N / tile_n and kk = min(k, tile_n)."""
    _check(q, emb, k, tile_n, mask)
    if emb.device.type == "cpu":
        return dense_topk_fused_ref(q, emb, n_valid, k, tile_n, mask)
    _kernel_check(q, emb, tile_n)
    B, N, D = q.shape[0], emb.shape[0], q.shape[1]
    kk = min(k, tile_n)
    lib, is_bf16, stream = launch_args(q, emb, mask)
    vals = torch.empty((N // tile_n, B, kk), dtype=torch.float32, device=emb.device)
    idx = torch.empty((N // tile_n, B, kk), dtype=torch.int32, device=emb.device)
    if B == 0:
        return vals, idx
    rc = lib.ahrag_tile_topk(
        q.data_ptr(), emb.data_ptr(), None if mask is None else mask.data_ptr(),
        int(n_valid), B, N, D, tile_n, kk, is_bf16, vals.data_ptr(), idx.data_ptr(),
        stream)
    if rc:
        raise RuntimeError(f"ahrag_tile_topk launch failed: cudaError {rc}")
    count_launch(tile_topk)
    return vals, idx


def merge_tiles(tile_vals: torch.Tensor, tile_idx: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final merge of ``dense_topk_pallas``: the [B, T * kk] candidates in
    tile order, a stable top-k (ties keep the lower row), a gather of the ids,
    and ``NEG_INF`` / id 0 padding when k exceeds the candidates. Returns
    (vals [B, k] float32, idx [B, k] int64)."""
    t, B, kk = tile_vals.shape
    cand_vals = tile_vals.permute(1, 0, 2).reshape(B, t * kk)
    cand_idx = tile_idx.permute(1, 0, 2).reshape(B, t * kk).long()
    vals, pos = stable_topk(cand_vals, min(k, t * kk))
    idx = cand_idx.gather(1, pos)
    if k > t * kk:
        vals = torch.nn.functional.pad(vals, (0, k - t * kk), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - t * kk))
    return vals, idx


def dense_topk_fused(q: torch.Tensor, emb: torch.Tensor, n_valid: int, k: int,
                     tile_n: int = 1024, mask: torch.Tensor | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by the fused per-tile kernel and a merge in tile order
    (``dense_topk_pallas``). q [B, D] and emb [N, D] share one type, float32
    or bfloat16; ``mask`` (bool [N], optional) further restricts the rows.
    Returns (vals [B, k] float32, idx [B, k] int64)."""
    return merge_tiles(*tile_topk(q, emb, n_valid, k, tile_n, mask), k)


tile_topk.launches = 0
