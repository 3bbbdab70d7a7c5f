"""Streaming bin-max: the coarse stage of the certified top-k.

Counterparts of ``dense_binmax2_pallas`` and ``dense_binmax_pallas``
(``ahrag_tpu/ops/topk.py``). For each ``tile_n``-row corpus tile and each
query the scores ``q . emb[r]`` (float32 accumulation) are masked (rows at or
past ``n_valid``, or with ``mask`` false, score ``NEG_INF``) and reduced to 128
strided bins: bin ``j`` of tile ``t`` holds rows ``t * tile_n + j + 128 * i``.

``dense_binmax2`` (the hybrid-search path) runs bf16 products on the tensor
cores (wgmma, TMA loads) and float32 products as IEEE FMA on register tiles;
``dense_binmax`` runs float32 FMA on widened operands. Each is exact in its
products, so kernel and plain version differ only in summation order.

Each wrapper launches the hand-written CUDA kernel (``csrc/binmax.cu``) for a
CUDA tensor, counting the launch in its ``launches`` attribute, and takes the
plain PyTorch version (``*_ref``) only for a tensor on the CPU. There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ahrag_tpu_torch.device import f32_matmul
from ahrag_tpu_torch.ops._build import SMEM_LIMIT, launch_args

NEG_INF = -1e30


def _bf16_smem(d: int, qc: int) -> int:
    """A bf16 ``ahrag_binmax2`` block at query chunk ``qc``: 1 KB of alignment
    slack, a 4-stage ring of 16 KB, the resident chunk (qc rows of 128 bytes
    per 64 elements of d, rounded up), the supermax exchange (8 * qc float32)
    and 9 barriers."""
    return 1024 + 4 * 16384 + -(-d // 64) * qc * 128 + 8 * qc * 4 + 9 * 8


def binmax2_chunk(d: int) -> int:
    """Queries per bf16 ``ahrag_binmax2`` block (``csrc/binmax.cu``): 128,
    or 32 where 128 of them do not fit in shared memory (d > 576)."""
    return 128 if _bf16_smem(d, 128) <= SMEM_LIMIT else 32


def binmax2_smem_bytes(d: int, is_bf16: bool) -> int:
    """Dynamic shared memory of one ``ahrag_binmax2`` block: bf16 at the
    chunk ``binmax2_chunk`` picks; float32 a 4-stage ring whose 32 KB stages
    hold 128 corpus rows and the 128 queries of one 128-byte box of d, the
    consumers' running maxima (256 threads x 64 float32), 9 barriers and 1 KB
    of alignment slack, whatever d."""
    if is_bf16:
        return _bf16_smem(d, binmax2_chunk(d))
    return 1024 + 4 * (16384 + 128 * 128) + 256 * 64 * 4 + 9 * 8


def _kernel_check(q: torch.Tensor, emb: torch.Tensor) -> None:
    """The shapes ``ahrag_binmax2`` takes beyond ``_check``'s: raises
    ValueError before anything launches."""
    B, D = q.shape
    is_bf16 = emb.dtype == torch.bfloat16
    if B == 0 or B % 128:
        raise ValueError(f"dense_binmax2 takes B % 128 == 0, got B={B}")
    if binmax2_smem_bytes(D, is_bf16) > SMEM_LIMIT:
        raise ValueError(f"dense_binmax2 at D={D} needs "
                         f"{binmax2_smem_bytes(D, is_bf16)} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block has")


def _check(q: torch.Tensor, emb: torch.Tensor, mask: torch.Tensor,
           tile_n: int) -> None:
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and emb {tuple(emb.shape)} must be "
                         "[B, D] and [N, D]")
    if tile_n % 128 or emb.shape[0] % tile_n:
        raise ValueError(f"N={emb.shape[0]} must be a multiple of tile_n={tile_n}, "
                         "itself a multiple of 128")
    if mask.shape != (emb.shape[0],) or mask.dtype != torch.bool:
        raise ValueError("mask must be a bool [N] tensor")
    if q.dtype != emb.dtype or emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q ({q.dtype}) and emb ({emb.dtype}) must share one "
                        "type, float32 or bfloat16")
    if not (q.device == emb.device == mask.device):
        raise ValueError("q, emb and mask must lie on one device")


def _scores_ref(q, emb, n_valid, mask, trivial):
    s = f32_matmul(q, emb.T)                                   # [B, N]
    if not trivial:
        row = torch.arange(emb.shape[0], device=emb.device)
        s = torch.where(((row < n_valid) & mask)[None, :], s, NEG_INF)
    return s


def dense_binmax2_ref(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
                      mask: torch.Tensor, tile_n: int = 1024,
                      trivial: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``dense_binmax2``: float32 matmul, ``where``, reshape
    to [B, T, G, 128] and ``amax`` over the G rows of each bin."""
    B, N = q.shape[0], emb.shape[0]
    t = N // tile_n
    bins = _scores_ref(q, emb, n_valid, mask, trivial).reshape(
        B, t, tile_n // 128, 128).amax(dim=2)                  # [B, T, 128]
    return bins.permute(1, 0, 2).contiguous(), bins.amax(dim=2)


def dense_binmax_ref(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
                     mask: torch.Tensor, tile_n: int = 1024) -> torch.Tensor:
    """Plain version of ``dense_binmax``."""
    B, N = q.shape[0], emb.shape[0]
    return _scores_ref(q, emb, n_valid, mask, False).reshape(
        B, N // tile_n, tile_n // 128, 128).amax(dim=2).reshape(B, -1)


def dense_binmax2(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
                  mask: torch.Tensor, tile_n: int = 1024,
                  trivial: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin maxima plus each tile's supermax: ``[B, D] x [N, D] ->
    (bins [N/tile_n, B, 128], supermax [B, N/tile_n])``, both float32.

    ``trivial`` skips the masking; it is sound only when every masked-out row
    has a zero embedding (see ``GraphTensors.mask_trivial``). The kernel
    takes B % 128 == 0, as the TPU kernel did, and D % 8 == 0 (in bf16 at
    most 2560, the resident query chunk)."""
    _check(q, emb, mask, tile_n)
    if emb.device.type == "cpu":
        return dense_binmax2_ref(q, emb, n_valid, mask, tile_n, trivial)
    _kernel_check(q, emb)
    B, N = q.shape[0], emb.shape[0]
    lib, is_bf16, stream = launch_args(q, emb, mask)
    bins = torch.empty((N // tile_n, B, 128), dtype=torch.float32, device=emb.device)
    smax = torch.empty((B, N // tile_n), dtype=torch.float32, device=emb.device)
    rc = lib.ahrag_binmax2(q.data_ptr(), emb.data_ptr(), mask.data_ptr(),
                           int(n_valid), B, N, q.shape[1], tile_n, is_bf16,
                           int(trivial), bins.data_ptr(), smax.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ahrag_binmax2 launch failed: cudaError {rc}")
    dense_binmax2.launches += 1
    return bins, smax


def dense_binmax(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
                 mask: torch.Tensor, tile_n: int = 1024) -> torch.Tensor:
    """Bin maxima in query-major layout: ``[B, D] x [N, D] -> [B, N/G]``
    float32 with G = tile_n / 128 rows per bin. Any B."""
    _check(q, emb, mask, tile_n)
    if emb.device.type == "cpu":
        return dense_binmax_ref(q, emb, n_valid, mask, tile_n)
    B, N = q.shape[0], emb.shape[0]
    if N // tile_n > 65535:
        raise ValueError("at most 65535 tiles per launch")
    out = torch.empty((B, N // tile_n * 128), dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    lib, is_bf16, stream = launch_args(q, emb, mask)
    rc = lib.ahrag_binmax(q.data_ptr(), emb.data_ptr(), mask.data_ptr(),
                          int(n_valid), B, N, q.shape[1], tile_n, is_bf16,
                          out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ahrag_binmax launch failed: cudaError {rc}")
    dense_binmax.launches += 1
    return out


dense_binmax2.launches = 0
dense_binmax.launches = 0
