"""Streaming bin-max: the coarse stage of the certified top-k.

Counterparts of ``dense_binmax2_pallas`` and ``dense_binmax_pallas``
(``ahrag_tpu/ops/topk.py``). For each ``tile_n``-row corpus tile and each
query the scores ``q . emb[r]`` (float32 accumulation) are masked (rows at or
past ``n_valid``, or with ``mask`` false, score ``NEG_INF``) and reduced to 128
strided bins: bin ``j`` of tile ``t`` holds rows ``t * tile_n + j + 128 * i``.

Both kernels run bf16 products on the tensor cores (wgmma, TMA loads) and
float32 products as IEEE FMA on register tiles: ``dense_binmax2`` (the
hybrid-search path, B % 128 == 0) in chunks of 128 queries, ``dense_binmax``
(any B: the serving buckets and the eps calibration) in a chunk fitted to B,
so that a small batch streams the corpus once. Each is exact in its products,
so kernel and plain version differ only in summation order.

Each wrapper launches the hand-written CUDA kernel (``csrc/binmax.cu``) for a
CUDA tensor, counting the launch in its ``launches`` attribute (under a lock,
since serving threads launch concurrently), and takes the plain PyTorch
version (``*_ref``) only for a tensor on the CPU. There is no fallback from
the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ahrag_tpu_torch.device import f32_matmul
from ahrag_tpu_torch.ops._build import SMEM_LIMIT, count_launch, launch_args

NEG_INF = -1e30


def ring_smem_bytes(d: int, qc: int, is_bf16: bool, extra: int = 0) -> int:
    """Dynamic shared memory of a block on the TMA ring of ``csrc/common.cuh``
    (``RingSmem::bytes``) at query chunk ``qc``: 1 KB of alignment slack, 4
    stages of 128 corpus rows by one 128-byte box of d (16 KB; in float32 each
    stage also holds the chunk's box, qc rows of 128 bytes), in bf16 the
    resident chunk (qc rows of 128 bytes per 64 elements of d, rounded up),
    the kernel's own ``extra`` bytes and 9 barriers."""
    stage = 16384 + (0 if is_bf16 else qc * 128)
    resident = -(-d // 64) * qc * 128 if is_bf16 else 0
    return 1024 + 4 * stage + resident + extra + 9 * 8


def binmax2_chunk(d: int) -> int:
    """Queries per bf16 ``ahrag_binmax2`` block (``csrc/binmax.cu``): 128,
    or 32 where 128 of them do not fit in shared memory (d > 576)."""
    return 128 if ring_smem_bytes(d, 128, True, 8 * 128 * 4) <= SMEM_LIMIT else 32


def binmax2_smem_bytes(d: int, is_bf16: bool) -> int:
    """Dynamic shared memory of one ``ahrag_binmax2`` block: bf16 at the
    chunk ``binmax2_chunk`` picks, with the supermax exchange (8 x chunk
    float32); float32 at 128 queries, with the consumers' running maxima
    (256 threads x 64 float32)."""
    if is_bf16:
        qc = binmax2_chunk(d)
        return ring_smem_bytes(d, qc, True, 8 * qc * 4)
    return ring_smem_bytes(d, 128, False, 256 * 64 * 4)


_BINMAX_CHUNKS = (8, 16, 32, 64, 128)


def binmax_chunk(b: int, d: int, is_bf16: bool) -> int:
    """Queries per ``ahrag_binmax`` block (``csrc/binmax.cu``): the smallest
    of 8, 16, 32, 64 and 128 (float32: up to 64) that holds all b
    queries, else the largest; in bf16 halved while the resident chunk does
    not fit in shared memory, down to 8."""
    chunks = _BINMAX_CHUNKS if is_bf16 else _BINMAX_CHUNKS[:4]
    qc = next((c for c in chunks if c >= b), chunks[-1])
    while qc > 8 and ring_smem_bytes(d, qc, is_bf16) > SMEM_LIMIT:
        qc //= 2
    return qc


def _binmax_check(q: torch.Tensor, emb: torch.Tensor) -> int:
    """The shapes ``ahrag_binmax`` takes beyond ``_check``'s, checked
    before anything launches (ValueError); returns the query chunk."""
    B, D = q.shape
    is_bf16 = emb.dtype == torch.bfloat16
    if D % 8:
        raise ValueError(f"dense_binmax takes D % 8 == 0, got D={D}")
    qc = binmax_chunk(B, D, is_bf16)
    if ring_smem_bytes(D, qc, is_bf16) > SMEM_LIMIT:
        raise ValueError(f"dense_binmax at D={D} needs "
                         f"{ring_smem_bytes(D, qc, is_bf16)} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block has")
    return qc


def _binmax2_check(q: torch.Tensor, emb: torch.Tensor) -> None:
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
                     mask: torch.Tensor, tile_n: int = 4096) -> torch.Tensor:
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
    _binmax2_check(q, emb)
    B, N = q.shape[0], emb.shape[0]
    lib, is_bf16, stream = launch_args(q, emb, mask)
    bins = torch.empty((N // tile_n, B, 128), dtype=torch.float32, device=emb.device)
    smax = torch.empty((B, N // tile_n), dtype=torch.float32, device=emb.device)
    rc = lib.ahrag_binmax2(q.data_ptr(), emb.data_ptr(), mask.data_ptr(),
                           int(n_valid), B, N, q.shape[1], tile_n, is_bf16,
                           int(trivial), bins.data_ptr(), smax.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ahrag_binmax2 launch failed: cudaError {rc}")
    count_launch(dense_binmax2)
    return bins, smax


def dense_binmax(q: torch.Tensor, emb: torch.Tensor, n_valid: int,
                 mask: torch.Tensor, tile_n: int = 4096) -> torch.Tensor:
    """Bin maxima in query-major layout: ``[B, D] x [N, D] -> [B, N/G]``
    float32 with G = tile_n / 128 rows per bin (the default tile is
    ``dense_binmax_pallas``'s). Any B; the kernel takes D % 8 == 0 and, in
    bf16, the resident query chunk within shared memory (``binmax_chunk``)."""
    _check(q, emb, mask, tile_n)
    if emb.device.type == "cpu":
        return dense_binmax_ref(q, emb, n_valid, mask, tile_n)
    qc = _binmax_check(q, emb)
    B, N = q.shape[0], emb.shape[0]
    out = torch.empty((B, N // tile_n * 128), dtype=torch.float32, device=emb.device)
    if out.numel() == 0:
        return out
    lib, is_bf16, stream = launch_args(q, emb, mask)
    rc = lib.ahrag_binmax(q.data_ptr(), emb.data_ptr(), mask.data_ptr(),
                          int(n_valid), B, N, q.shape[1], tile_n, qc, is_bf16,
                          out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ahrag_binmax launch failed: cudaError {rc}")
    count_launch(dense_binmax)
    return out


dense_binmax2.launches = 0
dense_binmax.launches = 0
