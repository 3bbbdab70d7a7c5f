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
so kernel and plain version differ only in summation order. Where the (query
chunk, tile) items are too few to fill the card's SMs, as on the graphs of a
few thousand rows that answers search, the launch plan (``binmax_plan``,
``binmax2_plan``) splits each item's slices among a cluster of blocks, whose
partial bin maxima the kernel merges exactly.

Each wrapper launches the hand-written CUDA kernel (``csrc/binmax.cu``) for a
CUDA tensor, counting the launch in its ``launches`` attribute (under a lock,
since serving threads launch concurrently), and takes the plain PyTorch
version (``*_ref``) only for a tensor on the CPU. There is no fallback from
the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ahrag_tpu_torch.device import f32_matmul
from ahrag_tpu_torch.ops._build import SMEM_LIMIT, count_launch, launch_args, load_library

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
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


@functools.lru_cache(maxsize=None)
def binmax2_chunk(d: int) -> int:
    """Queries per bf16 ``ahrag_binmax2`` block (``csrc/binmax.cu``): 128,
    or 32 where 128 of them do not fit in shared memory (d > 576)."""
    return 128 if ring_smem_bytes(d, 128, True, 8 * 128 * 4) <= SMEM_LIMIT else 32


@functools.lru_cache(maxsize=None)
def binmax2_smem_bytes(d: int, is_bf16: bool, qc: int = 128) -> int:
    """Dynamic shared memory of one ``ahrag_binmax2`` block: bf16 at the
    chunk ``binmax2_chunk`` picks, with the supermax exchange (8 x chunk
    float32); float32 at ``qc`` queries (128, or 96 or 64 in a split), with the
    consumers' running maxima (256 threads x 8 rows x qc / 16 float32)."""
    if is_bf16:
        qc = binmax2_chunk(d)
        return ring_smem_bytes(d, qc, True, 8 * qc * 4)
    return ring_smem_bytes(d, qc, False, 256 * 8 * (qc // 16) * 4)


_BINMAX_CHUNKS = (8, 16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
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


# Blocks that may share one (query chunk, tile) item: a thread-block cluster
# of at most 8, the size every Hopper part schedules.
SPLITS = (1, 2, 4, 8)


class Plan(NamedTuple):
    """A bin-max launch: queries per block, blocks per (query chunk, tile)
    item, and the blocks launched."""
    qc: int
    split: int
    grid: int


def ring_grid(chunks: int, tiles: int, split: int, stream_q: bool, sms: int) -> int:
    """Blocks of a launch on the TMA ring of ``csrc/common.cuh``, whose
    ``launch_ring`` takes this grid and checks it. With a split, one cluster of
    ``split`` blocks an item. At split 1 the persistent grid, one block per SM
    and at most one an item; with resident queries (bf16, ``stream_q`` false)
    a multiple of the chunks, at least one a chunk, so that a block's chunk
    stays fixed while it walks the tiles."""
    if split > 1:
        return chunks * tiles * split
    if stream_q:
        return min(sms, chunks * tiles)
    return chunks * min(max(sms // chunks, 1), tiles)


def split_for(items: int, slices: int, slots: Tuple[int, ...]) -> int:
    """Blocks per (query chunk, tile) item (``csrc/binmax.cu``): the largest
    split S of ``SPLITS`` that divides the tile's ``slices`` (128-row groups)
    and keeps the items within one wave, that is at most ``slots[i]``
    clusters of S = ``SPLITS[i]`` (``device_slots``). A larger S would add a
    wave for every halving of the slices a block walks, and gain nothing. 1
    where even 2 do not fit, as where the items fill the SMs."""
    return max(s for s, n in zip(SPLITS, slots)
               if slices % s == 0 and (s == 1 or items <= n))


@functools.lru_cache(maxsize=None)
def binmax_plan(b: int, n: int, d: int, tile_n: int, is_bf16: bool,
                slots: Tuple[int, ...]) -> Plan:
    """``ahrag_binmax``'s launch plan for q [b, d] over n rows on a card with
    the cluster ``slots`` of ``device_slots``: the chunk ``binmax_chunk``, the
    split ``split_for`` and the grid ``ring_grid``."""
    qc = binmax_chunk(b, d, is_bf16)
    chunks, tiles = -(-b // qc), n // tile_n
    split = split_for(chunks * tiles, tile_n // 128, slots)
    return Plan(qc, split, ring_grid(chunks, tiles, split, not is_bf16, slots[0]))


@functools.lru_cache(maxsize=None)
def binmax2_plan(b: int, n: int, d: int, tile_n: int, is_bf16: bool,
                 slots: Tuple[int, ...]) -> Plan:
    """``ahrag_binmax2``'s launch plan. The chunk is ``binmax2_chunk`` in
    bf16. In float32 it is 128, or in a split 96 or 64 where that gives a
    block less work by count (the slices it walks times its queries; the
    persistent grid's waves at split 1), ties to the wider chunk: at B 256
    over 5 tiles 120 blocks of 96 queries instead of 80 of 128, at B 128 80
    blocks of 64 instead of 40 of 128, where the card runs 15 clusters of 8
    at once."""
    tiles, slices, sms = n // tile_n, tile_n // 128, slots[0]

    def plan(qc: int) -> tuple[int, Plan]:
        """(a block's work by count, plan) at chunk qc."""
        chunks = -(-b // qc)
        split = split_for(chunks * tiles, slices, slots)
        work = (-(-chunks * tiles // sms) if split == 1 else 1) * slices // split * qc
        return work, Plan(qc, split, ring_grid(chunks, tiles, split, not is_bf16, sms))

    if is_bf16:
        return plan(binmax2_chunk(d))[1]
    work, best = plan(128)
    for narrow in (96, 64):
        w, p = plan(narrow)
        if p.split > 1 and w < work:
            work, best = w, p
    return best


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def device_slots(index: int) -> Tuple[int, ...]:
    """Clusters of each split of ``SPLITS`` that CUDA device ``index`` runs
    at once, one block per SM: its SMs, then ``ahrag_cluster_slots`` (the
    occupancy API's count for clusters of 2, 4 and 8, which stay within one
    GPC and so may fall short of SMs / split). Raises if the query fails."""
    lib = load_library()
    slots = [device_sms(index)]
    with torch.cuda.device(index):
        for split in SPLITS[1:]:
            n = ctypes.c_int(0)
            rc = lib.ahrag_cluster_slots(split, ctypes.byref(n))
            if rc:
                raise RuntimeError(f"ahrag_cluster_slots({split}) failed: cudaError {rc}")
            slots.append(n.value)
    return tuple(slots)


def _binmax_check(q: torch.Tensor, emb: torch.Tensor) -> None:
    """The shapes ``ahrag_binmax`` takes beyond ``_check``'s: raises
    ValueError before anything launches."""
    B, D = q.shape
    is_bf16 = emb.dtype == torch.bfloat16
    if D % 8:
        raise ValueError(f"dense_binmax takes D % 8 == 0, got D={D}")
    qc = binmax_chunk(B, D, is_bf16)
    if ring_smem_bytes(D, qc, is_bf16) > SMEM_LIMIT:
        raise ValueError(f"dense_binmax at D={D} needs "
                         f"{ring_smem_bytes(D, qc, is_bf16)} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block has")


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
    plan = binmax2_plan(B, N, q.shape[1], tile_n, bool(is_bf16),
                        device_slots(emb.device.index))
    bins = torch.empty((N // tile_n, B, 128), dtype=torch.float32, device=emb.device)
    smax = torch.empty((B, N // tile_n), dtype=torch.float32, device=emb.device)
    rc = lib.ahrag_binmax2(q.data_ptr(), emb.data_ptr(), mask.data_ptr(),
                           int(n_valid), B, N, q.shape[1], tile_n, *plan, is_bf16,
                           int(trivial), bins.data_ptr(), smax.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ahrag_binmax2 launch failed: cudaError {rc}")
    count_launch(dense_binmax2, plan)
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
    _binmax_check(q, emb)
    B, N = q.shape[0], emb.shape[0]
    out = torch.empty((B, N // tile_n * 128), dtype=torch.float32, device=emb.device)
    if out.numel() == 0:
        return out
    lib, is_bf16, stream = launch_args(q, emb, mask)
    plan = binmax_plan(B, N, q.shape[1], tile_n, bool(is_bf16),
                       device_slots(emb.device.index))
    rc = lib.ahrag_binmax(q.data_ptr(), emb.data_ptr(), mask.data_ptr(),
                          int(n_valid), B, N, q.shape[1], tile_n, *plan, is_bf16,
                          out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"ahrag_binmax launch failed: cudaError {rc}")
    count_launch(dense_binmax, plan)
    return out


dense_binmax2.launches = 0
dense_binmax.launches = 0
dense_binmax2.last_plan = None
dense_binmax.last_plan = None
