"""GraphTensors: the hierarchical graph compiled to padded device tensors.

Port of ``ahrag_tpu/graph/tensors.py``: the same fields, padding and tables,
held as torch tensors on one device.

- ``emb [N_pad, D]`` row-normalised embeddings (the vector index), float32 or
  bf16 storage;
- per-node scalars ``node_type`` (0 entity / 1 summary / 2 hyperedge, -1 pad),
  ``level``, ``judge``/``has_judge``, ``conf``/``has_conf``, ``indexed``,
  ``valid``;
- ELL adjacency ``[N_pad, K]`` int32, -1 padded, one table per typed
  direction (``parents``, ``children``, ``related``, ``hyperedges``,
  ``members``), neighbours in edge insertion order.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device

NODE_TYPE_IDS = {"entity": 0, "summary": 1, "hyperedge": 2}

# Query-similar member expansion scans at most this many leading children per
# summary seed; the packed child tables cap at the same width.
MEMBER_SIM_CAP = 32


def round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclass(frozen=True)
class GraphTensors:
    emb: torch.Tensor            # [N_pad, D] float32 or bfloat16
    node_type: torch.Tensor      # [N_pad] int32 (-1 invalid)
    level: torch.Tensor          # [N_pad] int32
    judge: torch.Tensor          # [N_pad] float32
    has_judge: torch.Tensor      # [N_pad] bool
    conf: torch.Tensor           # [N_pad] float32
    has_conf: torch.Tensor       # [N_pad] bool
    indexed: torch.Tensor        # [N_pad] bool
    valid: torch.Tensor          # [N_pad] bool
    parents: torch.Tensor        # [N_pad, K_par] int32
    children: torch.Tensor       # [N_pad, K_child] int32
    related: torch.Tensor        # [N_pad, K_rel] int32
    hyperedges: torch.Tensor     # [N_pad, K_hedge] int32
    members: torch.Tensor        # [N_pad, K_mem] int32
    # Packed member-expansion tables: one contiguous row of each node's first
    # MEMBER_SIM_CAP children's embeddings (copies of ``emb`` rows, so member
    # scores are bit-identical to the unpacked path). None on small graphs.
    child_pack_slot: torch.Tensor | None = None   # [N_pad] int32 (-1 = no row)
    child_pack_ids: torch.Tensor | None = None    # [S, cap] int32, -1 padded
    child_pack_emb: torch.Tensor | None = None    # [S, cap, D] emb dtype
    # bin-contiguous permutation of emb for the binned seed stage's candidate
    # gather (tile_n = 1024 layout); built only where the CUDA kernel runs
    emb_binpack: torch.Tensor | None = None       # [nbins, 8, D] emb dtype
    n_nodes: int = 0
    n_edges: int = 0
    # True iff every real node is indexed: the masked-out rows are then
    # exactly the zero-embedding pad rows, and the seed kernel may skip its
    # masking (ops/binmax.py ``dense_binmax2(trivial=True)``)
    mask_trivial: bool = False

    @property
    def n_pad(self) -> int:
        return int(self.emb.shape[0])

    @property
    def dim(self) -> int:
        return int(self.emb.shape[1])

    @property
    def device(self) -> torch.device:
        return self.emb.device


def _ell(adj, n_pad: int, min_k: int = 8) -> np.ndarray:
    """ELL table [n_pad, K] (-1 padded, K a multiple of 8 and >= ``min_k``)
    from pre-built rows ``[N, K]`` or a dict ``node -> neighbours``."""
    if isinstance(adj, np.ndarray):
        kk = max(min_k, round_up(adj.shape[1] if adj.ndim == 2 else 1, 8))
        out = np.full((n_pad, kk), -1, dtype=np.int32)
        if adj.size:
            out[: adj.shape[0], : adj.shape[1]] = adj
        return out
    k = max(round_up(max([len(v) for v in adj.values()], default=1), 8), min_k)
    out = np.full((n_pad, k), -1, dtype=np.int32)
    for i, nbrs in adj.items():
        out[i, : len(nbrs)] = nbrs[:k]
    return out


def wants_binpack(dev: torch.device, n: int, n_pad: int) -> bool:
    """Whether ``build_graph_tensors`` builds ``emb_binpack``: where the binned
    seed stage runs its kernel (the card, as the TPU in the JAX package) at
    tile_n 1024 on 65,536 nodes or more, unless ``AHRAG_BINPACK=0``."""
    return (dev.type == "cuda" and n_pad % 1024 == 0 and n >= 65536
            and os.environ.get("AHRAG_BINPACK", "1") != "0")


def build_graph_tensors(
    *,
    embeddings: np.ndarray,                 # [N, D] normalized
    node_types: Sequence[int],
    levels: Sequence[int],
    judges: Sequence[float | None],
    confs: Sequence[float | None],
    indexed: Sequence[bool],
    parents: Dict[int, List[int]] | np.ndarray,
    children: Dict[int, List[int]] | np.ndarray,
    related: Dict[int, List[int]] | np.ndarray,
    hyperedges: Dict[int, List[int]] | np.ndarray,
    members: Dict[int, List[int]] | np.ndarray,
    n_edges: int = 0,
    emb_dtype: str | None = None,
    pack_children: bool | None = None,
    device: str | torch.device | None = None,
) -> GraphTensors:
    """Assemble device tensors from host-side (integer-indexed) graph data.

    ``emb_dtype`` ("float32" or "bfloat16") is the embedding matrix's storage
    type; when it is None, ``AHRAG_EMB_DTYPE`` chooses, float32 by default.
    Scores over bf16 storage are exact with respect to the rounded corpus.
    ``judges``/``confs`` are sequences with None for "no value", or float
    arrays with NaN. ``pack_children`` defaults to on for n >= 4096 unless
    ``AHRAG_PACK_CHILDREN=0``; ``AHRAG_BINPACK=0`` drops ``emb_binpack``.
    These are the JAX package's switches, read at the same points.
    ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    emb_dtype = emb_dtype or os.environ.get("AHRAG_EMB_DTYPE", "float32")
    n = len(node_types)
    if embeddings.shape[0] != n:
        raise ValueError(f"{embeddings.shape[0]} embeddings for {n} nodes")
    # padding ladder: 2048 from 65536 rows, 1024 from 4096 (the bin-max
    # kernel's tile), else the 128-row lane tile
    if n >= 65536:
        n_pad = round_up(n, 2048)
    elif n >= 4096:
        n_pad = round_up(n, 1024)
    else:
        n_pad = round_up(n, 128)
    d = embeddings.shape[1]

    emb = np.zeros((n_pad, d), dtype=np.float32)
    emb[:n] = embeddings
    nt = np.full(n_pad, -1, dtype=np.int32)
    nt[:n] = np.asarray(node_types, dtype=np.int32)
    lv = np.zeros(n_pad, dtype=np.int32)
    lv[:n] = np.asarray(levels, dtype=np.int32)
    jd = np.zeros(n_pad, dtype=np.float32)
    hj = np.zeros(n_pad, dtype=bool)
    cf = np.zeros(n_pad, dtype=np.float32)
    hc = np.zeros(n_pad, dtype=bool)
    if isinstance(judges, np.ndarray) and isinstance(confs, np.ndarray):
        hj[:n] = ~np.isnan(judges)
        jd[:n] = np.where(hj[:n], np.nan_to_num(judges), 0.0)
        hc[:n] = ~np.isnan(confs)
        cf[:n] = np.where(hc[:n], np.nan_to_num(confs), 0.0)
    else:
        for i in range(n):
            if judges[i] is not None:
                jd[i], hj[i] = float(judges[i]), True
            if confs[i] is not None:
                cf[i], hc[i] = float(confs[i]), True
    ix = np.zeros(n_pad, dtype=bool)
    ix[:n] = np.asarray(indexed, dtype=bool)
    vd = np.zeros(n_pad, dtype=bool)
    vd[:n] = True

    store_dtype = torch.bfloat16 if emb_dtype == "bfloat16" else torch.float32
    ch_ell = _ell(children, n_pad)
    if pack_children is None:
        pack_children = n >= 4096 and os.environ.get("AHRAG_PACK_CHILDREN", "1") != "0"
    pack_nodes = (np.nonzero(ch_ell[:, 0] >= 0)[0] if pack_children
                  else np.zeros(0, np.int64))

    def up(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(dev)

    emb_dev = torch.from_numpy(emb).to(dev).to(store_dtype)
    pk_slot = pk_ids = pk_emb = None
    if pack_nodes.size:
        cap = min(ch_ell.shape[1], MEMBER_SIM_CAP)
        slot = np.full(n_pad, -1, np.int32)
        slot[pack_nodes] = np.arange(pack_nodes.size, dtype=np.int32)
        pids = ch_ell[pack_nodes, :cap]                             # [S, cap]
        pk_slot, pk_ids = up(slot), up(pids)
        # the [S, cap, D] rows are gathered on the device from emb
        pk_emb = torch.where(pk_ids[:, :, None] >= 0,
                             emb_dev[pk_ids.clamp(0, n_pad - 1).long()],
                             torch.zeros((), dtype=store_dtype, device=dev))
    if dev.type == "cuda" and n_pad % 1024 == 0 and n_pad >= 4096:
        # warm the kernel-true certificate calibration for the tile the
        # certified top-k will use on this corpus
        from ahrag_tpu_torch.ops.topk import binmax_eps
        binmax_eps(dev.type, d, 1024, store_dtype == torch.bfloat16)
    # Bin-packed copy for the binned seed stage's candidate gather: bin
    # (tile, lane) of tile_n = 1024 holds rows {tile*1024 + lane + 128*i};
    # this permutation stores each bin's 8 rows contiguously.
    emb_binpack = None
    if wants_binpack(dev, n, n_pad):
        t = n_pad // 1024
        emb_binpack = (emb_dev.reshape(t, 8, 128, d).transpose(1, 2)
                       .reshape(t * 128, 8, d).contiguous())
    return GraphTensors(
        emb=emb_dev,
        node_type=up(nt),
        level=up(lv),
        judge=up(jd),
        has_judge=up(hj),
        conf=up(cf),
        has_conf=up(hc),
        indexed=up(ix),
        valid=up(vd),
        parents=up(_ell(parents, n_pad)),
        children=up(ch_ell),
        related=up(_ell(related, n_pad)),
        hyperedges=up(_ell(hyperedges, n_pad)),
        members=up(_ell(members, n_pad)),
        child_pack_slot=pk_slot,
        child_pack_ids=pk_ids,
        child_pack_emb=pk_emb,
        emb_binpack=emb_binpack,
        n_nodes=n,
        n_edges=n_edges,
        mask_trivial=bool(np.all(ix[:n])) if n else False,
    )
