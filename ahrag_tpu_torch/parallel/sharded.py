"""Sharded retrieval, a corpus-sharded graph and tensor-parallel MiniLM.

Port of ``ahrag_tpu/parallel/sharded.py``. Each rank holds its block of
corpus rows (``rows = N / shards``, starting at ``index * rows``) and the
queries of its data-parallel row; every function below returns the same
result on every rank of the corpus group. JAX wrote the local stage under
``shard_map`` and let GSPMD partition the rest; torch has neither, so the
collectives are explicit:

- the top-k functions: a local stage, an ``all_gather`` of the ``[B, k]``
  candidates over the corpus group, and a stable top-k of the candidates
  concatenated in shard order, so that ties go to the lowest global index
  (as ``jax.lax.top_k`` gives them);
- ``sharded_refined_topk``: the certified two-phase local stage through the
  ``dense_binmax`` kernel at ``tile_n`` 2048 on the card, a global
  certificate, and a fallback that every rank takes together, decided by one
  ``all_reduce(MIN)`` of the certified flag;
- ``shard_graph_tensors``: a graph whose ``emb`` holds only the rank's rows
  and whose ``shard`` (a ``CorpusShard``) carries the collective stages:
  ``graph/search.py`` takes its seeds from the sharded certified top-k and
  assembles member embeddings from their owners through it;
- ``shard_minilm_params``: the Megatron split of MiniLM's blocks, one
  ``all_reduce`` after each row-parallel product.

Under gloo every collective runs on host copies of its (small) operands,
whatever device they come from; under nccl on the card.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ahrag_tpu_torch.device import f32_matmul, stable_topk
from ahrag_tpu_torch.graph.tensors import GraphTensors
from ahrag_tpu_torch.ops.binmax import NEG_INF, dense_binmax
from ahrag_tpu_torch.ops.topk import binmax_eps, binned_rows_of
from ahrag_tpu_torch.parallel.mesh import (CORPUS_AXIS, DATA_AXIS, SLICE_AXIS, axis_size,
                                           block_index, local_rows)

__all__ = ["SLICE_AXIS", "BINNED_TILE", "all_gather_stack", "all_reduce",
           "sharded_dense_topk", "sharded_refined_topk", "sharded_refined_topk_cert",
           "sharded_topk_2level", "CorpusShard", "shard_graph_tensors", "shard_queries",
           "shard_minilm_params"]

# the binned local stage's tile (JAX's HIGHEST coarse pass), and the fewest
# rows per shard that take it
BINNED_TILE = 2048
BINNED_MIN_ROWS = 65536


# ----------------------------------------------------------------- collectives
def _on_host(group: dist.ProcessGroup) -> bool:
    return dist.get_backend(group) == "gloo"


def all_gather_stack(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` in group-rank (shard) order, on
    ``x``'s device."""
    src = x.detach().cpu() if _on_host(group) else x.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


def all_reduce(x: torch.Tensor, op: dist.ReduceOp, group: dist.ProcessGroup) -> torch.Tensor:
    """The reduction of ``x`` over the group as a new tensor on ``x``'s
    device (``x`` is left as it was)."""
    y = x.detach().to("cpu", copy=True) if _on_host(group) else x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


# ----------------------------------------------------------------- top-k
def _pad(vals: torch.Tensor, idx: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad [B, k'] results to k columns: values NEG_INF, ids 0 (JAX's pad)."""
    if k > vals.shape[1]:
        vals = nn.functional.pad(vals, (0, k - vals.shape[1]), value=NEG_INF)
        idx = nn.functional.pad(idx, (0, k - idx.shape[1]))
    return vals, idx


def _merge(vals: torch.Tensor, gidx: torch.Tensor, k: int,
           group: dist.ProcessGroup) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank's ``[B, kk]`` candidates (values descending, ties by index)
    -> the replicated top ``min(k, S * kk)``: gathered, concatenated in shard
    order, then a stable top-k, so equal values keep the lowest global id."""
    b = vals.shape[0]
    cv = all_gather_stack(vals, group).transpose(0, 1).reshape(b, -1)
    ci = all_gather_stack(gidx, group).transpose(0, 1).reshape(b, -1)
    v, pos = stable_topk(cv, min(k, cv.shape[1]))
    return v, ci.gather(1, pos)


def _local_mask(rows: int, offset: int, n_valid: int, device) -> torch.Tensor:
    return offset + torch.arange(rows, device=device) < n_valid


def _exact_local(q: torch.Tensor, emb_l: torch.Tensor, mask_l: torch.Tensor, offset: int,
                 k: int, flush_eps: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full local float32 product, masked, and its top ``min(k, rows)``
    with global ids. ``flush_eps`` flushes |score| below it to 0.0 first
    (``ops/topk.py _flush_tiny``)."""
    s = f32_matmul(q, emb_l.T)
    if flush_eps:
        s = torch.where(s.abs() < flush_eps, 0.0, s)
    v, i = stable_topk(torch.where(mask_l[None, :], s, NEG_INF), min(k, emb_l.shape[0]))
    return v, i + offset


def sharded_dense_topk(q: torch.Tensor, emb_l: torch.Tensor, n_valid: int, k: int,
                       mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus-sharded embedding matrix.

    q: [B, D] (the same on every rank of the corpus group); emb_l: this
    rank's [rows, D] block of the corpus. Returns the replicated ([B, k]
    float32 scores, [B, k] int64 global ids); past the candidate count the
    scores are NEG_INF and the ids 0."""
    group = mesh.get_group(CORPUS_AXIS)
    index = mesh.get_local_rank(CORPUS_AXIS)
    offset = index * emb_l.shape[0]
    mask_l = _local_mask(emb_l.shape[0], offset, n_valid, emb_l.device)
    return _pad(*_merge(*_exact_local(q, emb_l, mask_l, offset, k), k, group), k)


def _binned_topk(q: torch.Tensor, emb_l: torch.Tensor, mask_l: torch.Tensor, offset: int,
                 k: int, margin: int, group: dist.ProcessGroup
                 ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """The binned local stage and its global certificate (JAX's ``use_binned``
    branch). ``dense_binmax`` at ``tile_n`` 2048 reduces the shard to bins of
    16 rows; the top ``mb = min(max(k + margin, 3k + 2), nbins)`` bins are
    re-scored exactly (their rows in index order, so ties keep the lowest
    row) and merged. Every row outside every shard's selected bins scores
    at most ``max_shard(c_out) + eps``, ``c_out`` the largest bin max not
    selected (the (mb+1)-th) and ``eps`` the kernel's own band
    (``binmax_eps`` at tile 2048); when the merged k-th value clears it for
    every query, the result is exact. Otherwise every rank takes the
    fallback (the full local product and a merge) together: the decision is
    one ``all_reduce(MIN)`` of the flag. Returns (vals, ids, certified)."""
    b, rows, d = q.shape[0], emb_l.shape[0], emb_l.shape[1]
    eps = binmax_eps(emb_l.device.type, d, BINNED_TILE, emb_l.dtype == torch.bfloat16)
    binmax = dense_binmax(q, emb_l, rows, mask_l, tile_n=BINNED_TILE)
    nbins = binmax.shape[1]
    mb = min(max(min(k + margin, rows), 3 * k + 2), nbins)
    bm_vals, bm_idx = stable_topk(binmax, min(mb + 1, nbins))
    cand = binned_rows_of(bm_idx[:, :mb], BINNED_TILE).reshape(b, -1).sort(dim=1).values
    exact = torch.bmm(emb_l[cand].float(), q.float()[:, :, None])[..., 0]
    exact = torch.where(mask_l[cand], exact, NEG_INF)
    vals, pos = stable_topk(exact, min(k, exact.shape[1]))
    v, i = _merge(vals, cand.gather(1, pos) + offset, k, group)
    if mb >= nbins:
        return v, i, True   # every bin selected: every row re-scored exactly
    bound = all_gather_stack(bm_vals[:, mb], group).amax(dim=0)      # [B]
    ok = ((v[:, -1] > bound + eps) | (bound <= NEG_INF / 2)).all()
    flag = all_reduce(ok.to(torch.int32).reshape(1), dist.ReduceOp.MIN, group)
    if int(flag.item()) == 1:
        return v, i, True
    v, i = _merge(*_exact_local(q, emb_l, mask_l, offset, k), k, group)
    return v, i, False


def _use_binned(emb_l: torch.Tensor) -> bool:
    """JAX's ``use_binned`` ("on the TPU") as "on the card", at 2048-aligned
    shards of at least 65,536 rows."""
    rows = emb_l.shape[0]
    return emb_l.is_cuda and rows % BINNED_TILE == 0 and rows >= BINNED_MIN_ROWS


def _refined_cert(q: torch.Tensor, emb_l: torch.Tensor, mask_l: torch.Tensor, offset: int,
                  k: int, margin: int, group: dist.ProcessGroup, flush_eps: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    if emb_l.dtype == torch.bfloat16:
        # bf16 storage: every stage scores the same bf16 x bf16 products
        q = q.to(torch.bfloat16)
    if _use_binned(emb_l):
        v, i, cert = _binned_topk(q, emb_l, mask_l, offset, k, margin, group)
    else:
        # below the kernel's window: the exact local stage, exact by
        # construction, so no certificate and no fallback
        v, i = _merge(*_exact_local(q, emb_l, mask_l, offset, k, flush_eps), k, group)
        cert = True
    return (*_pad(v, i, k), cert)


def sharded_refined_topk_cert(q: torch.Tensor, emb_l: torch.Tensor, n_valid: int, k: int,
                              mesh: DeviceMesh, margin: int = 16
                              ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """``sharded_refined_topk`` plus whether the binned stage's global
    certificate held (True on the exact stage; False means every rank took
    the fallback)."""
    group = mesh.get_group(CORPUS_AXIS)
    offset = mesh.get_local_rank(CORPUS_AXIS) * emb_l.shape[0]
    mask_l = _local_mask(emb_l.shape[0], offset, n_valid, emb_l.device)
    return _refined_cert(q, emb_l, mask_l, offset, k, margin, group)


def sharded_refined_topk(q: torch.Tensor, emb_l: torch.Tensor, n_valid: int, k: int,
                         mesh: DeviceMesh, margin: int = 16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Certified exact top-k over a corpus-sharded embedding matrix, the
    contract of ``sharded_dense_topk``. The local stage is the full float32
    product below the kernel's window, and on the card, at 2048-aligned
    shards of 65,536 rows or more, the binned stage of ``_binned_topk``
    (its certificate is global and its fallback taken by all ranks
    together). Cross-shard traffic: the [S, B, k] candidates and, binned,
    one [S, B] bound and one flag."""
    v, i, _ = sharded_refined_topk_cert(q, emb_l, n_valid, k, mesh, margin)
    return v, i


def sharded_topk_2level(q: torch.Tensor, emb_l: torch.Tensor, n_valid: int, k: int,
                        mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a ``{slice, corpus}`` mesh, the corpus rows split
    over both axes jointly (``emb_l`` is block ``slice * C + corpus``). The
    merge is hierarchical: the local top-k, a merge over the corpus group
    (within a slice), then a merge over the slice group (across slices), so
    that only ``slices * k`` candidates cross the outer link per query.
    Ties go to the lowest global index."""
    index, _ = block_index(mesh, (SLICE_AXIS, CORPUS_AXIS))
    offset = index * emb_l.shape[0]
    mask_l = _local_mask(emb_l.shape[0], offset, n_valid, emb_l.device)
    v, i = _merge(*_exact_local(q, emb_l, mask_l, offset, k), k, mesh.get_group(CORPUS_AXIS))
    return _merge(v, i, k, mesh.get_group(SLICE_AXIS))


# ----------------------------------------------------------------- the graph
@dataclass(frozen=True)
class CorpusShard:
    """Where a rank's rows of a corpus-sharded graph lie: rows
    ``[offset, offset + rows)`` of ``n_pad``, block ``index`` of ``count``
    along the corpus group ``group``. Its two methods are the collective
    stages that ``graph/search.py`` runs on a sharded graph; every rank of
    the group calls them together."""
    group: dist.ProcessGroup
    index: int
    count: int
    rows: int
    n_pad: int

    @property
    def offset(self) -> int:
        return self.index * self.rows

    def seed_topk(self, gt: GraphTensors, q: torch.Tensor, k: int, margin: int,
                  flush_eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hybrid search's seeds: the certified top-k over the indexed,
        valid nodes, exact whether or not the certificate held (a failed
        certificate takes the fallback). ``flush_eps`` applies on the exact
        local stage, as on the flat branch; the binned stage does not flush,
        as the card's flat binned stage does not."""
        mask_l = (gt.indexed & gt.valid)[self.offset:self.offset + self.rows]
        v, i, _ = _refined_cert(q, gt.emb, mask_l, self.offset, k, margin, self.group,
                                flush_eps)
        return v, i

    def gather_rows(self, emb_l: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (in [0, n_pad), the same on every rank) of the whole
        embedding matrix as float32, from this rank's block ``emb_l``: each
        rank fills the rows it owns, zeros elsewhere, and one
        ``all_reduce(SUM)`` assembles them, which is exact since x + 0 = x."""
        local = ids - self.offset
        own = (local >= 0) & (local < self.rows)
        part = torch.where(own[..., None], emb_l[local.clamp(0, self.rows - 1)].float(), 0.0)
        return all_reduce(part, dist.ReduceOp.SUM, self.group)


def shard_graph_tensors(gt: GraphTensors, mesh: DeviceMesh,
                        device: str | torch.device | None = None) -> GraphTensors:
    """The graph with ``emb`` cut to this rank's block of rows over the
    corpus axis, on ``device`` (the graph's by default). ``emb`` is the one
    leaf whose size matters, so no rank keeps a copy of all of it. The
    per-node scalars and adjacency tables stay whole on every rank. The
    packed member tables and ``emb_binpack`` are dropped: member embeddings
    are gathered from their owners instead (``CorpusShard.gather_rows``), and the
    binned stage reads the shard's own rows. Searches on the result run
    on every rank of the corpus group together."""
    count = axis_size(mesh, CORPUS_AXIS)
    if gt.n_pad % count:
        raise ValueError(f"n_pad {gt.n_pad} does not split into {count} corpus shards")
    dev = gt.device if device is None else torch.device(device)
    shard = CorpusShard(group=mesh.get_group(CORPUS_AXIS),
                        index=mesh.get_local_rank(CORPUS_AXIS), count=count,
                        rows=gt.n_pad // count, n_pad=gt.n_pad)
    kw = {}
    for f in dataclasses.fields(GraphTensors):
        x = getattr(gt, f.name)
        if f.name in ("child_pack_slot", "child_pack_ids", "child_pack_emb", "emb_binpack"):
            x = None
        elif f.name == "emb":
            x = local_rows(x, mesh).to(dev, copy=True)
        elif isinstance(x, torch.Tensor):
            x = x.to(dev)
        kw[f.name] = x
    kw["shard"] = shard
    return GraphTensors(**kw)


def shard_queries(q_embs: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a query or episode batch over the data axis."""
    return local_rows(q_embs, mesh, (DATA_AXIS,))


# ----------------------------------------------------------------- MiniLM TP
class _RowParallelDense(nn.Module):
    """A ``Dense`` split by input rows over a group: this rank's partial
    product, summed by one ``all_reduce``, then the whole bias."""

    def __init__(self, dense: nn.Module, rows: slice, group: dist.ProcessGroup) -> None:
        super().__init__()
        self.kernel = nn.Parameter(dense.kernel.detach()[rows].clone())
        self.bias = nn.Parameter(dense.bias.detach().clone())
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(torch.matmul(x, self.kernel), dist.ReduceOp.SUM, self.group) + self.bias


def _column_slice(dense: nn.Module, cols: slice) -> None:
    """Keep only the output columns ``cols`` of a ``Dense``, in place."""
    dense.kernel = nn.Parameter(dense.kernel.detach()[:, cols].clone())
    dense.bias = nn.Parameter(dense.bias.detach()[cols].clone())
    dense.out_shape = (dense.kernel.shape[1],)


def shard_minilm_params(model: nn.Module, mesh: DeviceMesh, axis: str = CORPUS_AXIS) -> nn.Module:
    """Megatron-style tensor parallelism for ``MiniLMModel``: a copy of
    ``model`` whose blocks hold this rank's columns of q/k/v and ff_in and
    rows of attn_out and ff_out over the mesh axis ``axis`` (whole heads,
    so 12 heads split over 1, 2, 3, 4, 6 or 12 ranks); embeddings and
    LayerNorms are whole. Calling it on every rank of the axis gives the
    replicated encode."""
    index, count = mesh.get_local_rank(axis), axis_size(mesh, axis)
    cfg, group = model.cfg, mesh.get_group(axis)
    if cfg.heads % count or cfg.intermediate % count:
        raise ValueError(f"{cfg.heads} heads and {cfg.intermediate} ff columns "
                         f"over {count} ranks")
    width, ff = cfg.hidden // count, cfg.intermediate // count
    cols, fcols = slice(index * width, (index + 1) * width), slice(index * ff, (index + 1) * ff)
    tp = copy.deepcopy(model)
    for i in range(cfg.layers):
        block = getattr(tp, f"block_{i}")
        for name in ("q", "k", "v"):
            _column_slice(getattr(block, name), cols)
        _column_slice(block.ff_in, fcols)
        block.attn_out = _RowParallelDense(block.attn_out, cols, group)
        block.ff_out = _RowParallelDense(block.ff_out, fcols, group)
    return tp
