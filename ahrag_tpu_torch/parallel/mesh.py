"""The device mesh and the rank's share of a corpus.

Port of ``ahrag_tpu/parallel/mesh.py``. The scaling axis is the corpus: the
embedding matrix shards along its rows, queries and episodes along the data
axis. ``make_mesh`` builds a 2-D ``DeviceMesh`` of shape ``(dp, n // dp)``
over the ranks of the process group, named ``("dp", "corpus")`` as in JAX.

JAX placed arrays with ``NamedSharding``s (``corpus_sharding``,
``data_sharding``, ``replicated``) and let XLA insert the collectives. The
port has no such placement: each rank holds the rows it owns (``local_rows``,
the counterpart of the corpus and data shardings) and a replicated tensor is
simply the same tensor on every rank; the collectives are written out in
``parallel/sharded.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "dp"
CORPUS_AXIS = "corpus"
SLICE_AXIS = "slice"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              axis_names: Sequence[str] = (DATA_AXIS, CORPUS_AXIS)) -> DeviceMesh:
    """A 2-D ``(dp, n // dp)`` mesh over every rank of the process group
    (``dp`` defaults to 1: all ranks on the corpus axis). ``n_devices``, when
    given, must be the number of ranks. The mesh's device type follows the
    group's backend: ``cuda`` under nccl, ``cpu`` under gloo, whose
    collectives run on the host."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize() under "
                           "torchrun, or start the ranks with parallel.distributed.spawn")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices}, {n} ranks")
    dp = dp or 1
    if n % dp:
        raise ValueError(f"{n} ranks not divisible by dp={dp}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, n // dp), mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def block_index(mesh: DeviceMesh, axes: Sequence[str]) -> tuple[int, int]:
    """(this rank's block, number of blocks) when rows split jointly over
    ``axes``, the first axis outermost (JAX's ``P((slice, corpus))``)."""
    index, count = 0, 1
    for axis in axes:
        size = axis_size(mesh, axis)
        index, count = index * size + mesh.get_local_rank(axis), count * size
    return index, count


def local_rows(x: torch.Tensor, mesh: DeviceMesh,
               axes: Sequence[str] = (CORPUS_AXIS,)) -> torch.Tensor:
    """This rank's contiguous block of the rows of ``x`` split over ``axes``
    (a view; ``len(x)`` must divide evenly). With ``(DATA_AXIS,)`` this is
    the rank's share of a query or episode batch."""
    index, count = block_index(mesh, axes)
    if x.shape[0] % count:
        raise ValueError(f"{x.shape[0]} rows do not split into {count} blocks")
    rows = x.shape[0] // count
    return x[index * rows:(index + 1) * rows]
