"""Process-group set-up and a launcher for ranks on one machine.

Port of ``ahrag_tpu/parallel/distributed.py``. ``initialize`` sets up
``torch.distributed`` from torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) where the JAX package read
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``;
a single process is a no-op that returns False, as there. On a machine with
N cards, ``torchrun --nproc-per-node N prog.py`` starts one rank per card, and
``prog.py`` calls ``initialize()`` before ``parallel.mesh.make_mesh``.

One device is one rank here: where JAX's mesh spanned devices of one process
(the 8-device virtual CPU mesh of the tests), ``torch.distributed`` needs a
process per device. ``spawn`` starts them on one machine (the CPU tests over
gloo, and the one-card rehearsal, where every rank shares the card over
gloo) with a ``file://`` rendezvous, so that concurrent launches never
collide on a port.

The backend is named by the caller: ``nccl`` when every rank has a card of
its own, ``gloo`` otherwise. Nothing switches between them by itself.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: str = "nccl") -> bool:
    """Join the process group; returns True when a multi-process group is up
    (also on every later call), False for a single process. Arguments left
    out are read from torchrun's variables. Under ``nccl`` each rank takes
    the card ``LOCAL_RANK``; there must be one per rank on this host."""
    if dist.is_initialized():
        return True
    world_size = world_size or int(os.getenv("WORLD_SIZE", "0") or 0)
    rank = rank if rank is not None else int(os.getenv("RANK", "-1") or -1)
    if init_method is None and os.getenv("MASTER_ADDR") and os.getenv("MASTER_PORT"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if not init_method or world_size <= 1 or rank < 0:
        return False  # single process: nothing to do
    if backend == "nccl":
        local = int(os.getenv("LOCAL_RANK", str(rank)))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"nccl needs a card per rank: local rank {local}, "
                f"{torch.cuda.device_count()} CUDA devices; pass backend='gloo' "
                "to share cards (or run on the CPU)")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def process_info() -> dict:
    """The JAX package's four keys, with one device per rank: this rank, the
    number of ranks, the ranks on this host and in all."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1}
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_devices": int(os.getenv("LOCAL_WORLD_SIZE", str(world))),
            "global_devices": world}


def rank_device(device: str | torch.device) -> torch.device:
    """The rank's device of type ``device``: ``cuda:LOCAL_RANK`` modulo the
    cards present (every rank on card 0 in a one-card rehearsal), or the
    CPU. Raises when ``cuda`` is asked for and there is no card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("this rank was asked for CUDA and has no CUDA device")
    local = int(os.getenv("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _child(rank: int, fn: Callable[..., Any], world_size: int, backend: str,
           init_file: str, out_dir: str, timeout_s: float) -> None:
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    result = fn(*args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world_size: int, *args: Any, backend: str = "gloo",
          init_file: Optional[str] = None, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` fresh processes joined in one
    group; returns each rank's result, in rank order. ``fn`` must be a
    module-level function (it is sent by name), and its result is read back
    through ``torch.save``: CPU tensors and plain values. The rendezvous is
    the file ``init_file`` (one in a temporary directory by default), which
    must not exist yet. A collective that waits longer than ``timeout_s``
    raises; when any rank fails, the others are stopped and the error is
    raised here. The arguments reach the ranks through a file (an argument
    of more than a few tens of KB in the launch itself slows every start by
    seconds)."""
    with tempfile.TemporaryDirectory(prefix="ahrag_spawn_") as tmp:
        init_file = init_file or os.path.join(tmp, "rendezvous")
        torch.save(args, os.path.join(tmp, "args.pt"))
        mp.spawn(_child, args=(fn, world_size, backend, os.path.abspath(init_file), tmp,
                               timeout_s),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
