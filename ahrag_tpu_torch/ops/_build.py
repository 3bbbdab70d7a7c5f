"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` into one shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The kernels' TMA descriptors need the driver API's
``cuTensorMapEncodeTiled``; the library fetches it at run time through the
runtime's ``cudaGetDriverEntryPoint`` (``csrc/common.cuh``), so nothing links
against ``libcuda`` and the flags carry no ``-lcuda``. The library lands in
``ahrag_tpu_torch/_build/`` (ignored by git) under a name derived from the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. It is built at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ahrag_tpu_torch.utils.once import locked_cache

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dynamic shared memory a block may opt in to on Hopper (227 KB)
SMEM_LIMIT = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> argtypes of the extern "C" launchers in csrc/*.cu
_SIGNATURES = {
    "ahrag_binmax2": [_P, _P, _P, _LL, _I, _LL, _I, _I, _I, _I, _P, _P, _P],
    "ahrag_binmax": [_P, _P, _P, _LL, _I, _LL, _I, _I, _I, _I, _P, _P],
    "ahrag_tile_topk": [_P, _P, _P, _LL, _I, _LL, _I, _I, _I, _I, _P, _P, _P],
}


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin; the port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libahrag_kernels-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.
    Returns {"path", "seconds", "built", "log"} (``log`` holds ptxas's
    register and shared-memory report)."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return {"path": str(out), "seconds": seconds, "built": True,
            "log": proc.stderr}


def launch_args(q: torch.Tensor, emb: torch.Tensor,
                mask: torch.Tensor | None) -> tuple[ctypes.CDLL, int, int]:
    """(library, is_bf16, current stream) for a launch on ``emb``'s card, after
    the checks every kernel shares: a CUDA device, contiguous q, emb and mask
    (``mask`` may be None), D % 8 == 0 and 16-byte aligned q and emb."""
    if emb.device.type != "cuda":
        raise ValueError(f"no CUDA kernel for device {emb.device}")
    if not (q.is_contiguous() and emb.is_contiguous()
            and (mask is None or mask.is_contiguous())):
        raise ValueError("the kernels take contiguous q, emb and mask")
    if q.shape[1] % 8 or q.data_ptr() % 16 or emb.data_ptr() % 16:
        raise ValueError("the kernels need D % 8 == 0 and 16-byte aligned q and emb")
    return (load_library(), int(emb.dtype == torch.bfloat16),
            torch.cuda.current_stream(emb.device).cuda_stream)


_COUNT_LOCK = threading.Lock()


@locked_cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use. Needs a Hopper card (9, 0).
    Thread-safe: the first of several concurrent callers builds and loads,
    the others wait for it and share the result."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); this "
                           f"device has compute capability {cap}")
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock, so that the count stays
    right when several threads launch (the serving pipeline's workers)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
