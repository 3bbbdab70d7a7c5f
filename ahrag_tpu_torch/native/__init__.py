"""The port's copy of the C++ host runtime: the threaded hashed-n-gram
featurizer, the ELL adjacency construction and its degree scan, and the host's
exact top-k.

``csrc/ahrag_native.cpp`` is a verbatim copy of the JAX package's
``native/ahrag_native.cpp``. It is built at first use with the host C++
compiler (``$CXX``, then ``c++``, then ``g++`` from PATH) into
``ahrag_tpu_torch/_build/`` (ignored by git), under a name derived from the
source, the compiler and the flags, and loaded with ``ctypes``. There is no
``-march=native``, so a library built on one machine computes what one built
on another does.

Unlike the JAX package's bindings these never answer "unbuilt": a library that
cannot be built or loaded is an error, and no caller drops to Python. The
Python featurizer (``HashedNGramEncoder._count_matrix``) and the Python loop of
``graph/tensors.py`` (``_ell_loop``) are the plain versions the tests hold
these against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ahrag_tpu_torch.utils.once import locked_cache

SOURCE = Path(__file__).resolve().parent / "csrc" / "ahrag_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
ABI_VERSION = 2

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F = ctypes.c_float
# name -> (restype, argtypes) of the extern "C" functions the port calls
_SIGNATURES = {
    "ahrag_native_abi_version": (_I32, []),
    "ell_max_degree": (_I32, [_P, _I64, _I32]),
    "ell_build": (None, [_P, _P, _I64, _I32, _I32, _I32, _P]),
    "exact_topk_f32": (None, [_P, _P, _I32, _I64, _I32, _I32, _P, _P]),
    "token_estimate": (_I64, [ctypes.c_char_p, _I64]),
    "hash_features_w": (None, [ctypes.c_char_p, _I64, _I32, _F, _P]),
    "hash_features_coo_batch_w": (_I64, [ctypes.c_char_p, _P, _I32, _I32, _F, _I32,
                                         _P, _P, _P, _I64]),
}


def which_cxx() -> str | None:
    """``$CXX``, then ``c++``, then ``g++`` from PATH; None when none is found."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = c and shutil.which(c)
        if path:
            return path
    return None


def find_cxx() -> str:
    """``which_cxx``, or an error when there is no compiler."""
    cxx = which_cxx()
    if cxx:
        return cxx
    raise RuntimeError("no C++ compiler ($CXX, c++ or g++ on PATH); the port's "
                       "native runtime cannot be built")


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libahrag_native-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the runtime unless the library for this source exists.
    Returns {"path", "seconds", "built"}."""
    cxx = find_cxx()
    out = library_path(cxx)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return {"path": str(out), "seconds": seconds, "built": True}


@locked_cache
def load_library() -> ctypes.CDLL:
    """The runtime's library, built on first use. Thread-safe: the first
    of several concurrent callers builds it, the others wait."""
    lib = ctypes.CDLL(build()["path"])
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    if lib.ahrag_native_abi_version() != ABI_VERSION:
        raise RuntimeError("the native runtime's ABI version is not "
                           f"{ABI_VERSION}")
    return lib


def available() -> bool:
    """Whether the library loads, building it first if need be: False only
    while it is not loaded and no C++ compiler is found. A compiler that
    fails, or a library that does not load, raises."""
    if load_library.cache_info().currsize == 0 and which_cxx() is None:
        return False
    load_library()
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def ell_from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int, n_pad: int,
                   k: int) -> np.ndarray:
    """Padded ELL table ``[n_pad, k]`` int32, -1 padded, from an edge list:
    row ``s`` holds the ``dst`` of ``s``'s edges in edge order, its first
    ``k`` only; edges whose ``src`` lies outside ``[0, n_nodes)`` are dropped."""
    if n_nodes > n_pad:
        raise ValueError(f"n_nodes {n_nodes} exceeds the table's {n_pad} rows")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    out = np.full((n_pad, k), -1, dtype=np.int32)
    load_library().ell_build(_ptr(src), _ptr(dst), len(src), n_nodes, n_pad, k, _ptr(out))
    return out


def max_degree(src: np.ndarray, n_nodes: int) -> int:
    """The most edges any node in ``[0, n_nodes)`` is the source of (0 for none)."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    return int(load_library().ell_max_degree(_ptr(src), len(src), n_nodes))


def token_estimate(text: str) -> int:
    """Vocabulary-free estimate of a text's BPE token count."""
    raw = text.encode("utf-8")
    return int(load_library().token_estimate(raw, len(raw)))


def hash_features_coo(texts: List[str], buckets: int, n_threads: int = 0,
                      cgram_weight: float = 1.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse hashed n-gram counts of ``texts`` as COO (rows int32, cols int32,
    vals float32): doc-major, ascending buckets within a doc, threaded over the
    documents in C++. Char 3..5-gram occurrences count ``cgram_weight`` each,
    words and bigrams 1.0."""
    lib = load_library()
    blobs = [(t or "").encode("utf-8") for t in texts]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    data = b"".join(blobs)
    # features per doc <= ~4 * chars (unigrams + bigrams < chars; three
    # char-gram scales) + slack; a short capacity is retried at the size the
    # library reports
    cap = max(4 * len(data) + 16 * len(blobs), 1024)
    for _ in range(3):
        rows = np.empty(cap, dtype=np.int32)
        cols = np.empty(cap, dtype=np.int32)
        vals = np.empty(cap, dtype=np.float32)
        nnz = int(lib.hash_features_coo_batch_w(
            data, _ptr(offsets), len(blobs), buckets, cgram_weight, n_threads,
            _ptr(rows), _ptr(cols), _ptr(vals), cap))
        if nnz >= 0:
            return rows[:nnz], cols[:nnz], vals[:nnz]
        cap = -nnz
    raise RuntimeError("hash_features_coo_batch_w kept asking for more room")


def hash_features_counts(texts: List[str], buckets: int,
                         cgram_weight: float = 1.0) -> np.ndarray:
    """Dense [len(texts), buckets] float32 hashed n-gram counts."""
    lib = load_library()
    out = np.zeros((len(texts), buckets), dtype=np.float32)
    for i, text in enumerate(texts):
        raw = (text or "").encode("utf-8")
        lib.hash_features_w(raw, len(raw), buckets, cgram_weight, _ptr(out[i]))
    return out


def exact_topk(q: np.ndarray, emb: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k of ``q @ emb.T`` on the host (the CPU baseline): values
    ``[B, k]`` float32 in descending order and row ids ``[B, k]`` int32, ties
    to the lowest id, ``k`` clamped to the row count."""
    q = np.ascontiguousarray(q, dtype=np.float32)
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    b, d = q.shape
    n = emb.shape[0]
    k = min(k, n)
    vals = np.empty((b, k), dtype=np.float32)
    idx = np.empty((b, k), dtype=np.int32)
    if k > 0:    # the library's insertion needs a slot
        load_library().exact_topk_f32(_ptr(q), _ptr(emb), b, n, d, k, _ptr(vals), _ptr(idx))
    return vals, idx
