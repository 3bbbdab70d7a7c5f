#!/usr/bin/env python3
"""Times the port's bin-max kernels at their main-path shapes on one CUDA card.

    python3 tools/torch_binmax_timing.py [--root DIR] [--reps N]

Imports ``ahrag_tpu_torch`` from DIR (default: the repository that holds this
script), so that two trees, an unpacked parent commit and the working tree, can
be compared on the same card, run in turns (parent, change, change, parent).
On seeded random data made on the card (unit rows, a mask with 1% of rows off,
every row below n_valid) it times by CUDA events over ``--reps`` launches after
a warm-up, beside one ``torch.matmul`` + ``amax`` (the library call) and the
bound (bytes or operations at the H100 SXM peaks), and for both the kernel
and the library call the host's enqueue time per call and the device time per
call from a ``torch.profiler`` trace:
- ``dense_binmax`` at tile_n 1024: 1,067,008 x 384 bf16 at B = 4 and 64,
  135,168 x 384 float32 at B = 4, 16 and 64; the learned graph (5,120 x 768
  float32) at B = 1; the answer path's XL graph (6,144 x 384 float32) at B = 1
  and the sample corpus's (5,120 x 384 float32) at B = 64; at tile_n 2048 a
  shard of 1M rows over 4 ranks (262,144 x 384, B = 64) in both types;
- ``dense_binmax2`` at tile_n 1024: 1,067,008 x 384 bf16 at B = 512 (trivial
  mask, the 1M rung), 134,144 x 384 float32 at B = 1024 (the 131k rung's
  chunk), the learned graph at B = 128 and 256.
Each kernel is checked against its plain version within the bin-max tolerance.
Then ``binmax_eps`` at (d, tile_n) (384, 1024), (768, 1024) and (384, 2048) for
both types, each row's launch plan as the wrapper launched it (query chunk,
split, grid) and the card's cluster slots where the tree has them, and the host's microseconds per ``dense_binmax`` call at the answer path's
shape taken apart (``host_breakdown``). Prints the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-6, "float32": 1e-5}
# label, kernel, rows, d, type, B, tile_n
SHAPES = (("1M bf16 B=4", "binmax", 1067008, 384, "bfloat16", 4, 1024),
          ("1M bf16 B=64", "binmax", 1067008, 384, "bfloat16", 64, 1024),
          ("131k f32 B=4", "binmax", 135168, 384, "float32", 4, 1024),
          ("131k f32 B=16", "binmax", 135168, 384, "float32", 16, 1024),
          ("131k f32 B=64", "binmax", 135168, 384, "float32", 64, 1024),
          ("shard bf16 B=64", "binmax", 262144, 384, "bfloat16", 64, 2048),
          ("shard f32 B=64", "binmax", 262144, 384, "float32", 64, 2048),
          ("learned f32 D=768 B=1", "binmax", 5120, 768, "float32", 1, 1024),
          ("answer f32 n=6144 B=1", "binmax", 6144, 384, "float32", 1, 1024),
          ("host f32 n=5120 B=64", "binmax", 5120, 384, "float32", 64, 1024),
          ("binmax2 1M bf16 B=512", "binmax2", 1067008, 384, "bfloat16", 512, 1024),
          ("binmax2 131k f32 B=1024", "binmax2", 134144, 384, "float32", 1024, 1024),
          ("binmax2 learned f32 D=768 B=128", "binmax2", 5120, 768, "float32", 128, 1024),
          ("binmax2 learned f32 D=768 B=256", "binmax2", 5120, 768, "float32", 256, 1024))
EPS_AT = ((384, 1024), (768, 1024), (384, 2048))


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_us(fn, reps: int) -> float:
    """Host microseconds per call to enqueue ``reps`` calls (no synchronize
    between them): where it exceeds the device time, the caller's host sets
    the pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_ms(fn, reps: int):
    """Device milliseconds per call, the kernels' own time summed from a
    ``torch.profiler`` trace of ``reps`` calls; None where the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3 if total else None


def host_breakdown(bm, reps: int) -> dict:
    """Host microseconds per call of ``dense_binmax`` at the answer path's
    shape (6,144 x 384 float32, B = 1), taken apart: the whole wrapper, its
    launcher alone through ctypes with the arguments made once (the C side:
    TMA descriptors, attributes, the launch), ``torch.empty`` of the output
    and ``torch.cuda.current_stream``."""
    import torch
    from ahrag_tpu_torch.ops import _build
    dev = torch.device("cuda")
    n, d = 6144, 384
    emb = torch.randn((n, d), device=dev)
    q = torch.randn((1, d), device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.empty((1, n // 1024 * 128), device=dev)
    lib = _build.load_library()
    # a tree with launch plans passes (chunk, split, grid), an older one the chunk
    plan = (tuple(bm.binmax_plan(1, n, d, 1024, False, bm.device_slots(0)))
            if hasattr(bm, "device_slots") else (bm.binmax_chunk(1, d, False),))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [q.data_ptr(), emb.data_ptr(), mask.data_ptr(), n, 1, n, d, 1024, *plan,
            0, out.data_ptr(), stream]
    return {"wrapper": enqueue_us(lambda: bm.dense_binmax(q, emb, n, mask, 1024), reps),
            "launcher": enqueue_us(lambda: lib.ahrag_binmax(*args), reps),
            "empty": enqueue_us(lambda: torch.empty((1, 768), device=dev), reps),
            "current_stream": enqueue_us(lambda: torch.cuda.current_stream(dev).cuda_stream,
                                         reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_binmax_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ahrag_tpu_torch.ops import _build
    from ahrag_tpu_torch.ops import binmax as bm
    from ahrag_tpu_torch.ops.topk import binmax_eps

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for label, kernel, n, d, dtype, b, tile_n in SHAPES:
        tdt = getattr(torch, dtype)
        emb = torch.randn((n, d), generator=gen, device=dev)
        emb = (emb / emb.norm(dim=1, keepdim=True)).to(tdt)
        q = torch.randn((b, d), generator=gen, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).to(tdt)
        mask = torch.rand(n, generator=gen, device=dev) > 0.01
        t, g, es = n // tile_n, tile_n // 128, emb.element_size()
        if kernel == "binmax":
            fn = lambda: bm.dense_binmax(q, emb, n, mask, tile_n)
            ref = lambda: bm.dense_binmax_ref(q, emb, n, mask, tile_n)
            lib = lambda: torch.matmul(q, emb.T).view(b, t, g, 128).amax(2)
            wrapper = bm.dense_binmax
            nbytes = n * d * es + b * d * es + n + b * t * 128 * 4
        else:
            trivial = dtype == "bfloat16"
            fn = lambda: bm.dense_binmax2(q, emb, n, mask, tile_n, trivial)
            ref = lambda: bm.dense_binmax2_ref(q, emb, n, mask, tile_n, trivial)
            lib = lambda: torch.matmul(q, emb.T).view(b, t, g, 128).amax(2).amax(2)
            wrapper = bm.dense_binmax2
            nbytes = (n * d * es + b * d * es + (0 if trivial else n) + t * b * 128 * 4
                      + b * t * 4)
        outs, refs = fn(), ref()
        plan = getattr(wrapper, "last_plan", None)   # as launched; None before plans
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        if err > TOL[dtype]:
            raise RuntimeError(f"{label}: kernel and plain version differ by {err}")
        del outs, refs
        ms = cuda_ms(fn, args.reps)
        lib_ms = cuda_ms(lib, args.reps)
        host = {"enqueue_us": enqueue_us(fn, args.reps), "library_enqueue_us":
                enqueue_us(lib, args.reps), "device_ms": device_ms(fn, args.reps),
                "library_device_ms": device_ms(lib, args.reps)}
        flops = 2.0 * b * n * d
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[label] = {"ms": ms, "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "bound_share": max(t_ops, t_bytes) / ms, "max_abs_err": err,
                       "plan": list(plan) if plan else None,
                       **host}
        del emb, q, mask
    eps = {f"{d},{tile_n}": {"bfloat16": binmax_eps("cuda", d, tile_n, True),
                             "float32": binmax_eps("cuda", d, tile_n, False)}
           for d, tile_n in EPS_AT}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"root": args.root, "library": _build.build()["path"],
                      "device": torch.cuda.get_device_name(0), "reps": args.reps,
                      "rows": rows, "binmax_eps": eps, "cluster_slots":
                      bm.device_slots(0) if hasattr(bm, "device_slots") else None,
                      "host_us": host_breakdown(bm, args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
