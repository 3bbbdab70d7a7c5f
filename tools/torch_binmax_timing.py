#!/usr/bin/env python3
"""Times the port's ``dense_binmax`` kernel at its serving shapes on one CUDA card.

    python3 tools/torch_binmax_timing.py [--root DIR] [--reps N]

Imports ``ahrag_tpu_torch`` from DIR (default: the repository that holds this
script), so that two trees, an unpacked parent commit and the working tree, can
be compared on the same card, run in turns (parent, change, change, parent).
On seeded random data made on the card (unit rows, a mask
with 1% of rows off, every row below n_valid) it times ``dense_binmax`` at
tile_n 1024 by CUDA events over ``--reps`` launches after a warm-up, at
1,067,008 x 384 bf16 with B = 4 and 64 and at 135,168 x 384 float32 with
B = 4, 16 and 64, beside one ``torch.matmul`` + ``amax`` (the library call)
and the bound (bytes or operations at the H100 SXM peaks); it checks the
kernel against ``dense_binmax_ref`` within the bin-max tolerance and reads
``binmax_eps`` at d = 384, tile_n = 1024 for both types.
Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-6, "float32": 1e-5}
SHAPES = (("1M bf16 B=4", 1067008, "bfloat16", 4), ("1M bf16 B=64", 1067008, "bfloat16", 64),
          ("131k f32 B=4", 135168, "float32", 4), ("131k f32 B=16", 135168, "float32", 16),
          ("131k f32 B=64", 135168, "float32", 64))


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
    from ahrag_tpu_torch.ops.binmax import dense_binmax, dense_binmax_ref
    from ahrag_tpu_torch.ops.topk import binmax_eps

    dev, d, tile_n = torch.device("cuda"), 384, 1024
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for label, n, dtype, b in SHAPES:
        tdt = getattr(torch, dtype)
        emb = torch.randn((n, d), generator=gen, device=dev)
        emb = (emb / emb.norm(dim=1, keepdim=True)).to(tdt)
        q = torch.randn((b, d), generator=gen, device=dev)
        q = (q / q.norm(dim=1, keepdim=True)).to(tdt)
        mask = torch.rand(n, generator=gen, device=dev) > 0.01
        t = n // tile_n
        err = (dense_binmax(q, emb, n, mask, tile_n)
               - dense_binmax_ref(q, emb, n, mask, tile_n)).abs().max().item()
        if err > TOL[dtype]:
            raise RuntimeError(f"{label}: kernel and plain version differ by {err}")
        ms = cuda_ms(lambda: dense_binmax(q, emb, n, mask, tile_n), args.reps)
        lib_ms = cuda_ms(lambda: torch.matmul(q, emb.T).view(b, t, 8, 128).amax(2), args.reps)
        flops = 2.0 * b * n * d
        nbytes = n * d * emb.element_size() + b * d * emb.element_size() + n + b * t * 128 * 4
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[label] = {"ms": ms, "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "bound_share": max(t_ops, t_bytes) / ms, "max_abs_err": err}
        del emb, q, mask
    eps = {"bfloat16": binmax_eps("cuda", d, tile_n, True),
           "float32": binmax_eps("cuda", d, tile_n, False)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"root": args.root, "library": _build.build()["path"],
                      "device": torch.cuda.get_device_name(0), "reps": args.reps,
                      "rows": rows, "binmax_eps": eps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
