#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ahrag_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA bin-max kernels from ``ahrag_tpu_torch/ops/csrc`` and then,
in phases that each print their wall time:

  1. builds the kernels (nvcc, seconds);
  2. holds each kernel against its plain PyTorch version on the card: bf16
     and float32, masked and trivial, D = 384, 6 tiles, several batch sizes;
  3. the 1,048,576-entity bench rung (1,067,008 nodes, bf16, B = 512) through
     ``hybrid_search_batch``: rank parity against the CPU reference on 8
     queries, the certificate audit on 64, the certified share, the kernels'
     launch counts and the batch time over 12 varied batches;
  4. the 131,072-entity rung in float32 with B = 2048, the same checks;
  5. serving: 4 text queries through ``pack_queries`` and
     ``encode_and_search`` against the 1M-node graph, the card's ids held
     against the same call on the CPU;

and prints the kernels' JSON line (times at the main-path shapes, bounds,
launch counts, errors), the card's name and power limit, and last the
contract line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 on the tensor cores, float32
# outside them, HBM3 bandwidth. The bin-max kernels' products are bf16 for bf16
# storage and IEEE float32 for float32 storage.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-6, "float32": 1e-5}   # bf16 products are exact: only summation order differs

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
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


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def reset_counts() -> None:
    from ahrag_tpu_torch.ops.binmax import dense_binmax, dense_binmax2
    dense_binmax2.launches = 0
    dense_binmax.launches = 0


def read_counts() -> dict:
    from ahrag_tpu_torch.ops.binmax import dense_binmax, dense_binmax2
    return {"binmax2_cuda": dense_binmax2.launches, "binmax_cuda": dense_binmax.launches}


def phase_kernels_vs_plain(dev) -> dict:
    """Both kernels against their plain versions on small real-width inputs."""
    import torch
    from ahrag_tpu_torch.ops.binmax import (dense_binmax, dense_binmax2,
                                            dense_binmax2_ref, dense_binmax_ref)
    gen = torch.Generator().manual_seed(0)
    n, d, tile_n = 6 * 1024, 384, 1024
    err = {"binmax2_cuda": 0.0, "binmax_cuda": 0.0}

    def unit(rows):
        x = torch.randn((rows, d), generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        emb = unit(n).to(dev, dtype)
        mask = (torch.rand(n, generator=gen) > 0.2).to(dev)
        n_valid = n - 300
        for b in (128, 512):
            q = unit(b).to(dev, dtype)
            for trivial in (False, True):
                bins, smax = dense_binmax2(q, emb, n_valid, mask, tile_n, trivial)
                rb, rs = dense_binmax2_ref(q, emb, n_valid, mask, tile_n, trivial)
                e = max((bins - rb).abs().max().item(), (smax - rs).abs().max().item())
                log(f"  binmax2 {dtype} B={b} trivial={trivial}: max|kernel-plain| {e:.3e}")
                check(e <= tol, f"binmax2 {dtype} B={b} trivial={trivial} err {e} > {tol}")
                err["binmax2_cuda"] = max(err["binmax2_cuda"], e)
        for b in (5, 16, 128):
            q = unit(b).to(dev, dtype)
            out = dense_binmax(q, emb, n_valid, mask, tile_n)
            e = (out - dense_binmax_ref(q, emb, n_valid, mask, tile_n)).abs().max().item()
            log(f"  binmax {dtype} B={b}: max|kernel-plain| {e:.3e}")
            check(e <= tol, f"binmax {dtype} B={b} err {e} > {tol}")
            err["binmax_cuda"] = max(err["binmax_cuda"], e)
    torch.cuda.synchronize()
    return err


def kernel_row(name, kernel, plain, library, flops, nbytes, dtype, reps) -> dict:
    """Times and error of one kernel at one shape (launches filled in later)."""
    import torch
    out, ref = kernel(), plain()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    e = max((a - b).abs().max().item() for a, b in zip(outs, refs))
    check(e <= TOL[dtype], f"{name} at the main-path shape: err {e} > {TOL[dtype]}")
    del out, ref, outs, refs
    torch.cuda.synchronize()
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, max(2, reps // 4))
    library_ms = cuda_ms(library, reps)
    b_ms, b_by = bound(flops, nbytes, dtype)
    return {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def run_rung(dev, n_entities: int, n_queries: int, emb_dtype: str) -> dict:
    """Build one bench rung on the card and drive hybrid search through it."""
    import numpy as np
    import torch
    from ahrag_tpu_torch.bench_data import (bench_queries, bench_tensors,
                                            build_bench_arrays, certificate_audit,
                                            cpu_reference_search, round_bf16)
    from ahrag_tpu_torch.graph.search import (SEM_FLUSH_EPS, SearchWeights,
                                              hybrid_search_batch)
    from ahrag_tpu_torch.ops.topk import refined_masked_topk_cert

    t0 = time.perf_counter()
    arrs = build_bench_arrays(n_entities, max(8, n_entities // 64))
    if emb_dtype == "bfloat16":
        # the oracle scores the same bf16-rounded values the device stores
        arrs.emb = round_bf16(arrs.emb)
    q_mat = bench_queries(arrs, n_queries)
    if emb_dtype == "bfloat16":
        q_mat = round_bf16(q_mat)
    log(f"  host arrays: {arrs.n} nodes, {time.perf_counter() - t0:.1f}s")

    reset_counts()   # the main path: index build (eps calibration) + search
    t0 = time.perf_counter()
    gt = bench_tensors(arrs, emb_dtype, device=dev)
    w = SearchWeights.create(device=dev)
    q_dev = torch.from_numpy(q_mat).to(dev)
    res = hybrid_search_batch(gt, q_dev, w, top_k=5, member_top_m=5)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    variants = [q_dev] + [torch.roll(q_dev, 1 + 7 * v, dims=0) for v in range(3)]
    reps = 12
    batches = itertools.cycle(variants)
    batch_ms = cuda_ms(lambda: hybrid_search_batch(
        gt, next(batches), w, top_k=5, member_top_m=5), reps)
    counts = read_counts()
    log(f"  n_pad {gt.n_pad}, build+first batch {first_s:.1f}s, batch_ms "
        f"{batch_ms:.3f}, launches {counts}")

    dev_ids = [[int(i) for i, ok in zip(res.reranked_idx[b].tolist(),
                                        res.reranked_valid[b].tolist()) if ok]
               for b in range(8)]
    mism = sum([i for i, _ in cpu_reference_search(arrs, q_mat[b])] != dev_ids[b]
               for b in range(8))
    audit = certificate_audit(gt, q_dev, res)
    _, _, cert = refined_masked_topk_cert(
        q_dev, gt.emb, gt.indexed & gt.valid, 5, margin=12,
        flush_eps=SEM_FLUSH_EPS, mask_trivial=gt.mask_trivial,
        emb_binpack=gt.emb_binpack)
    out = {"n_nodes": arrs.n, "n_pad": gt.n_pad, "emb_dtype": emb_dtype,
           "n_queries": n_queries, "parity_mismatches_of_8": int(mism),
           "cert_audit": audit, "certified_share": float(cert.float().mean()),
           "batch_ms": batch_ms, "qps": n_queries / batch_ms * 1e3,
           "batches_timed": reps, "launches": counts}
    log(f"  {json.dumps(out)}")
    check(mism == 0, f"rank parity {mism}/8 at {arrs.n} nodes")
    check(audit["audit_mismatches"] == 0, f"certificate audit {audit}")
    check(np.isfinite(res.reranked_score.cpu().numpy()).all(), "finite scores")
    check(counts["binmax2_cuda"] > 0, "binmax2 kernel launched on the path")
    check(counts["binmax_cuda"] > 0, "binmax kernel launched on the path (calibration)")
    return {"gt": gt, "arrs": arrs, "q_dev": q_dev, "w": w, "rung": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from ahrag_tpu_torch.ops import _build
    from ahrag_tpu_torch.ops.binmax import (dense_binmax, dense_binmax2,
                                            dense_binmax2_ref, dense_binmax_ref)

    dev = torch.device("cuda")
    smi = smi_line()
    log(f"phase 0: {smi}; python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t = time.perf_counter()
    info = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    log(f"phase 1: kernels built in {info['seconds']:.1f}s (built={info['built']}) "
        f"-> {info['path']}")
    for ln in regs:
        log(f"  ptxas: {ln}")

    t = time.perf_counter()
    errs = phase_kernels_vs_plain(dev)
    log(f"phase 2: kernels vs plain done in {time.perf_counter() - t:.1f}s: {errs}")

    t = time.perf_counter()
    log("phase 3: 1M-entity rung, bf16, B=512")
    r1 = run_rung(dev, 1048576, 512, "bfloat16")
    gt, q = r1["gt"], r1["q_dev"][:512].to(torch.bfloat16).contiguous()
    n, d = gt.n_pad, gt.dim
    mask = gt.indexed & gt.valid
    trivial = gt.mask_trivial
    tiles = n // 1024
    rows = {}
    rows["binmax2_cuda"] = kernel_row(
        "binmax2_cuda",
        lambda: dense_binmax2(q, gt.emb, n, mask, 1024, trivial),
        lambda: dense_binmax2_ref(q, gt.emb, n, mask, 1024, trivial),
        lambda: torch.matmul(q, gt.emb.T).view(512, tiles, 8, 128).amax(2).amax(2),
        2.0 * 512 * n * d,
        n * d * 2 + 512 * d * 2 + (0 if trivial else n) + tiles * 512 * 128 * 4 + 512 * tiles * 4,
        "bfloat16", reps=10)
    q4 = q[:4].contiguous()
    rows["binmax_cuda"] = kernel_row(
        "binmax_cuda",
        lambda: dense_binmax(q4, gt.emb, n, mask, 1024),
        lambda: dense_binmax_ref(q4, gt.emb, n, mask, 1024),
        lambda: torch.matmul(q4, gt.emb.T).view(4, tiles, 8, 128).amax(2),
        2.0 * 4 * n * d, n * d * 2 + 4 * d * 2 + n + 4 * tiles * 128 * 4,
        "bfloat16", reps=20)
    log(f"phase 3 done in {time.perf_counter() - t:.1f}s; kernel rows {json.dumps(rows)}")

    t = time.perf_counter()
    log("phase 4: 131072-entity rung, float32, B=2048")
    r2 = run_rung(dev, 131072, 2048, "float32")
    gt2 = r2["gt"]
    q2 = r2["q_dev"][:1024].contiguous()
    n2, t2 = gt2.n_pad, gt2.n_pad // 1024
    mask2 = gt2.indexed & gt2.valid
    f32_row = kernel_row(
        "binmax2_cuda f32",
        lambda: dense_binmax2(q2, gt2.emb, n2, mask2, 1024, gt2.mask_trivial),
        lambda: dense_binmax2_ref(q2, gt2.emb, n2, mask2, 1024, gt2.mask_trivial),
        lambda: torch.matmul(q2, gt2.emb.T).view(1024, t2, 8, 128).amax(2).amax(2),
        2.0 * 1024 * n2 * d,
        n2 * d * 4 + 1024 * d * 4 + t2 * 1024 * 128 * 4 + 1024 * t2 * 4,
        "float32", reps=10)
    log(f"phase 4 done in {time.perf_counter() - t:.1f}s; binmax2 at the f32 "
        f"chunk shape (B=1024, n_pad {n2}): {json.dumps(f32_row)}")
    del r2, gt2, q2, mask2

    t = time.perf_counter()
    log("phase 5: serve 4 text queries against the 1M-node graph")
    import numpy as np
    from ahrag_tpu_torch.bench_data import bench_tensors
    from ahrag_tpu_torch.graph.search import SearchWeights
    from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder
    from ahrag_tpu_torch.serve import encode_and_search, pack_queries
    texts = ["who directed the 1994 biographical film ed wood",
             "american superhero film directed by scott derrickson",
             "hierarchical retrieval over topic summaries",
             "community of film directors and their works"]
    enc = HashedNGramEncoder(dim=d, device=dev)
    idf = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 2.0, enc.buckets).astype(np.float32))
    n_q, n_rows, packed = pack_queries(texts, enc)
    reset_counts()
    t_s = time.perf_counter()
    out_gpu = encode_and_search(packed, enc._proj, idf.to(dev), gt, r1["w"],
                                n_rows=n_rows, top_k=5, member_top_m=5).cpu()
    serve_ms = (time.perf_counter() - t_s) * 1e3
    serve_counts = read_counts()
    gt_cpu = bench_tensors(r1["arrs"], "bfloat16", device="cpu")
    out_cpu = encode_and_search(packed, enc._proj.cpu(), idf, gt_cpu,
                                SearchWeights.create(device="cpu"),
                                n_rows=n_rows, top_k=5, member_top_m=5)
    ids_gpu = out_gpu[:n_q, :, 0].long().tolist()
    ids_cpu = out_cpu[:n_q, :, 0].long().tolist()
    score_err = (out_gpu[:n_q] - out_cpu[:n_q]).abs().max().item()
    log(f"  bucket {n_rows}, packed {packed.shape}, first call {serve_ms:.1f} ms, "
        f"launches {serve_counts}, ids cuda {ids_gpu}, max|cuda-cpu| {score_err:.3e}")
    check(ids_gpu == ids_cpu, f"serve ids cuda {ids_gpu} != cpu {ids_cpu}")
    check(bool((out_gpu[:n_q, :, 3] == out_cpu[:n_q, :, 3]).all()), "serve valid flags")
    check(score_err <= 1e-5, f"serve scores differ by {score_err}")
    check(serve_counts["binmax_cuda"] > 0, "binmax kernel launched by the serve bucket")
    log(f"phase 5 done in {time.perf_counter() - t:.1f}s")

    path_counts = {k: r1["rung"]["launches"][k] + serve_counts[k] for k in rows}
    kernels = []
    for name, replaces in (("binmax2_cuda", "ahrag_tpu/ops/topk.py:651"),
                           ("binmax_cuda", "ahrag_tpu/ops/topk.py:554")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "ahrag_tpu_torch/ops/csrc/binmax.cu",
                        "replaces": replaces, "launches": path_counts[name],
                        **rows[name]})
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], errs[k["name"]])
    log(f"total wall {time.perf_counter() - _T0:.1f}s")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
