"""Top-k backend ladder benchmark: flat / approx / bin-max / binned / refined.

Port of ``ahrag_tpu/cli/topk_bench.py``. Measures the dense retrieval coarse
stage at production shapes on one device and prints a JSON report with the
JAX package's keys. The corpus is drawn ON the device from a seeded
``torch.Generator`` (clustered geometry: 1,024 Gaussian centers plus noise,
rows normalised): a host draw of a 1M x 384 corpus would time the host.

Variants at each (N, B, D, k):
- flat:      float32 product + a masked stable top-k       (exact)
- approx:    ``lax.approx_max_k`` has no counterpart here: off the TPU, XLA
             computes it as an exact top-k, and so does this variant
             (``"approx_is_exact": true`` in its entry)
- binmax:    ``dense_binmax`` at tile_n 4096, the coarse stage alone
- binmax_hi: ``dense_binmax`` at tile_n 2048 (JAX's HIGHEST coarse pass: the
             port's float32 is IEEE and its bf16 products are exact, so
             "highest" needs no switch)
- binned:    ``binned_refined_topk(margin=4k+32, tile_n=4096)`` (certified)
- binned_hi: ``binned_refined_topk(margin=3k+2, tile_n=2048, select="approx")``
             (the port's "approx" selection is exact)
- refined:   ``refined_masked_topk(margin=16)``, the public path (at B = 256
             on the card: ``dense_binmax2`` and hierarchical selection)
Oracle: ``dense_topk_ref`` on 8 probe queries; each variant's final ids are
compared with it. Times come from CUDA events after a warm-up call on the
card, from the host clock on the CPU.

    python -m ahrag_tpu_torch.cli.topk_bench [--n N] [--b B] [--d D] [--k K]
        [--reps R] [--variants LIST] [--out FILE] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

DEFAULT_VARIANTS = "flat,approx,binmax,binned,refined"


def make_data(n: int, d: int, b: int, seed: int = 7, device="cuda",
              dtype: torch.dtype = torch.float32):
    """(q [b, d], emb [n, d]) unit rows of ``dtype`` drawn on ``device``:
    rows round 1,024 Gaussian centers with noise 0.3, queries likewise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((1024, d), generator=gen, device=device)
    e = centers[torch.randint(0, 1024, (n,), generator=gen, device=device)]
    e.add_(torch.randn((n, d), generator=gen, device=device).mul_(0.3))
    e.div_(torch.linalg.vector_norm(e, dim=1, keepdim=True))
    q = centers[torch.randint(0, 1024, (b,), generator=gen, device=device)]
    q = q + 0.3 * torch.randn((b, d), generator=gen, device=device)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    return q.to(dtype), e.to(dtype)


def _time(fn: Callable[[], Any], reps: int, device: torch.device) -> float:
    """Seconds per call over ``reps`` calls after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def run_ladder(n: int, b: int, d: int, k: int, reps: int = 10,
               variants: str = DEFAULT_VARIANTS, device: Optional[str] = None
               ) -> Dict[str, Any]:
    from ahrag_tpu_torch.device import f32_matmul, resolve_device, stable_topk
    from ahrag_tpu_torch.ops.binmax import NEG_INF, dense_binmax
    from ahrag_tpu_torch.ops.topk import (binned_refined_topk, dense_topk_ref, matmul_eps,
                                          refined_masked_topk)

    dev = resolve_device(device)
    q, e = make_data(n, d, b, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    out: Dict[str, Any] = {
        "n": n, "b": b, "d": d, "k": k, "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "eps": matmul_eps(dev.type, d, False)}
    _, oi = dense_topk_ref(q[:8], e, n, k)
    gflop = 2.0 * b * n * d / 1e9
    hbm_gb = (n * d * 4 + b * n * 4) / 1e9  # corpus read + score write (flat)
    corpus_gb = n * d * e.element_size() / 1e9

    def mismatch(ids: torch.Tensor) -> int:
        return int((ids[:8] != oi).sum())

    def timed(name: str, fn: Callable[[], Any]) -> Any:
        dt = _time(fn, reps, dev)
        out[name] = {"ms": dt * 1e3, "qps": b / dt, "tflops": gflop / dt / 1e3}
        return fn()

    def exact_topk():
        return stable_topk(torch.where(mask[None, :], f32_matmul(q, e.T), NEG_INF), k)

    wanted = set(variants.split(","))
    if "flat" in wanted:
        out_f = timed("flat", exact_topk)
        out["flat"]["oracle_mismatch"] = mismatch(out_f[1])
    if "approx" in wanted:
        out_a = timed("approx", exact_topk)
        out["approx"].update(oracle_mismatch=mismatch(out_a[1]), approx_is_exact=True)
    if "binmax" in wanted and n % 4096 == 0:
        timed("binmax", lambda: dense_binmax(q, e, n, mask, tile_n=4096))
        out["binmax"].update(hbm_stream_gb=corpus_gb, gbps=corpus_gb * 1e3 / out["binmax"]["ms"])
    if "binned" in wanted and n % 4096 == 0:
        _, bi, cert = timed("binned", lambda: binned_refined_topk(
            q, e, mask, k, margin=4 * k + 32, tile_n=4096))
        out["binned"].update(oracle_mismatch=mismatch(bi), cert_rate=float(cert.float().mean()))
    if "binmax_hi" in wanted and n % 2048 == 0:
        timed("binmax_hi", lambda: dense_binmax(q, e, n, mask, tile_n=2048))
        out["binmax_hi"]["gbps"] = corpus_gb * 1e3 / out["binmax_hi"]["ms"]
    if "binned_hi" in wanted and n % 2048 == 0:
        _, bi, cert = timed("binned_hi", lambda: binned_refined_topk(
            q, e, mask, k, margin=3 * k + 2, tile_n=2048, select="approx"))
        out["binned_hi"].update(oracle_mismatch=mismatch(bi),
                                cert_rate=float(cert.float().mean()))
    if "refined" in wanted:
        _, ri = timed("refined", lambda: refined_masked_topk(q, e, mask, k, margin=16))
        out["refined"]["oracle_mismatch"] = mismatch(ri)
    out["flat_hbm_model_gb"] = hbm_gb
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res = run_ladder(args.n, args.b, args.d, args.k, reps=args.reps,
                     variants=args.variants, device=args.device)
    print(json.dumps(res, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(res, fh, indent=2)


if __name__ == "__main__":
    main()
