"""Closed-loop serving load test: concurrent callers through the micro-batcher.

    python -m ahrag_tpu_torch.cli.serve_bench --graph DIR --threads 16 \
        --requests 32 [--sweep 8,16,32,64] [--device cpu] [--out report.json]

Port of ``ahrag_tpu/cli/serve_bench.py``: drives ``RetrievalService.search``
from N threads (each request one query, coalesced into device batches) and
reports per-request latency percentiles, sustained throughput and the
batcher's coalescing.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List


def run_load(service, queries: List[str], threads: int, requests_per_thread: int,
             warmup: int = 4) -> dict:
    """Fire ``threads`` closed-loop callers, each issuing ``requests_per_thread``
    sequential single-query searches; return the latency/throughput report.
    Every batch bucket reachable at this concurrency is served ``warmup``
    times first, off the clock; the service's latency samples and stage
    timers are reset after it, so the report covers the measured window."""
    for _ in range(max(1, warmup)):
        b = 1
        while True:
            service.search_many(queries[:1] * b)
            if b >= min(threads, service._batcher.max_batch):
                break
            b = service._bucket(b + 1)
    service.latency.reset()
    service.timers.reset()
    n = threads * requests_per_thread
    # a pool of ``threads`` workers over the n requests is ``threads`` callers
    # in a closed loop: each worker takes its next request when one returns
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futures = [pool.submit(service.search, queries[j % len(queries)])
                   for j in range(n)]
        errors = [str(f.exception()) for f in futures if f.exception() is not None]
    wall_s = time.perf_counter() - t0
    lat = service.latency.snapshot().get("request", {})
    return {"threads": threads, "requests": n, "wall_s": round(wall_s, 4),
            "qps": round(n / wall_s, 1), "errors": len(errors),
            "latency_ms": {k: round(v, 3) for k, v in lat.items()},
            "batcher": service._batcher.stats(),
            "server_timers": service.timers.snapshot()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Serving latency/throughput load test")
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32, help="requests per thread")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queries", default=None,
                    help="optional text file, one query per line")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated max_batch values to compare "
                         "(e.g. '8,16,32,64'); overrides --max-batch")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    args = ap.parse_args(argv)

    from ahrag_tpu_torch.graph import HierarchicalGraph
    from ahrag_tpu_torch.serve import RetrievalService

    hg = HierarchicalGraph.load(args.graph, device=args.device)
    if args.queries:
        with open(args.queries) as f:
            queries = [ln.strip() for ln in f if ln.strip()]
    else:
        queries = [f"tell me about {n.get('name') or n.get('title') or 'this'}"
                   for n in list(hg.nodes.values())[:64]] or ["overview"]

    batches = ([int(x) for x in args.sweep.split(",")] if args.sweep
               else [args.max_batch])
    runs = []
    for mb in batches:
        service = RetrievalService(hg=hg, max_batch=mb,
                                   max_wait_s=args.max_wait_ms / 1e3, device=hg.device)
        rep = run_load(service, queries, args.threads, args.requests)
        service.close()
        rep["max_batch"] = mb
        rep["device"] = str(hg.device)
        runs.append(rep)
        print(f"max_batch={mb}: qps={rep['qps']} "
              f"p99={rep['latency_ms'].get('p99_ms')}ms", flush=True)
    report = runs[0] if len(runs) == 1 else {
        "sweep": runs,
        "best_p99": min(runs, key=lambda r: r["latency_ms"].get("p99_ms", 1e9))["max_batch"]}
    print(json.dumps(report, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
