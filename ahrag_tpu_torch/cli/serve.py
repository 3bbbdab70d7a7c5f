"""Serving CLI: the HTTP retrieval service over a saved graph, on the card.

    python -m ahrag_tpu_torch.cli.serve --graph DIR [--port 8080] [--device cpu]

Port of ``ahrag_tpu/cli/serve.py``. SIGTERM and SIGINT stop accepting
connections; batches in flight drain (``MicroBatcher.close`` joins its
threads within a bounded time) and the process exits.
"""
from __future__ import annotations

import argparse
import signal
import threading

from ahrag_tpu_torch.serve import RetrievalService, serve_http


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Serve retrieval over HTTP")
    ap.add_argument("--graph", default="graph")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--request-timeout-s", type=float, default=10.0,
                    help="per-request deadline; expired requests get HTTP 503")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    service = RetrievalService(graph_dir=args.graph, max_batch=args.max_batch,
                               max_wait_s=args.max_wait_ms / 1000.0,
                               request_timeout_s=args.request_timeout_s,
                               device=args.device)
    server = serve_http(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"({service.hg.number_of_nodes()} nodes, {service.device})", flush=True)

    def _stop(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.serve_forever()
    server.server_close()
    service.close()


if __name__ == "__main__":
    main()
