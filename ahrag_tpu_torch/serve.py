"""Serving layer: device-resident retrieval service with micro-batching.

Port of ``ahrag_tpu/serve.py``:

- ``pack_queries`` (host featurize + pack) and ``encode_and_search`` (one
  upload, then scatter, project and hybrid search on the graph's device) are
  the two halves of the hashed-encoder serving path;
- ``MicroBatcher`` coalesces concurrent single requests into batches and runs
  them through a pipeline of stages in threads;
- ``RetrievalService`` holds a graph's tensors on its device and answers
  ``search`` (coalesced), ``search_many``, ``beam`` and ``answer`` (the
  agent and answer modules over the same graph);
- ``serve_http``: JSON endpoints POST /search {"query" | "queries"},
  POST /beam, POST /answer, GET /healthz and GET /stats.

The service pipelines three stages, as in the JAX package: featurize + pack
on the host; upload and dispatch; read back and assemble the results. In
the JAX package the dispatch returns before the device finishes; here
``encode_and_search`` waits once inside, for the certificate of the seed
stage (``refined_masked_topk``), so the dispatch stage holds its thread for
the seed stage and the read-back stage for the rest.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.agent.agent import AHRAG_Agent
from ahrag_tpu_torch.agent.environment import GraphEnvironment
from ahrag_tpu_torch.agent.inference import InferenceEngine
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.graph.beam import beam_search_batch
from ahrag_tpu_torch.graph.host import HierarchicalGraph
from ahrag_tpu_torch.graph.search import SearchWeights, hybrid_search_batch
from ahrag_tpu_torch.graph.tensors import GraphTensors
from ahrag_tpu_torch.models.encoder.hashed import (HashedNGramEncoder,
                                                   _project_normalize_sparse)
from ahrag_tpu_torch.utils.profiling import LatencyRecorder, Timers

BATCH_BUCKETS = (1, 4, 16, 64, 256)


def batch_bucket(n: int) -> int:
    """Batches pad to a few fixed sizes (1, 4, 16, 64, 256, then multiples of
    256), which bounds the distinct shapes the device sees."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def pack_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int,
             buckets: int) -> np.ndarray:
    """Pack COO feature triplets of an ``n_rows`` batch into ONE float32 array.

    The nnz cap is ``max(4096, 128 * n_rows)``, doubled until the features
    fit. Layout ``[cap, 2]`` holds (row * buckets + col, val) while that key
    is exact in float32, ``(n_rows + 1) * buckets < 2**24``; otherwise
    ``[cap, 3]`` holds (row, col, val). Padding entries point at the dump row
    ``n_rows``."""
    nnz = len(rows)
    cap = max(4096, 128 * n_rows)
    while cap < nnz:
        cap *= 2
    if (n_rows + 1) * buckets < (1 << 24):
        packed = np.zeros((cap, 2), np.float32)
        packed[:nnz, 0] = rows.astype(np.int64) * buckets + cols.astype(np.int64)
        packed[:nnz, 1] = vals
        packed[nnz:, 0] = n_rows * buckets
    else:
        packed = np.zeros((cap, 3), np.float32)
        packed[:nnz, 0] = rows
        packed[:nnz, 1] = cols
        packed[:nnz, 2] = vals
        packed[nnz:, 0] = n_rows
    return packed


def pack_queries(queries: List[str], encoder: HashedNGramEncoder, assoc=None
                 ) -> Tuple[int, int, np.ndarray]:
    """Featurize on the host (the threaded C++ featurizer) and pack the sparse
    features into ONE float32 array (``pack_coo``), so a batch costs a single
    upload. Returns (n, n_rows, packed), where ``n_rows`` is the bucketed
    batch, padded with empty queries.

    ``assoc`` (from ``train_associations``) adds the query-side association
    expansion, as the JAX serving stage does when its graph carries one."""
    padded = queries + [""] * (batch_bucket(len(queries)) - len(queries))
    rows, cols, vals = encoder._coo_block(padded)
    if assoc is not None:
        rows, cols, vals = encoder.expand_coo(rows, cols, vals, assoc)
    return len(queries), len(padded), pack_coo(rows, cols, vals, len(padded),
                                               encoder.buckets)


def encode_and_search(coo_packed: np.ndarray, proj: torch.Tensor,
                      idf: torch.Tensor, gt: GraphTensors, w: SearchWeights, *,
                      n_rows: int, top_k: int, member_top_m: int) -> torch.Tensor:
    """Packed sparse query features -> embeddings -> hybrid search, on the
    graph's device. ``coo_packed`` (see ``pack_queries``) is uploaded once.

    Returns ONE [n_rows, top_k, 4] float32 tensor of (reranked_idx,
    reranked_score, reranked_sem, reranked_valid), so the result comes back
    in a single copy (ids are exact in float32 below 2**24 nodes)."""
    coo = torch.from_numpy(coo_packed).to(gt.device)
    if coo.shape[-1] == 2:
        buckets = proj.shape[0]
        key = coo[:, 0].long()
        rows = key // buckets
        cols = key - rows * buckets
        vals = coo[:, 1]
    else:
        rows = coo[:, 0].long()
        cols = coo[:, 1].long()
        vals = coo[:, 2]
    q = _project_normalize_sparse(rows, cols, vals, proj, idf, n_rows)
    res = hybrid_search_batch(gt, q, w, top_k=top_k, member_top_m=member_top_m)
    return torch.stack([res.reranked_idx.float(), res.reranked_score,
                        res.reranked_sem, res.reranked_valid.float()], dim=-1)


class _StageQueue:
    """Bounded hand-off between pipeline stages; depth 2 keeps at most one
    batch queued while the consumer works (deeper queues add latency, not
    qps). ``put(None)`` is the drain sentinel and bypasses the bound."""

    def __init__(self, depth: int = 2) -> None:
        self._items: List[Any] = []
        self._cv = threading.Condition()
        self._depth = depth

    def put(self, entry: Any) -> None:
        with self._cv:
            while entry is not None and len(self._items) >= self._depth:
                self._cv.wait()
            self._items.append(entry)
            self._cv.notify_all()

    def get(self) -> Any:
        with self._cv:
            while not self._items:
                self._cv.wait()
            entry = self._items.pop(0)
            self._cv.notify_all()
            return entry

    def drain(self) -> List[Any]:
        with self._cv:
            items, self._items = self._items, []
            self._cv.notify_all()
            return [e for e in items if e is not None]


class MicroBatcher:
    """Coalesce concurrent single requests into batched, pipelined calls.

    ``submit(item)`` blocks until the batch containing it is processed;
    batches flush when ``max_batch`` items collect or ``max_wait_s`` elapses
    after the first pending item.

    Pipelining: ``stages=[s1, ..., sk]`` splits batch processing into k
    stages; the worker coalesces a batch and runs s1, every further stage runs
    in its own thread(s) fed by a bounded queue, and the last stage's return
    value is the per-item results list. Up to k batches are in flight at
    different pipeline positions, so sustained throughput is set by the
    slowest stage, not the sum. The ``process``/``finalize`` pair maps to 1
    or 2 stages. ``mid_stage_workers`` and ``last_stage_workers`` run the
    middle and last stages in that many threads; results publish per
    generation, so out-of-order completion is safe.

    Quiet-window coalescing (``coalesce_quiet_s`` > 0): while submissions
    keep arriving, the flush deadline moves ``coalesce_quiet_s`` past each
    arrival, up to ``coalesce_cap_s`` after the first.

    Submitters wait on a per-generation ``Event``, never on the shared
    condition: with hundreds of callers a shared ``notify_all`` per submit
    would wake every one of them.
    """

    def __init__(self, process: Optional[Callable[[List[Any]], List[Any]]] = None,
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 finalize: Optional[Callable[[Any], List[Any]]] = None,
                 stages: Optional[List[Callable[[Any], Any]]] = None,
                 last_stage_workers: int = 1,
                 mid_stage_workers: int = 1,
                 coalesce_quiet_s: float = 0.0,
                 coalesce_cap_s: float = 0.05) -> None:
        self._quiet_s = float(coalesce_quiet_s)
        self._coalesce_cap_s = float(coalesce_cap_s)
        if stages is None:
            if process is None:
                raise ValueError("need process or stages")
            stages = [process] + ([finalize] if finalize is not None else [])
        self._stages: List[Callable[[Any], Any]] = list(stages)
        self._last_workers = max(1, int(last_stage_workers)
                                 if len(self._stages) > 1 else 1)
        self._mid_workers = max(1, int(mid_stage_workers)
                                if len(self._stages) > 2 else 1)
        self._drained = [threading.Event() for _ in self._stages]
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._lock = threading.Condition()
        self._pending: List[Any] = []
        # generation -> [("ok", results) | ("err", exc), remaining_readers]:
        # keyed per generation, so that a submitter woken late reads its own
        # batch; an entry goes once every submitter of it has read
        self._results: Dict[int, List[Any]] = {}
        self._events: Dict[int, threading.Event] = {}  # gen -> submitter wakeup
        self._abandoned: Dict[int, int] = {}   # gen -> timed-out submitters
        self._generation = 0
        self._inflight: Dict[int, int] = {}    # gen -> batch_len, inside pipeline
        self._poisoned: set = set()            # gens error-published by close()
        self._closed = False
        self.n_batches = 0
        self.n_items = 0
        self.max_batch_seen = 0
        self._queues = [_StageQueue() for _ in range(len(self._stages) - 1)]
        self._stage_threads = [
            threading.Thread(target=self._run_stage, args=(i,), daemon=True)
            for i in range(1, len(self._stages))
            for _ in range(self._stage_workers(i))]
        for t in self._stage_threads:
            t.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _stage_workers(self, i: int) -> int:
        """Worker threads of stage i (stage 0 runs in the coalescing worker)."""
        if i == 0:
            return 1
        return (self._last_workers if i == len(self._stages) - 1
                else self._mid_workers)

    def _publish(self, gen: int, batch_len: int, payload: tuple) -> None:
        with self._lock:
            self._inflight.pop(gen, None)
            readers = batch_len - self._abandoned.pop(gen, 0)
            ev = self._events.pop(gen, None)
            if (readers > 0 and gen not in self._results
                    and gen not in self._poisoned):
                # (close() may already have error-published this gen after a
                # drain timeout; its submitters are gone, so ours is dropped)
                self._results[gen] = [payload, readers]
            if ev is not None:
                ev.set()
            self._lock.notify()    # a pipeline slot freed: wake the worker

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if self._closed and not self._pending:
                    break
                now = time.monotonic()
                deadline = now + self.max_wait_s
                hard_deadline = now + max(self._coalesce_cap_s, self.max_wait_s)
                last_n = len(self._pending)
                # coalesce until the deadline, and on while every pipeline
                # stage is busy: flushing then would only park the batch in a
                # stage queue, while waiting grows it (_publish notifies when
                # a slot frees)
                capacity = (len(self._stages) + self._last_workers - 1
                            + (len(self._stages) - 2) * (self._mid_workers - 1))
                while (len(self._pending) < self.max_batch
                       and not self._closed
                       and (time.monotonic() < deadline
                            or len(self._inflight) >= capacity)):
                    remaining = deadline - time.monotonic()
                    self._lock.wait(timeout=remaining if remaining > 0 else None)
                    if self._quiet_s > 0.0:
                        n = len(self._pending)
                        if n > last_n:
                            last_n = n
                            deadline = min(hard_deadline,
                                           max(deadline, time.monotonic() + self._quiet_s))
                batch = self._pending
                gen = self._generation
                self._pending = []
                self._generation += 1
                self._inflight[gen] = len(batch)
                self.n_batches += 1
                self.n_items += len(batch)
                self.max_batch_seen = max(self.max_batch_seen, len(batch))
            try:
                token = self._stages[0](batch)
            except Exception as exc:
                # hand the failure to this batch's submitters and keep the
                # worker alive for the batches behind it
                self._publish(gen, len(batch), ("err", exc))
                continue
            if not self._queues:
                self._finish(gen, len(batch), token)
            else:
                self._queues[0].put((gen, len(batch), token))
        if self._queues:
            self._queues[0].put(None)             # drain sentinel

    def _finish(self, gen: int, batch_len: int, results: Any) -> None:
        if not hasattr(results, "__len__"):
            payload = ("err", TypeError(f"stage returned {type(results).__name__}, "
                                        "not a sequence of results"))
        elif len(results) != batch_len:
            payload = ("err", RuntimeError(f"stage returned {len(results)} results "
                                           f"for {batch_len} items"))
        else:
            payload = ("ok", results)
        self._publish(gen, batch_len, payload)

    def _run_stage(self, i: int) -> None:
        q_in = self._queues[i - 1]
        q_out = self._queues[i] if i < len(self._queues) else None
        while True:
            entry = q_in.get()
            if entry is None:
                if self._stage_workers(i) > 1:
                    q_in.put(None)   # rebroadcast so sibling workers exit too
                if q_out is not None and not self._drained[i].is_set():
                    self._drained[i].set()   # forward ONE sentinel downstream
                    q_out.put(None)
                return
            gen, batch_len, token = entry
            try:
                out = self._stages[i](token)
            except Exception as exc:
                self._publish(gen, batch_len, ("err", exc))
                continue
            if q_out is None:
                self._finish(gen, batch_len, out)
            else:
                q_out.put((gen, batch_len, out))

    def submit(self, item: Any, timeout_s: Optional[float] = None) -> Any:
        """Block until the batch containing ``item`` is processed.

        ``timeout_s`` bounds the wait: a wedged device or a pathological batch
        fails this caller with ``TimeoutError`` instead of holding its thread
        (and the HTTP connection behind it). The item stays in its batch; the
        abandoned count keeps the reader bookkeeping right when it completes.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            gen = self._generation
            index = len(self._pending)
            self._pending.append(item)
            ev = self._events.get(gen)
            if ev is None:
                ev = self._events[gen] = threading.Event()
            self._lock.notify()  # the worker is the only _lock waiter
        got = ev.wait(timeout=timeout_s)
        with self._lock:
            if gen not in self._results:
                if not got:
                    self._abandoned[gen] = self._abandoned.get(gen, 0) + 1
                    raise TimeoutError(f"request timed out after {timeout_s}s "
                                       f"awaiting batch {gen}")
                raise RuntimeError("batcher closed before batch completed")
            entry = self._results[gen]
            entry[1] -= 1
            if entry[1] == 0:
                del self._results[gen]
            kind, data = entry[0]
            if kind == "err":
                raise RuntimeError(f"batch processing failed: {data!r}") from data
            return data[index]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"batches": self.n_batches, "items": self.n_items,
                    "mean_batch": self.n_items / max(1, self.n_batches),
                    "max_batch": self.max_batch_seen}

    def close(self, drain_timeout_s: float = 5.0) -> None:
        """Stop accepting submissions and drain: already-queued batches still
        flush (blocked submitters get their results), then the threads exit.
        ``drain_timeout_s`` bounds the join; if work is still in the pipeline
        then, every still-pending submitter is released with an error."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        deadline = time.monotonic() + drain_timeout_s
        self._worker.join(timeout=drain_timeout_s)
        for t in self._stage_threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        wedged = self._worker.is_alive() or any(t.is_alive() for t in self._stage_threads)
        if not wedged:
            return
        exc = RuntimeError(f"batcher drain exceeded {drain_timeout_s}s; pipeline still busy")
        for q in self._queues:                    # unprocessed inter-stage work
            q.drain()
        with self._lock:
            if self._pending:
                # the worker never picked this batch up: publish the failure
                # under its generation so that its submitters wake
                gen = self._generation
                readers = len(self._pending) - self._abandoned.pop(gen, 0)
                self._pending = []
                self._generation += 1
                self._poisoned.add(gen)
                if readers > 0:
                    self._results[gen] = [("err", exc), readers]
                ev = self._events.pop(gen, None)
                if ev is not None:
                    ev.set()
            # batches wedged inside the pipeline: release their waiters;
            # _poisoned keeps a late completion from resurrecting the gen
            for gen, size in list(self._inflight.items()):
                readers = size - self._abandoned.pop(gen, 0)
                self._poisoned.add(gen)
                if readers > 0 and gen not in self._results:
                    self._results[gen] = [("err", exc), readers]
                ev = self._events.pop(gen, None)
                if ev is not None:
                    ev.set()
            self._inflight.clear()


class RetrievalService:
    """A graph on its device behind the micro-batched serving pipeline."""

    def __init__(self, graph_dir: str = "graph", hg: Optional[HierarchicalGraph] = None,
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 request_timeout_s: Optional[float] = 10.0,
                 coalesce_quiet_s: float = 0.0015,
                 coalesce_cap_s: Optional[float] = None, device=None) -> None:
        """Serve ``hg``, or the graph saved in ``graph_dir``, on ``device``
        (``cuda`` unless the caller names another; ``hg`` must live there).

        Quiet-window coalescing is on by default here: the cap on the extra
        latency it may add adapts to the measured round trip (an average of
        the read-back stage's walls, within [max_wait_s, 50 ms]) unless
        ``coalesce_cap_s`` fixes it."""
        self.device = resolve_device(device)
        self._cap_fixed = coalesce_cap_s is not None
        self._rtt_ema: Optional[float] = None
        self._coalesce = (coalesce_quiet_s,
                          coalesce_cap_s if self._cap_fixed else max_wait_s)
        self.hg = hg or HierarchicalGraph.load(graph_dir, device=self.device)
        if self.hg.device != self.device:
            raise ValueError(f"the graph lives on {self.hg.device}, the service "
                             f"was asked for {self.device}")
        if self.hg.dirty or not self.hg._embeddings:
            self.hg.build_vector_index(layers=(0, 1, 2))
        self.gt = self.hg.tensors()
        if self.gt.n_pad >= 1 << 24:
            # encode_and_search returns node ids as float32, exact below 2**24
            raise ValueError(f"graph has {self.gt.n_pad} padded nodes; the packed "
                             "float32 result supports < 2**24")
        self.timers = Timers()
        self.latency = LatencyRecorder()
        self.request_timeout_s = request_timeout_s
        self._warm_buckets: set = set()  # (n_rows, packed shape) already served
        # per-batch constants, staged on the device once: serving holds the
        # search weights and parameters fixed for the service's lifetime
        self._w_cached = self.hg._resolve_weights()
        self._member_top_m = int(self.hg.search_params.get("member_top_m", 5))
        self._enc = self.hg._encoder()
        self._assoc = self.hg.query_assoc()
        idf = (np.ones(self._enc.buckets, np.float32) if self.hg._idf is None
               else np.asarray(self.hg._idf, np.float32))
        self._idf_dev = torch.from_numpy(idf).to(self.device)
        basis = self.hg.query_basis()
        self._proj_dev = self._enc._proj if basis is None else basis
        self._default_top_k = 5
        # three stages: featurize + pack in the coalescing worker, upload +
        # dispatch in two threads, read-back + assembly in three
        self._batcher = MicroBatcher(max_batch=max_batch, max_wait_s=max_wait_s,
                                     stages=[self._featurize_batch,
                                             self._upload_dispatch,
                                             self._finalize_batch],
                                     last_stage_workers=3, mid_stage_workers=2,
                                     coalesce_quiet_s=self._coalesce[0],
                                     coalesce_cap_s=self._coalesce[1])

    def _observe_rtt(self, rtt_s: float) -> None:
        """Feed one measured read-back wall into the adaptive coalesce cap
        (no-op when ``coalesce_cap_s`` was given)."""
        if self._cap_fixed:
            return
        self._rtt_ema = (rtt_s if self._rtt_ema is None
                         else 0.7 * self._rtt_ema + 0.3 * rtt_s)
        self._batcher._coalesce_cap_s = min(0.05, max(self._batcher.max_wait_s,
                                                      self._rtt_ema))

    _bucket = staticmethod(batch_bucket)

    def _featurize_batch(self, queries: List[str]) -> Tuple[int, int, np.ndarray]:
        """Stage 1: featurize on the host and pack into one upload-ready
        array (``pack_queries``, with the graph's query-side associations)."""
        with self.timers.timed("featurize"):
            return pack_queries(queries, self._enc, assoc=self._assoc)

    def _upload_dispatch(self, token) -> Tuple[int, torch.Tensor]:
        """Stage 2: one upload and the fused encode + search; returns the
        result tensor, which the device may still be computing. The first
        call at each (bucket, packed shape) is timed as
        ``search_batch_warmup``."""
        n, n_rows, packed = token
        shape_key = (n_rows, packed.shape)
        timer = "search_batch" if shape_key in self._warm_buckets else "search_batch_warmup"
        with self.timers.timed(timer):
            out = encode_and_search(packed, self._proj_dev, self._idf_dev, self.gt,
                                    self._w_cached, n_rows=n_rows,
                                    top_k=self._default_top_k,
                                    member_top_m=self._member_top_m)
        self._warm_buckets.add(shape_key)
        return n, out

    def _finalize_batch(self, token) -> List[List[Dict[str, Any]]]:
        """Stage 3: wait for the result, copy it back (``search_finalize``)
        and assemble the result entries (``assemble``)."""
        n, out = token
        t0 = time.perf_counter()
        with self.timers.timed("search_finalize"):
            packed = out.cpu().numpy()
        self._observe_rtt(time.perf_counter() - t0)
        with self.timers.timed("assemble"):
            idx = packed[..., 0].astype(np.int64)
            score, sem = packed[..., 1], packed[..., 2]
            ok = packed[..., 3] > 0.5
            return [[self.hg._result_entry(int(i), float(s), float(m))
                     for i, s, m, o in zip(idx[b], score[b], sem[b], ok[b]) if o]
                    for b in range(n)]

    def search(self, query: str) -> List[Dict[str, Any]]:
        """One query, coalesced with concurrent callers into one device batch.
        Raises ``TimeoutError`` after ``request_timeout_s`` (HTTP 503)."""
        with self.latency.timed("request"):
            return self._batcher.submit(query, timeout_s=self.request_timeout_s)

    def search_many(self, queries: List[str]) -> List[List[Dict[str, Any]]]:
        """A batch of queries through the three stages in the caller's thread."""
        return self._finalize_batch(self._upload_dispatch(self._featurize_batch(queries)))

    def beam(self, query: str, beam_width: int = 8, depth: int = 3,
             top_k: int = 10) -> List[Dict[str, Any]]:
        """Multi-level beam-search traversal (``graph/beam.py``) for one query."""
        with self.timers.timed("beam"):
            q = self.hg.encode_query_device([query]).to(self.device)
            res = beam_search_batch(self.gt, q, self._w_cached, beam_width=beam_width,
                                    depth=depth, top_k=top_k)
            rows = zip(res.evidence_idx[0].tolist(), res.evidence_score[0].tolist(),
                       res.evidence_valid[0].tolist())
        return [self.hg._result_entry(int(i), float(s), 0.0) for i, s, o in rows if o]

    def answer(self, query: str, steps: int = 4) -> Dict[str, Any]:
        """Full QA for one question: a ``GraphEnvironment`` over the service's
        graph (session files under ``artifacts/sessions/`` of the working
        directory, event log off), the rule agent and ``InferenceEngine``.
        Its searches run one query at a time on the graph's device, outside
        the micro-batcher."""
        with self.timers.timed("answer"):
            env = GraphEnvironment(hg=self.hg, log_level="off")
            out = InferenceEngine(env, AHRAG_Agent(env)).run_inference(query, steps=steps)
        return {k: out[k] for k in ("query", "answer", "rationale", "citations",
                                    "retrieved_nodes", "metrics")}

    def stats(self) -> Dict[str, Any]:
        return {"graph": self.hg.stats(), "timers": self.timers.snapshot(),
                "latency": self.latency.snapshot(), "batcher": self._batcher.stats()}

    def close(self) -> None:
        self._batcher.close()


def serve_http(service: RetrievalService, host: str = "127.0.0.1",
               port: int = 8080) -> ThreadingHTTPServer:
    """Start the HTTP front end (returns the server; call serve_forever and
    shutdown). Bad JSON answers 400, a ``TimeoutError`` 503 and any other
    exception 500."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, obj: Any) -> None:
            body = json.dumps(obj, ensure_ascii=False, default=str).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "nodes": service.hg.number_of_nodes()})
            elif self.path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": "not found"})

        def _payload(self) -> Any:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _route(self, payload: Dict[str, Any]) -> None:
            if self.path == "/search":
                queries = payload.get("queries") or (
                    [payload["query"]] if payload.get("query") else [])
                if not queries:
                    self._json(400, {"error": "no queries"})
                elif len(queries) == 1:
                    self._json(200, {"results": [service.search(queries[0])]})
                else:
                    self._json(200, {"results": service.search_many(queries)})
            elif self.path in ("/beam", "/answer"):
                query = payload.get("query")
                if not query:
                    self._json(400, {"error": "no query"})
                elif self.path == "/beam":
                    self._json(200, {"results": service.beam(
                        query, beam_width=int(payload.get("beam_width", 8)),
                        depth=int(payload.get("depth", 3)),
                        top_k=int(payload.get("top_k", 10)))})
                else:
                    self._json(200, service.answer(query, steps=int(payload.get("steps", 4))))
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                payload = self._payload()
            except (TypeError, ValueError):
                self._json(400, {"error": "bad json"})
                return
            try:
                self._route(payload)
            except TimeoutError as exc:
                # overloaded or wedged device: shed this request, keep serving
                self._json(503, {"error": f"timeout: {exc}"})
            except Exception as exc:
                self._json(500, {"error": str(exc)})

    return ThreadingHTTPServer((host, port), Handler)
