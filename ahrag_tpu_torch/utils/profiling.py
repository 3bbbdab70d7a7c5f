"""Tracing and profiling utilities.

Port of ``ahrag_tpu/utils/profiling.py``:

- ``Timers.timed(name, block_on=...)``: accumulating wall-clock timer; with
  ``block_on`` (a tensor, or a sequence of them) it synchronizes the tensors'
  CUDA device before reading the clock, so device work is measured;
- ``LatencyRecorder``: per-name latency samples with p50/p95/p99 summaries;
- ``trace(logdir)``: a ``torch.profiler`` trace of CPU and CUDA activity,
  written to ``logdir`` as a Chrome trace;
- ``annotate(name)``: a named range in the profiler's timeline.

The context managers are classes: a timer records its sample in ``__exit__``,
so it records when its body raises too, and the exception propagates.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _synchronize(block_on: Any) -> None:
    tensors = block_on if isinstance(block_on, (list, tuple)) else [block_on]
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class _Timed:
    """Calls ``record(seconds)`` on exit, whether or not the body raised."""

    def __init__(self, record, block_on: Any = None) -> None:
        self._record = record
        self._block_on = block_on

    def __enter__(self) -> None:
        self._t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._block_on is not None:
            _synchronize(self._block_on)
        self._record(time.perf_counter() - self._t0)
        return False


class Timers:
    """Per-name count / total / max registry (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self._stats.setdefault(name, {"count": 0.0, "total_s": 0.0,
                                              "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += seconds
            s["max_s"] = max(s["max_s"], seconds)

    def timed(self, name: str, block_on: Any = None) -> _Timed:
        return _Timed(lambda dt: self.record(name, dt), block_on)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {**v, "mean_s": v["total_s"] / max(1.0, v["count"])}
                    for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


class LatencyRecorder:
    """Per-name latency samples with percentile summaries.

    Thread-safe; keeps a bounded sample buffer per name (newest wins past the
    cap), so a long-lived service reports p50/p95/p99 over recent traffic
    without unbounded memory."""

    def __init__(self, max_samples: int = 100_000) -> None:
        self._lock = threading.Lock()
        self._samples: Dict[str, list] = {}
        self._counts: Dict[str, int] = {}
        self.max_samples = max_samples

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            buf = self._samples.setdefault(name, [])
            n = self._counts.get(name, 0)
            if len(buf) < self.max_samples:
                buf.append(seconds)
            else:
                buf[n % self.max_samples] = seconds
            self._counts[name] = n + 1

    def timed(self, name: str) -> _Timed:
        return _Timed(lambda dt: self.record(name, dt))

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, buf in self._samples.items():
                if not buf:
                    continue
                a = np.asarray(buf, dtype=np.float64) * 1e3
                out[name] = {"count": float(self._counts[name]),
                             "mean_ms": float(a.mean()),
                             "p50_ms": float(np.percentile(a, 50)),
                             "p95_ms": float(np.percentile(a, 95)),
                             "p99_ms": float(np.percentile(a, 99)),
                             "max_ms": float(a.max())}
        return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counts.clear()


GLOBAL_TIMERS = Timers()
timed = GLOBAL_TIMERS.timed


class trace:
    """``torch.profiler`` trace of CPU and (where present) CUDA activity; on
    exit the Chrome trace is written to ``logdir/trace.json``. ``__enter__``
    returns the profiler, whose ``key_averages()`` sum the time by op. A
    no-op that yields None when ``logdir`` is None."""

    def __init__(self, logdir: Optional[str] = None) -> None:
        self.logdir = logdir
        self.profiler: Optional[torch.profiler.profile] = None

    def __enter__(self) -> Optional[torch.profiler.profile]:
        if self.logdir is None:
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=acts)
        self.profiler.__enter__()
        return self.profiler

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.profiler is not None:
            self.profiler.__exit__(exc_type, exc, tb)
            os.makedirs(self.logdir, exist_ok=True)
            self.profiler.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        return False


def annotate(name: str) -> torch.profiler.record_function:
    """Named range that shows up in profiler timelines."""
    return torch.profiler.record_function(name)
