"""Compute once per key, under a lock, for code that threads reach cold."""
from __future__ import annotations

import functools
import threading


def locked_cache(fn=None, *, maxsize: int | None = None):
    """``functools.lru_cache`` whose computation runs under a lock of its own:
    of several threads that reach a cold key together, the first computes and
    the others wait for its value instead of computing their own (a second
    ``nvcc`` build, a second calibration launch). The lock is reentrant, and
    ``cache_clear``/``cache_info`` are the cache's. Bare ``@locked_cache``
    keeps every key; ``@locked_cache(maxsize=n)`` keeps the ``n`` used last."""
    if fn is None:
        return functools.partial(locked_cache, maxsize=maxsize)
    cached = functools.lru_cache(maxsize=maxsize)(fn)
    lock = threading.RLock()

    @functools.wraps(fn)
    def wrapper(*args):
        with lock:
            return cached(*args)

    wrapper.cache_clear = cached.cache_clear
    wrapper.cache_info = cached.cache_info
    return wrapper
