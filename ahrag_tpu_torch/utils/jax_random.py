"""The JAX package's random draws, reproduced without JAX.

The JAX package draws things that its results depend on: the hashed
encoder's Gaussian projection (``jax.random.normal(PRNGKey(seed), (buckets,
dim))``), which places every entity embedding the build clusters, k-means's
start row (``jax.random.randint(PRNGKey(seed), (), 0, n)``), and the
learned models' training draws (the span reader's identity dropout, the
contrastive encoder's batch indices). All come from JAX's default generator,
threefry-2x32, as jax 0.9 runs it with ``jax_threefry_partitionable`` on:

- ``PRNGKey(seed)`` is the word pair ``(0, seed)`` for a seed in
  [0, 2**31) (JAX's default 32-bit seeds; ``prng_key``);
- ``split(key, num)`` hashes the counter pairs (0, i), i < num, under the
  key, each hash a new key;
- the bits of a draw of n values hash the counter pairs (0, i) for i < n,
  in row-major order, and xor the two words of each.

``randint``, ``randints``, ``uniform`` and ``bernoulli`` are exact.
``normal`` draws exactly JAX's uniforms, then takes the correctly rounded
float64 ``erfinv`` where XLA's float32 ``erf_inv`` is a polynomial
approximation: 41% of the (16384, 384) projection's values are equal to the
bit, and the rest lie within 6e-6 of JAX's relatively
(``tests/test_torch_build.py``).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    (uint32 arrays) under ``key``, as ``jax._src.prng`` computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return 0, seed


_key = prng_key


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` as a list of keys."""
    a, b = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return [(int(x), int(y)) for x, y in zip(a, b)]


def _split(key: Key) -> Tuple[Key, Key]:
    k1, k2 = split(key, 2)
    return k1, k2


def _bits(key: Key, n: int) -> np.ndarray:
    """[n] uint32: the 32-bit draws of a flat array of n values (n < 2**32)."""
    a, b = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return a ^ b


def bits(key: Key, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32)."""
    return _bits(key, int(np.prod(shape))).reshape(shape)


def randints(key: Key, shape: Tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for int32
    bounds: one draw from each half of the split key, combined as randint
    does in uint32 arithmetic that wraps, ``(hi % span) * (2**16 % span)**2
    + lo % span``, modulo the span."""
    k1, k2 = _split(key)
    hi = bits(k1, shape).astype(np.uint64)
    lo = bits(k2, shape).astype(np.uint64)
    span = maxval - minval if maxval > minval else 1
    mult = (((1 << 16) % span) ** 2 & 0xFFFFFFFF) % span
    off = (((hi % span) * mult & 0xFFFFFFFF) + lo % span) & 0xFFFFFFFF
    return (minval + (off % span).astype(np.int64)).astype(np.int32)


def randint(seed: int, n: int) -> int:
    """``int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))`` for a
    ``seed`` in [0, 2**31) and an int32 ``n``."""
    return int(randints(prng_key(seed), (), 0, n))


def uniform(key: Key, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1)): the top 23
    bits of each draw as a mantissa of [1, 2), minus 1."""
    b = bits(key, shape)
    return ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def bernoulli(key: Key, p: float, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in float32."""
    return uniform(key, shape) < np.float32(p)


@functools.lru_cache(maxsize=4)
def normal(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` as float32 numpy
    (read-only; cached): JAX's uniforms on (-1, 1), from the top 23 bits of
    each draw as a mantissa, through ``sqrt(2) * erfinv``."""
    floats = uniform(prng_key(seed), (int(np.prod(shape)),))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    e = torch.erfinv(torch.from_numpy(u.astype(np.float64))).numpy().astype(np.float32)
    out = (np.float32(np.sqrt(2)) * e).reshape(shape)
    out.flags.writeable = False
    return out
