"""The JAX package's random draws, reproduced without JAX.

The JAX package draws two things that its results depend on: the hashed
encoder's Gaussian projection (``jax.random.normal(PRNGKey(seed), (buckets,
dim))``), which places every entity embedding the build clusters, and
k-means's start row (``jax.random.randint(PRNGKey(seed), (), 0, n)``). Both
come from JAX's default generator, threefry-2x32, as jax 0.9 runs it with
``jax_threefry_partitionable`` on:

- ``PRNGKey(seed)`` is the word pair ``(0, seed)`` for a seed in
  [0, 2**31) (JAX's default 32-bit seeds);
- ``split`` hashes the counter pairs (0, 0) and (0, 1) under the key;
- the bits of a draw of n values hash the counter pairs (0, i) for i < n,
  and xor the two words of each.

``randint`` is exact. ``normal`` draws exactly JAX's uniforms, then takes the
correctly rounded float64 ``erfinv`` where XLA's float32 ``erf_inv`` is a
polynomial approximation: 41% of the (16384, 384) projection's values are
equal to the bit, and the rest lie within 6e-6 of JAX's relatively
(``tests/test_torch_build.py``).
"""
from __future__ import annotations

import functools
from typing import Tuple

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


def _key(seed: int) -> Tuple[int, int]:
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return 0, seed


def _split(key: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    a, b = threefry2x32(key, np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
    return (int(a[0]), int(b[0])), (int(a[1]), int(b[1]))


def _bits(key: Tuple[int, int], n: int) -> np.ndarray:
    """[n] uint32: the 32-bit draws of a flat array of n values (n < 2**32)."""
    a, b = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return a ^ b


def randint(seed: int, n: int) -> int:
    """``int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, n))`` for a
    ``seed`` in [0, 2**31) and an int32 ``n``: one draw from each half of the
    split key, combined as randint does in uint32 arithmetic that wraps,
    ``(hi % span) * (2**16 % span)**2 + lo % span``, modulo the span."""
    k1, k2 = _split(_key(seed))
    hi, lo = int(_bits(k1, 1)[0]), int(_bits(k2, 1)[0])
    span = n if n > 0 else 1
    mult = (((1 << 16) % span) ** 2 & 0xFFFFFFFF) % span
    return ((((hi % span) * mult) & 0xFFFFFFFF) + lo % span) % span


@functools.lru_cache(maxsize=4)
def normal(seed: int, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` as float32 numpy
    (read-only; cached): JAX's uniforms on (-1, 1), from the top 23 bits of
    each draw as a mantissa, through ``sqrt(2) * erfinv``."""
    bits = _bits(_key(seed), int(np.prod(shape)))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    e = torch.erfinv(torch.from_numpy(u.astype(np.float64))).numpy().astype(np.float32)
    out = (np.float32(np.sqrt(2)) * e).reshape(shape)
    out.flags.writeable = False
    return out
