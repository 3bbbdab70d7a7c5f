"""flax's linen layers as plain tensor operations, with flax's parameter layout.

The learned models of the JAX package (the span reader, the contrastive
sentence encoder, MiniLM) are flax modules. Their counterparts here keep each
parameter under its flax path and in its flax shape (``Dense.kernel`` is
``[in..., out...]``, not torch's ``[out, in]``; an attention projection's
kernel is ``[d, heads, head_dim]``), so that a flax parameter tree maps onto a
``state_dict`` by name alone (``convert.flax_params_from_numpy``) and an
optimizer walks the same leaves as optax.

Every forward is written out as matmuls, sums and elementwise operations, so
that the card and the CPU follow the same arithmetic as flax on the CPU:
LayerNorm takes the variance as ``E[x^2] - E[x]^2`` (flax's fast variance),
attention scales the query before the product and fills masked keys with
``finfo(float32).min``. Matrix products run in IEEE float32
(``device.py`` turns TF32 off).

A fresh layer draws flax's initialisers' distributions (truncated
``lecun_normal`` kernels, zero biases, unit LayerNorm scales, ``fan_in``
embeddings) from a ``torch.Generator``: the same law as flax's, not flax's
stream.
"""
from __future__ import annotations

import io
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ahrag_tpu_torch.utils import flax_msgpack

# stddev of a standard normal truncated to (-2, 2) (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def _shape(s) -> Tuple[int, ...]:
    return (s,) if isinstance(s, int) else tuple(s)


def truncated_normal(shape: Sequence[int], fan_in: int,
                     generator: torch.Generator) -> torch.Tensor:
    """flax's ``variance_scaling(1, "fan_in", "truncated_normal")`` law."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    out = torch.empty(tuple(shape))
    nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return out


class Dense(nn.Module):
    """``flax.linen.Dense`` / ``DenseGeneral``: ``kernel`` [*in, *out] and
    ``bias`` [*out]; contracts the trailing ``len(in)`` axes of the input."""

    def __init__(self, in_shape, out_shape, generator: torch.Generator,
                 use_bias: bool = True) -> None:
        super().__init__()
        self.in_shape, self.out_shape = _shape(in_shape), _shape(out_shape)
        fan_in = math.prod(self.in_shape)
        self.kernel = nn.Parameter(truncated_normal(self.in_shape + self.out_shape,
                                                    fan_in, generator))
        self.bias = nn.Parameter(torch.zeros(self.out_shape)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        lead = x.shape[:x.dim() - n_in]
        k = self.kernel.reshape(math.prod(self.in_shape), math.prod(self.out_shape))
        y = torch.matmul(x.reshape(*lead, k.shape[0]), k)
        if self.bias is not None:
            y = y + self.bias.reshape(-1)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """``flax.linen.Embed``: ``embedding`` [num, features], rows gathered."""

    def __init__(self, num: int, features: int, generator: torch.Generator) -> None:
        super().__init__()
        # flax's default_embed_init: variance_scaling(1, "fan_in", "normal",
        # out_axis=0) over [num, features] takes fan_in = num
        self.embedding = nn.Parameter(truncated_normal((num, features), num, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis (``scale``, ``bias``),
    variance as ``E[x^2] - E[x]^2`` clipped at 0, as flax computes it."""

    def __init__(self, features: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (self.scale * torch.rsqrt(var + self.eps)) + self.bias


class MultiHeadAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` (and ``SelfAttention``)
    over one input, no dropout: ``query``/``key``/``value`` kernels [d,
    heads, head_dim], ``out`` kernel [heads, head_dim, d]. The query is
    scaled by 1/sqrt(head_dim) before the product; keys where ``mask`` [B,
    L] is false get ``finfo(float32).min`` before the softmax."""

    def __init__(self, d: int, heads: int, generator: torch.Generator) -> None:
        super().__init__()
        hd = d // heads
        self.query = Dense(d, (heads, hd), generator)
        self.key = Dense(d, (heads, hd), generator)
        self.value = Dense(d, (heads, hd), generator)
        self.out = Dense((heads, hd), d, generator)
        self.head_dim = hd

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q = self.query(x) / math.sqrt(self.head_dim)          # [B, L, H, hd]
        k, v = self.key(x), self.value(x)
        w = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))   # [B, H, Lq, Lk]
        w = torch.where(mask[:, None, None, :], w,
                        torch.tensor(torch.finfo(w.dtype).min, dtype=w.dtype,
                                     device=w.device))
        w = torch.softmax(w, dim=-1)
        ctx = torch.matmul(w, v.transpose(1, 2)).transpose(1, 2)     # [B, L, H, hd]
        return self.out(ctx)


def load_params(data: bytes) -> dict:
    """A parameter file's bytes as a ``state_dict``: flax's msgpack
    (``{"params": tree}``, what the JAX package writes) or the port's
    ``torch.save`` of ``{"params": state_dict}``, told apart by their
    leading bytes."""
    from ahrag_tpu_torch.convert import flax_params_from_numpy
    if flax_msgpack.is_msgpack_map(data[:1]):
        return flax_params_from_numpy(flax_msgpack.restore(data))
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)["params"]
