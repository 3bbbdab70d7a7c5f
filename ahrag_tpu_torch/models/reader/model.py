"""SpanReader: a small transformer that points at answer spans.

Port of ``ahrag_tpu/models/reader/model.py``. The reader consumes hashed token
identities plus structural scalars (``features.py``) and emits start and end
logits over the evidence positions; logits outside ``ev_mask`` are
``finfo(float32).min``. Pre-LN blocks (LayerNorm epsilon 1e-6, flax's), the
tanh-approximated gelu, a learned ``pos_emb`` [SEQ_LEN, d] parameter and a
2-row segment embedding, as the flax module has them. Parameters keep their
flax names and shapes (``models/flax_layers.py``), so a JAX checkpoint loads by
name: ``SpanReader.from_checkpoint("checkpoints/reader.msgpack")`` reads the
architecture from ``checkpoints/reader_curve.json`` beside it.
"""
from __future__ import annotations

import json
import os
import re
from typing import Tuple

import torch
from torch import nn

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.flax_layers import (Dense, Embed, LayerNorm,
                                                 MultiHeadAttention, load_params)
from ahrag_tpu_torch.models.reader.features import (N_SCALARS, SEQ_LEN, STEM_VOCAB,
                                                    WORD_VOCAB)


class ReaderConfig:
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256

    def __init__(self, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 256) -> None:
        self.d_model, self.n_heads = d_model, n_heads
        self.n_layers, self.d_ff = n_layers, d_ff


class _Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 gen: torch.Generator) -> None:
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(d_model, n_heads, gen)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, d_ff, gen)
        self.Dense_1 = Dense(d_ff, d_model, gen)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask)
        h = self.Dense_0(self.LayerNorm_1(x))
        h = self.Dense_1(torch.nn.functional.gelu(h, approximate="tanh"))
        return x + h


class SpanReader(nn.Module):
    def __init__(self, d_model: int = 128, n_heads: int = 4, n_layers: int = 2,
                 d_ff: int = 256, seed: int = 0, device=None) -> None:
        """A reader at the given width on ``device`` (``cuda`` unless the
        caller names another), its parameters drawn from a CPU
        ``torch.Generator`` seeded by ``seed`` with flax's initialisers'
        laws (``pos_emb`` normal(0.02)), then moved, so the card and the CPU
        start from the same weights."""
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        d = d_model
        self.config = ReaderConfig(d_model, n_heads, n_layers, d_ff)
        self.word_emb = Embed(WORD_VOCAB, d, gen)
        self.stem_emb = Embed(STEM_VOCAB, d, gen)
        self.scalar_proj = Dense(N_SCALARS, d, gen)
        self.segment_emb = Embed(2, d, gen)
        self.pos_emb = nn.Parameter(torch.randn(SEQ_LEN, d, generator=gen) * 0.02)
        self.LayerNorm_0 = LayerNorm(d)
        for i in range(n_layers):
            setattr(self, f"block_{i}", _Block(d, n_heads, d_ff, gen))
        self.final_ln = LayerNorm(d)
        self.start_head = Dense(d, 1, gen)
        self.end_head = Dense(d, 1, gen)
        self.to(dev)

    def forward(self, word_ids: torch.Tensor, stem_ids: torch.Tensor,
                scalars: torch.Tensor, segments: torch.Tensor, mask: torch.Tensor,
                ev_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, SEQ_LEN] inputs (ids int, scalars [B, SEQ_LEN, N_SCALARS]
        float32, masks bool) -> (start, end) logits [B, SEQ_LEN] float32."""
        x = (self.word_emb(word_ids.long()) + self.stem_emb(stem_ids.long())
             + self.scalar_proj(scalars) + self.segment_emb(segments.long())
             + self.pos_emb[None, :, :])
        x = self.LayerNorm_0(x)
        for i in range(self.config.n_layers):
            x = getattr(self, f"block_{i}")(x, mask)
        x = self.final_ln(x)
        start = self.start_head(x).squeeze(-1)
        end = self.end_head(x).squeeze(-1)
        neg = torch.tensor(torch.finfo(start.dtype).min, dtype=start.dtype,
                           device=start.device)
        return torch.where(ev_mask, start, neg), torch.where(ev_mask, end, neg)

    @classmethod
    def from_checkpoint(cls, path: str, device=None, d_model=None,
                        n_layers=None) -> "SpanReader":
        """The reader saved at ``path``: the JAX package's flax msgpack or the
        port's ``torch.save`` file (told apart by their leading bytes), its
        architecture from ``<stem>_curve.json`` beside it (d_model 128,
        n_layers 2, d_ff 2·d_model and 4 heads where the file or a key is
        missing, as the JAX package reads it)."""
        meta_path = re.sub(r"\.(msgpack|pt)$", "", path) + "_curve.json"
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        dm = d_model or int(meta.get("d_model", 128))
        nl = n_layers or int(meta.get("n_layers", 2))
        dff = int(meta["d_ff"]) if "d_ff" in meta else 2 * dm
        nh = int(meta["n_heads"]) if "n_heads" in meta else 4
        model = cls(d_model=dm, n_heads=nh, n_layers=nl, d_ff=dff, device=device)
        with open(path, "rb") as f:
            data = f.read()
        model.load_state_dict(load_params(data))
        return model.eval()

