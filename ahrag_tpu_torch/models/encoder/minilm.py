"""MiniLM-class sentence encoder (port of ``ahrag_tpu/models/encoder/minilm.py``).

A 6-layer, 384-hidden, 12-head BERT-style encoder with masked mean pooling and
L2 normalisation: post-LN blocks (LayerNorm epsilon 1e-12), the exact gelu, a
-1e9 bias on padded keys, the scores divided by sqrt(head_dim) after the
product, as the flax module computes them. Parameters keep the flax module's
names and shapes (``tok_emb``, ``pos_emb``, ``type_emb``, ``ln_emb``,
``block_i.{q,k,v,attn_out,ln_attn,ff_in,ff_out,ln_ff}``;
``models/flax_layers.py``), so a flax parameter tree loads by name.

Weights: ``load_hf_weights(path)`` maps a HuggingFace BERT/MiniLM
``model.safetensors`` into the module, reading the file format itself (an
8-byte little-endian header length, a JSON header, raw little-endian bytes)
without the ``safetensors`` package. With no weight file the model is drawn
from a ``torch.Generator`` seeded by ``seed`` (flax's laws, not flax's
stream). Tokenization is the deterministic hashing tokenizer (a blake2b word
id); a HuggingFace tokenizer directory would need ``transformers``, which the
port does not use, and is refused.
"""
from __future__ import annotations

import hashlib
import json
import math
import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.flax_layers import Dense, Embed, LayerNorm


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_positions: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12
    max_len: int = 128  # static sequence length


class TransformerBlock(nn.Module):
    def __init__(self, cfg: MiniLMConfig, gen: torch.Generator) -> None:
        super().__init__()
        h = cfg.hidden
        self.head_dim = h // cfg.heads
        self.q, self.k, self.v = Dense(h, h, gen), Dense(h, h, gen), Dense(h, h, gen)
        self.attn_out = Dense(h, h, gen)
        self.ln_attn = LayerNorm(h, cfg.layer_norm_eps)
        self.ff_in = Dense(h, cfg.intermediate, gen)
        self.ff_out = Dense(cfg.intermediate, h, gen)
        self.ln_ff = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # the head count and the context width follow q's output, so a block
        # whose q/k/v hold a subset of the heads (tensor parallelism,
        # ``parallel/sharded.py``) runs through this same forward
        B, T, _ = x.shape
        hd = self.head_dim

        def split(t):
            return t.reshape(B, T, -1, hd).transpose(1, 2)

        q = self.q(x)
        scores = torch.matmul(split(q), split(self.k(x)).transpose(-1, -2))
        scores = scores / math.sqrt(hd)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(scores.dtype)
        attn = torch.softmax(scores + bias, dim=-1)
        ctx = torch.matmul(attn, split(self.v(x))).transpose(1, 2).reshape(B, T, q.shape[-1])
        x = self.ln_attn(x + self.attn_out(ctx))
        ff = self.ff_out(torch.nn.functional.gelu(self.ff_in(x)))
        return self.ln_ff(x + ff)


class MiniLMModel(nn.Module):
    def __init__(self, cfg: MiniLMConfig, seed: int = 0, device=None) -> None:
        """The model on ``device`` (``cuda`` unless the caller names another),
        drawn from a CPU ``torch.Generator`` seeded by ``seed`` and then
        moved, so the card and the CPU start from the same weights."""
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.tok_emb = Embed(cfg.vocab_size, cfg.hidden, gen)
        self.pos_emb = Embed(cfg.max_positions, cfg.hidden, gen)
        self.type_emb = Embed(cfg.type_vocab, cfg.hidden, gen)
        self.ln_emb = LayerNorm(cfg.hidden, cfg.layer_norm_eps)
        for i in range(cfg.layers):
            setattr(self, f"block_{i}", TransformerBlock(cfg, gen))
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, T] token ids and 0/1 mask -> [B, hidden] unit vectors."""
        B, T = ids.shape
        ids = ids.long()
        x = (self.tok_emb(ids) + self.pos_emb(torch.arange(T, device=ids.device))[None]
             + self.type_emb(torch.zeros_like(ids)))
        x = self.ln_emb(x)
        for i in range(self.cfg.layers):
            x = getattr(self, f"block_{i}")(x, mask)
        m = mask[..., None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-9)


_WORD_RE = re.compile(r"[a-zA-Z0-9]+|[^\sa-zA-Z0-9]")


def _hash_token_id(token: str, vocab: int) -> int:
    h = hashlib.blake2b(token.lower().encode("utf-8"), digest_size=8).digest()
    return 1000 + int.from_bytes(h, "little") % (vocab - 1000)


_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                       "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU: an 8-byte
    little-endian header length, a JSON header mapping each name to its
    dtype, shape and byte offsets into the data that follows."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        flat = (torch.frombuffer(bytearray(body[begin:end]), dtype=dtype) if end > begin
                else torch.zeros(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


class MiniLMEncoder:
    CLS, SEP, PAD = 101, 102, 0

    def __init__(self, cfg: Optional[MiniLMConfig] = None, seed: int = 0,
                 weights_path: Optional[str] = None, tokenizer_path: Optional[str] = None,
                 device=None) -> None:
        if tokenizer_path:
            raise ValueError("a HuggingFace tokenizer needs the transformers package, "
                             "which ahrag_tpu_torch does not use; leave tokenizer_path "
                             "unset for the hashing tokenizer")
        self.cfg = cfg or MiniLMConfig()
        self.name = "minilm-flax-l6-h384"
        self.dim = self.cfg.hidden
        self.device = resolve_device(device)
        self.model = MiniLMModel(self.cfg, seed=seed, device=self.device).eval()
        if weights_path:
            self.load_hf_weights(weights_path)

    # -- tokenization --------------------------------------------------------
    def _tokenize(self, texts: List[str]) -> tuple[np.ndarray, np.ndarray]:
        T = self.cfg.max_len
        ids = np.full((len(texts), T), self.PAD, dtype=np.int32)
        mask = np.zeros((len(texts), T), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = _WORD_RE.findall(text or "")[: T - 2]
            row = [self.CLS] + [_hash_token_id(t, self.cfg.vocab_size) for t in toks] + [self.SEP]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    # -- HF weight mapping ---------------------------------------------------
    def load_hf_weights(self, path: str) -> None:
        """Map a HuggingFace BERT/MiniLM safetensors checkpoint into the model
        (kernels transposed to flax's [in, out]), as the JAX package maps it."""
        sd = read_safetensors(path)
        pre = "bert." if any(k.startswith("bert.") for k in sd) else ""

        def g(k):
            return sd[k].float()

        p = {"tok_emb.embedding": g(f"{pre}embeddings.word_embeddings.weight"),
             "pos_emb.embedding": g(f"{pre}embeddings.position_embeddings.weight"),
             "type_emb.embedding": g(f"{pre}embeddings.token_type_embeddings.weight"),
             "ln_emb.scale": g(f"{pre}embeddings.LayerNorm.weight"),
             "ln_emb.bias": g(f"{pre}embeddings.LayerNorm.bias")}
        for i in range(self.cfg.layers):
            lp, bp = f"{pre}encoder.layer.{i}.", f"block_{i}."
            for flax_name, hf_name in [("q", "attention.self.query"), ("k", "attention.self.key"),
                                       ("v", "attention.self.value"),
                                       ("attn_out", "attention.output.dense"),
                                       ("ff_in", "intermediate.dense"),
                                       ("ff_out", "output.dense")]:
                p[bp + flax_name + ".kernel"] = g(lp + hf_name + ".weight").T.contiguous()
                p[bp + flax_name + ".bias"] = g(lp + hf_name + ".bias")
            p[bp + "ln_attn.scale"] = g(lp + "attention.output.LayerNorm.weight")
            p[bp + "ln_attn.bias"] = g(lp + "attention.output.LayerNorm.bias")
            p[bp + "ln_ff.scale"] = g(lp + "output.LayerNorm.weight")
            p[bp + "ln_ff.bias"] = g(lp + "output.LayerNorm.bias")
        self.model.load_state_dict(p)

    # -- encoding ------------------------------------------------------------
    @torch.no_grad()
    def encode_device(self, texts: List[str]) -> torch.Tensor:
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        ids, mask = self._tokenize(texts)
        return self.model(torch.from_numpy(ids).to(self.device),
                          torch.from_numpy(mask).to(self.device))

    def encode(self, texts: List[str]) -> np.ndarray:
        return self.encode_device(texts).cpu().numpy()
