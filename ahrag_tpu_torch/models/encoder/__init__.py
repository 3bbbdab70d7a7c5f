"""Encoder factory (port of ``ahrag_tpu/models/encoder/__init__.py``).

Config section ``encoder``: name (hashed, learned or minilm), dim, seed,
cgram_weight, learned_weights, minilm_weights. ``learned`` is the hybrid
contrastive encoder over ``encoder.learned_weights`` (else
``checkpoints/encoder.msgpack``); ``minilm`` the MiniLM encoder over
``encoder.minilm_weights`` (a HuggingFace safetensors file), else seeded; any
other name the hashed encoder, as in the JAX package.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.encoder.base import Encoder
from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder
from ahrag_tpu_torch.models.encoder.minilm import MiniLMConfig, MiniLMEncoder


@lru_cache(maxsize=4)
def _cached(name: str, dim: int, seed: int, weights: Optional[str],
            cgram_weight: float, device: str) -> Encoder:
    if name == "minilm":
        return MiniLMEncoder(MiniLMConfig(hidden=dim) if dim != 384 else None,
                             seed=seed, weights_path=weights, device=device)
    if name == "learned":
        from ahrag_tpu_torch.models.encoder.contrastive import (DEFAULT_CKPT,
                                                                ContrastiveEncoder)
        return ContrastiveEncoder(weights or DEFAULT_CKPT, device=device)
    return HashedNGramEncoder(dim=dim, seed=seed, cgram_weight=cgram_weight,
                              device=device)


def create_encoder(cfg: Dict[str, Any] | None = None, name: str | None = None,
                   device=None) -> Encoder:
    """Build (or fetch the cached) encoder described by the ``encoder`` config
    section, on ``device`` (``cuda`` unless the caller names another)."""
    enc_cfg = (cfg or {}).get("encoder", {}) if cfg else {}
    resolved = name or enc_cfg.get("name", "hashed")
    return _cached(
        resolved,
        int(enc_cfg.get("dim", 384)),
        int(enc_cfg.get("seed", 7)),
        (enc_cfg.get("learned_weights") if resolved == "learned"
         else enc_cfg.get("minilm_weights")),
        float(enc_cfg.get("cgram_weight", 0.3)),
        str(resolve_device(device)),
    )
