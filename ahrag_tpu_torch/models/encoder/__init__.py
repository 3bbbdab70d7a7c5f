"""Encoder factory (port of ``ahrag_tpu/models/encoder/__init__.py``).

Config section ``encoder``: name, dim, seed, cgram_weight. The MiniLM and
learned (contrastive) encoders are not ported yet (ROADMAP item 13); asking for
either raises, and never yields the hashed encoder in their place.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder


@lru_cache(maxsize=4)
def _cached(name: str, dim: int, seed: int, cgram_weight: float,
            device: str) -> HashedNGramEncoder:
    if name in ("minilm", "learned"):
        raise NotImplementedError(
            f"the {name!r} encoder is not ported to ahrag_tpu_torch yet "
            "(ROADMAP item 13); only the hashed encoder is")
    return HashedNGramEncoder(dim=dim, seed=seed, cgram_weight=cgram_weight,
                              device=device)


def create_encoder(cfg: Dict[str, Any] | None = None, name: str | None = None,
                   device=None) -> HashedNGramEncoder:
    """Build (or fetch the cached) encoder described by the ``encoder`` config
    section, on ``device`` (``cuda`` unless the caller names another)."""
    enc_cfg = (cfg or {}).get("encoder", {}) if cfg else {}
    return _cached(name or enc_cfg.get("name", "hashed"),
                   int(enc_cfg.get("dim", 384)), int(enc_cfg.get("seed", 7)),
                   float(enc_cfg.get("cgram_weight", 0.3)),
                   str(resolve_device(device)))
