"""Encoder protocol (port of ``ahrag_tpu/models/encoder/base.py``).

- ``encode(texts) -> np.ndarray [n, dim]`` L2-normalized float32 (host-visible);
- ``encode_device(texts) -> torch.Tensor`` the same, left on the encoder's
  device for fusion with search;
- ``dim`` / ``name`` identify the embedding space (persisted in graph meta so a
  loaded snapshot is self-describing).
"""
from __future__ import annotations

from typing import List, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Encoder(Protocol):
    name: str
    dim: int

    def encode(self, texts: List[str]) -> np.ndarray: ...

    def encode_device(self, texts: List[str]): ...
