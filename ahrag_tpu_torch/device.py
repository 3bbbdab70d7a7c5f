"""Device selection, the float32 precision policy and a tie-stable top-k.

Precision policy (the port's counterpart of ``Precision.HIGHEST`` in
``ahrag_tpu/ops/topk.py``): every float32 matrix product runs in IEEE float32.
TF32 keeps about three decimal digits, the analogue of the bf16-pass rank
flips the certified top-k guards against, so both TF32 switches are off for
the whole process as soon as the port is imported.
"""
from __future__ import annotations

from typing import Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    requested (or default) CUDA device is absent instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ahrag_tpu_torch needs a CUDA device; none is available. Pass "
            "device='cpu' explicitly to run the plain-PyTorch path.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis where equal values resolve to the lowest index,
    as ``jax.lax.top_k`` does. ``torch.topk`` promises no order among ties,
    and the port's parity with the JAX package (and the batch-shape stability
    of flushed zero scores) depends on it. Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE float32 whatever the storage type: bf16 operands are
    widened first, so their products are exact and only the float32
    accumulation rounds (what ``preferred_element_type=float32`` gives in
    the JAX package)."""
    return torch.matmul(a.float(), b.float())
