"""Token counting for budget-constrained context assembly.

The port counts with its native estimator (``ahrag_tpu_torch.native.
token_estimate``, a vocabulary-free approximation of a BPE count) on every
machine. The JAX package's ``count_tokens`` prefers ``tiktoken`` and falls
through to the same estimator when ``tiktoken`` is absent or cannot load its
vocabulary, which needs the network: where it falls through, both packages
count alike, and so trim the same evidence into the same context.
"""
from __future__ import annotations

from ahrag_tpu_torch import native


def count_tokens(text: str) -> int:
    """Estimated BPE tokens of ``text`` (0 for empty text)."""
    if not text:
        return 0
    return native.token_estimate(text)
