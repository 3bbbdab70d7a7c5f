"""The port's parse guards: a value that does not parse becomes ``None``.

These are the only places outside the serving hand-offs and the LLM client's
network retry where the port catches an exception (``tests/test_torch_imports.py``
holds the rule): each catches ``(TypeError, ValueError)`` around one parse.
"""
from __future__ import annotations

import json
from typing import Any, Optional


def json_or_none(text: Any) -> Any:
    try:
        return json.loads(text)
    except (TypeError, ValueError):
        return None


def float_or_none(value: Any) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def int_or_none(value: Any) -> Optional[int]:
    try:
        return int(value)
    except (TypeError, ValueError):
        return None
