"""The port's parse guards: a value that does not parse becomes ``None``.

These are the only places outside the serving hand-offs and the LLM client's
network retry where the port catches an exception (``tests/test_torch_imports.py``
holds the rule): each catches ``(TypeError, ValueError)`` around one parse.
The overflows that ``float`` and ``int`` raise instead (an int past the float
range, an infinite float) are refused before the parse.
"""
from __future__ import annotations

import json
import math
from typing import Any, Optional

FLOAT_MAX_INT = 2 ** 1024 - 2 ** 970      # the first int that rounds past the float range


def json_or_none(text: Any) -> Any:
    try:
        return json.loads(text)
    except (TypeError, ValueError):
        return None


def float_or_none(value: Any) -> Optional[float]:
    if isinstance(value, int) and abs(value) >= FLOAT_MAX_INT:
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def int_or_none(value: Any) -> Optional[int]:
    if isinstance(value, float) and math.isinf(value):
        return None
    try:
        return int(value)
    except (TypeError, ValueError):
        return None
