"""Session-scoped structured logging.

The port's copy of ``ahrag_tpu/utils/logging.py``: every environment action
and inference event appends a JSON line to ``<session>/events.jsonl`` with
ISO timestamps and redaction of secret-looking keys; level "off" writes
nothing. (The JAX package's ``debug`` events have no caller and are not
copied.)

One difference: a write that fails raises here, where the JAX package
swallows it.
"""
from __future__ import annotations

import json
import os
from datetime import datetime, timezone
from typing import Any, Dict

_LEVELS = {"off": 0, "normal": 1, "debug": 2, "trace": 3}
_REDACT_KEYS = {"api_key", "authorization", "token", "secret"}


def _utcnow() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


class SessionLogger:
    """Appends structured events to ``session_path/events.jsonl``."""

    def __init__(self, session_path: str, session_id: str,
                 level: str = "normal", redact: bool = True) -> None:
        self.session_path = session_path
        self.session_id = session_id
        self.level = _LEVELS.get(level, 1)
        self.redact = redact
        if self.level > 0:
            os.makedirs(session_path, exist_ok=True)

    def _redact(self, event: Dict[str, Any]) -> Dict[str, Any]:
        if not self.redact:
            return event
        return {k: ("[REDACTED]" if k.lower() in _REDACT_KEYS else v) for k, v in event.items()}

    def _write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(self._redact(event), ensure_ascii=False, default=str)
        with open(os.path.join(self.session_path, "events.jsonl"), "a", encoding="utf-8") as f:
            f.write(line + "\n")

    def info(self, **event: Any) -> None:
        if self.level >= 1:
            self._write({**event, "session_id": self.session_id, "ts": _utcnow()})


def get_logger(session_path: str, session_id: str, level: str = "normal",
               redact: bool = True) -> SessionLogger:
    return SessionLogger(session_path, session_id, level=level, redact=redact)
