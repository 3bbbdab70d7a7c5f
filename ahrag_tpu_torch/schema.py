"""Core data contracts shared across the pipeline.

The port's copy of ``ahrag_tpu/schema.py`` as plain dataclasses: the machine
with the card has no pydantic. Each class keeps what the callers rely on:

- keyword construction, mutable fields and ``model_dump`` (a dict in field
  order, nested models as dicts);
- ``model_validate``, with pydantic v2's lax coercion of the inputs these
  callers see (JSON from an LLM): a ``float`` field takes a float, an int, a
  bool or a numeric string ("8" and 8 both give 8.0); an ``int`` field takes
  an int, a bool, an integral float or an integer string ("8", " 8 ", "8.0"),
  bytes as their UTF-8 string;
  a ``str`` field takes a string (or UTF-8 bytes) and refuses a number; a
  list takes a list, tuple or set; extra keys are ignored, a missing required
  field is refused. Where pydantic raises a ``ValidationError``,
  ``model_validate`` returns None: the callers fall back on it.
"""
from __future__ import annotations

import re
from dataclasses import MISSING, asdict, dataclass, field, fields
from typing import Any, List, Optional

from ahrag_tpu_torch.utils.parse import FLOAT_MAX_INT

# the characters Rust's ``str::trim`` removes (Unicode White_Space), which is
# what pydantic-core strips from numeric strings; Python's ``str.strip``
# removes \x1c-\x1f as well
_WS = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
       "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_FLOAT_RE = re.compile(r"[+-]?(?:(?i:inf|infinity|nan)|(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
                       r"(?:[eE][+-]?[0-9]+)?)")
_INT_RE = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*")
_I64 = 2 ** 63


class _Refused:
    """The validators' mark of a value the field refuses."""


REFUSED = _Refused()


def _float(v: Any) -> Any:
    if isinstance(v, bytes):
        v = _str(v)
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, int):
        return float(v) if abs(v) < FLOAT_MAX_INT else REFUSED
    if isinstance(v, float):
        return v
    if isinstance(v, str):
        s = v.strip(_WS)
        if _FLOAT_RE.fullmatch(s):
            return float(s)
        if v.startswith("_") or v.endswith("_") or "__" in v:
            return REFUSED
        s = v.replace("_", "")
        return float(s) if _FLOAT_RE.fullmatch(s) else REFUSED
    return REFUSED


def _int(v: Any) -> Any:
    if isinstance(v, bytes):
        v = _str(v)
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        ok = v == v and abs(v) < _I64 and v == int(v)
        return int(v) if ok else REFUSED
    if isinstance(v, str):
        s = v.strip(_WS)
        s = re.sub(r"\.0+$", "", s)
        return int(s) if len(s) <= 4300 and _INT_RE.fullmatch(s) else REFUSED
    return REFUSED


def _str(v: Any) -> Any:
    if isinstance(v, str):
        return v
    if isinstance(v, bytes):
        s = v.decode("utf-8", errors="replace")
        return s if s.encode("utf-8") == v else REFUSED
    return REFUSED


class _Model:
    """``model_validate``/``model_dump`` over the dataclass fields; each field's
    metadata names its validator (``_float``, ``_int``, ``_str``, or a model
    class, alone or in a one-element list for a list of them)."""

    @classmethod
    def model_validate(cls, obj: Any) -> Optional["_Model"]:
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            return None
        kw = {}
        for f in fields(cls):
            if f.name not in obj:
                if f.default is MISSING:
                    return None
                continue
            v = _check(f.metadata["check"], obj[f.name])
            if v is REFUSED:
                return None
            kw[f.name] = v
        return cls(**kw)

    def model_dump(self) -> dict:
        return asdict(self)


def _check(check: Any, v: Any) -> Any:
    if isinstance(check, list):
        if not isinstance(v, (list, tuple, set, frozenset)):
            return REFUSED
        out = [_check(check[0], x) for x in v]
        return REFUSED if any(x is REFUSED for x in out) else out
    if isinstance(check, type):
        got = check.model_validate(v)
        return REFUSED if got is None else got
    return check(v)


def _f(check: Any, default: Any = MISSING) -> Any:
    return field(default=default, metadata={"check": check})


@dataclass
class Entity(_Model):
    name: str = _f(_str)
    type: str = _f(_str)
    description: str = _f(_str, "")


@dataclass
class HypergraphExtraction(_Model):
    hyperedge: str = _f(_str)
    relation_type: str = _f(_str)
    entities: List[Entity] = _f([Entity])
    confidence_score: float = _f(_float)


@dataclass
class ExtractionResponse(_Model):
    extractions: List[HypergraphExtraction] = _f([HypergraphExtraction])


@dataclass
class TopicSummary(_Model):
    topic_id: int = _f(_int)
    title: str = _f(_str)
    summary: str = _f(_str)
    confidence: float = _f(_float)


@dataclass
class JudgeScore(_Model):
    id: int = _f(_int)
    consistency: float = _f(_float)
    accuracy: float = _f(_float)
    informativeness: float = _f(_float)
    overall: float = _f(_float)
    comments: str = _f(_str, "")


@dataclass
class AnswerObject(_Model):
    """Answer-generation output contract (answer/generator.py)."""
    answer: str = _f(_str)
    rationale: str = _f(_str)
    citations: List[str] = _f([_str])


CANONICAL_ENTITY_TYPES = (
    "person", "organization", "position", "location", "event", "work", "concept", "date",
)
