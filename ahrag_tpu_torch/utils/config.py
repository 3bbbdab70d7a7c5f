"""Layered configuration: built-in defaults -> YAML file -> environment overrides.

The port's own copy of ``ahrag_tpu/utils/config.py`` (the port imports nothing
of the JAX package): the same ``DEFAULT_CONFIG``, the same merge of
``configs/ahrag.yaml`` over it and the same dotted-path environment
overrides, so both packages read one configuration.

Two differences of form, not of result: PyYAML is optional (the card's
machine may lack it), and its absence is found with ``importlib.util.
find_spec`` rather than by catching an import error, so the defaults hold
exactly as the reference's loader keeps them; and an override whose value
does not parse (``AHRAG_READER_MIN_CONF=abc``) is skipped through a parse
guard, as the reference skips it.
"""
from __future__ import annotations

import copy
import importlib.util
import os
from typing import Any, Dict

from ahrag_tpu_torch.utils.parse import float_or_none

DEFAULT_CONFIG: Dict[str, Any] = {
    "llm": {
        "enabled": False,  # deterministic by default; flip on when provider keys exist
        "default_model": "deepseek-chat",
        "default_temperature": 0.1,
        "default_max_retries": 2,
        "default_rate_limit_wait": 5.0,
        "default_retry_wait": 2.0,
        "default_retry_jitter": 0.0,
        "providers": {
            "kimi": {"api_key_env": "KIMI_API_KEY", "base_url_env": "KIMI_BASE_URL",
                     "default_base_url": "https://api.moonshot.cn/v1"},
            "deepseek": {"api_key_env": "DEEPSEEK_API_KEY", "base_url_env": "DEEPSEEK_BASE_URL",
                         "default_base_url": "https://api.deepseek.com"},
            "openai": {"api_key_env": "OPENAI_API_KEY", "base_url_env": "OPENAI_BASE_URL",
                       "default_base_url": None},
        },
        "modules": {
            "knowledge_extraction": {"enabled": False, "model": "deepseek-chat", "temperature": 0.2,
                                     "max_retries": 4},
            "semantic_aggregation": {"enabled": False, "model": "deepseek-chat", "temperature": 0.2,
                                     "max_retries": 3},
            "agent_decision": {"enabled": False, "model": "deepseek-chat", "temperature": 0.0,
                               "max_retries": 2},
            "answer_generation": {"enabled": False, "model": "deepseek-chat", "temperature": 0.1,
                                  "max_retries": 2},
            "evaluation_judge": {"enabled": False, "model": "deepseek-chat", "temperature": 0.1,
                                 "max_retries": 1, "sample_ratio": 0.2},
        },
    },
    "logging": {"log_level": "normal", "redact": True},
    # Hybrid-search weights/filters; same semantics as reference search_params
    # (hierarchical_graph.py:37-47). Null-able filters stay None.
    "search": {
        "alpha": 0.6, "beta": 0.2, "gamma": 0.1, "delta": 0.1,
        "member_top_m": 5, "top_k": 5,
        "judge_overall_min": None, "confidence_min": None, "type_filter": None,
        "layer_boost": {"entity": 0.0, "summary": 1.0, "hyperedge": 0.0},
    },
    "encoder": {
        "name": "hashed",           # hashed | minilm
        "dim": 384,
        "seed": 7,
        "minilm_weights": None,      # optional path to HF safetensors
    },
    "inference": {"steps": 4},
    "agent": {"use_llm": False},
    "answer": {
        "use_llm": False,
        "model": "deepseek-chat",
        "temperature": 0.1,
        "max_retries": 2,
        "total_context_budget": 6000,
        "skeleton_ratio": 0.2,
        "reserve_ratio": 0.1,
        "summarizer_max_tokens": 256,
        "enable_kept_spans": True,
        "enable_cache": True,
        # learned span reader (answer/reader.py): path to a trained
        # SpanReader .msgpack; None = stage off (fact chain + span scoring)
        "reader_ckpt": None,
        "reader_min_conf": 0.25,
        # measurement mode: the reader IS the whole read path (no fact
        # chain / span rules) — the VERDICT r4 "reader alone" protocol
        "reader_only": False,
    },
    "evaluation": {
        "seed": 42,
        "max_concurrency": 2,       # honored by the benchmark harness (reference's was dead)
        "timeout_s": 60,
        "enable_token_metrics": False,
        "naive_rag_top_k": 5,
        "judge": {"use_llm": False, "sample_ratio": 0.2, "max_retries": 1},
    },
    "rl": {
        "inference": {"use_ppo": False, "ppo_model_path": "artifacts/rl/ppo_policy.msgpack",
                      # round-5 lever: per-question retrieval-knob policy
                      "use_knob_policy": False,
                      "knob_policy_path": "checkpoints/knob_policy.msgpack"},
        "ppo": {"epochs": 3, "gamma": 0.99, "clip_eps": 0.2, "entropy_coef": 0.01,
                "value_coef": 0.5, "lr": 3e-4, "batch_size": 256, "gae_lambda": 0.95},
        "gym": {"max_steps": 6, "repeat_penalty": 0.02},
    },
    "mesh": {"data_axis": "dp", "corpus_axis": "corpus"},
}


def set_nested(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    """Write ``value`` at a dotted path like ``logging.log_level``, creating dicts."""
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _truthy(v: str) -> bool:
    return v.lower() in {"1", "true", "yes"}


_ENV_OVERRIDES = {
    "LOG_LEVEL": ("logging.log_level", str),
    "REDACT": ("logging.redact", _truthy),
    "AHRAG_LLM_ENABLED": ("llm.enabled", _truthy),
    "AHRAG_ENCODER": ("encoder.name", str),
    "AHRAG_READER_CKPT": ("answer.reader_ckpt", str),
    "AHRAG_READER_MIN_CONF": ("answer.reader_min_conf", float_or_none),
    "AHRAG_READER_ONLY": ("answer.reader_only", _truthy),
}


def load_config(path: str | None = "configs/ahrag.yaml",
                overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Load the layered config. ``overrides`` is a final dict-merge for
    programmatic use. The YAML file is read only when PyYAML is installed;
    an override that does not parse leaves its key as it was."""
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if path and os.path.exists(path) and importlib.util.find_spec("yaml") is not None:
        import yaml
        with open(path, "r", encoding="utf-8") as f:
            file_cfg = yaml.safe_load(f) or {}
        if isinstance(file_cfg, dict):
            _deep_merge(cfg, file_cfg)
    for env_key, (dst, caster) in _ENV_OVERRIDES.items():
        val = os.getenv(env_key)
        if val is None:
            continue
        parsed = caster(val)
        if parsed is not None:
            set_nested(cfg, dst, parsed)
    if overrides:
        _deep_merge(cfg, overrides)
    return cfg
