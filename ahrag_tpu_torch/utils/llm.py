"""Unified multi-provider LLM client manager.

The port's copy of ``ahrag_tpu/utils/llm.py``: five module slots
(knowledge_extraction, semantic_aggregation, agent_decision,
answer_generation, evaluation_judge) with per-module switches, model,
temperature and retry knobs over global defaults; provider routing by model
name to OpenAI-compatible endpoints (keys from environment variables); one
``chat`` entry point with progressive backoff, jitter and a separate
rate-limit wait; a process-wide manager; and a deterministic fake backend
(``set_backend``) so every LLM-dependent stage is testable offline.

Differences of form: ``openai`` is found with ``importlib.util.find_spec``,
and a missing key is checked before a client is built, instead of catching
the import or construction error. Callers that fall back to their rule path
when the model cannot answer (the answer generator, the agent's decision) ask
``chat_or_none``, which returns None where ``chat`` would raise; the JAX
package's callers catch the exception instead. The network retry of
``_complete`` is the one place that catches an exception here.
"""
from __future__ import annotations

import importlib.util
import os
import random
import time
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


class LLMModule(Enum):
    KNOWLEDGE_EXTRACTION = "knowledge_extraction"
    SEMANTIC_AGGREGATION = "semantic_aggregation"
    AGENT_DECISION = "agent_decision"
    ANSWER_GENERATION = "answer_generation"
    EVALUATION_JUDGE = "evaluation_judge"


# Backend signature: (model, messages, temperature, max_tokens) -> str (assistant text)
Backend = Callable[[str, List[Dict[str, str]], float, int], str]

_PROVIDER_BY_MODEL_PREFIX = [
    (("moonshot", "kimi"), ("KIMI_API_KEY", "KIMI_BASE_URL", "https://api.moonshot.cn/v1")),
    (("deepseek",), ("DEEPSEEK_API_KEY", "DEEPSEEK_BASE_URL", "https://api.deepseek.com")),
    (("gpt-", "o1", "o3"), ("OPENAI_API_KEY", "OPENAI_BASE_URL", None)),
]


def _is_rate_limit_error(err: Exception) -> bool:
    text = str(err).lower()
    return "rate limit" in text or "max rpm" in text or "too many requests" in text or "429" in text


class LLMClientManager:
    def __init__(self, config: Dict[str, Any]) -> None:
        self.config = config
        self.llm_config = config.get("llm", {})
        self.global_enabled = bool(self.llm_config.get("enabled", False))
        self.modules_config = self.llm_config.get("modules", {})
        self._clients: Dict[str, Any] = {}
        self._backend: Optional[Backend] = None

    # -- test / offline backend ----------------------------------------------
    def set_backend(self, backend: Optional[Backend]) -> None:
        """Install a callable backend (e.g. a deterministic fake) replacing HTTP."""
        self._backend = backend

    # -- enablement ----------------------------------------------------------
    def _module_name(self, module: Union[LLMModule, str]) -> str:
        return module.value if isinstance(module, LLMModule) else str(module)

    def is_enabled(self, module: Union[LLMModule, str]) -> bool:
        if self._backend is not None:
            return True
        if not self.global_enabled:
            return False
        mc = self.modules_config.get(self._module_name(module), {})
        return bool(mc.get("enabled", False))

    def model_config(self, module: Union[LLMModule, str]) -> Dict[str, Any]:
        mc = dict(self.modules_config.get(self._module_name(module), {}))
        out = {
            "model": mc.get("model", self.llm_config.get("default_model", "deepseek-chat")),
            "temperature": mc.get("temperature", self.llm_config.get("default_temperature", 0.1)),
            "max_retries": mc.get("max_retries", self.llm_config.get("default_max_retries", 2)),
            "rate_limit_wait": mc.get("rate_limit_wait",
                                      self.llm_config.get("default_rate_limit_wait", 5.0)),
            "retry_wait": mc.get("retry_wait", self.llm_config.get("default_retry_wait", 2.0)),
            "retry_jitter": mc.get("retry_jitter", self.llm_config.get("default_retry_jitter", 0.0)),
        }
        for k, v in mc.items():
            out.setdefault(k, v)
        return out

    # -- client construction -------------------------------------------------
    def _client_for(self, model: str):
        """An OpenAI-compatible client for ``model``, or None when ``openai``
        is not installed or the provider's key is not set."""
        if model in self._clients:
            return self._clients[model]
        if importlib.util.find_spec("openai") is None:
            return None
        api_key = base_url = None
        for prefixes, (key_env, url_env, default_url) in _PROVIDER_BY_MODEL_PREFIX:
            if any(model.startswith(p) or model == p for p in prefixes):
                api_key = os.getenv(key_env)
                base_url = os.getenv(url_env) or default_url
                break
        else:
            api_key = os.getenv("DEEPSEEK_API_KEY")
            base_url = os.getenv("DEEPSEEK_BASE_URL") or "https://api.deepseek.com"
        if not api_key:
            return None
        from openai import OpenAI
        client = OpenAI(api_key=api_key, base_url=base_url)
        self._clients[model] = client
        return client

    # -- chat ----------------------------------------------------------------
    def _complete(self, module: Union[LLMModule, str], messages: List[Dict[str, str]],
                  temperature: Optional[float], max_tokens: int,
                  **kwargs: Any) -> Tuple[Optional[str], Optional[Exception]]:
        """(assistant text, None), or (None, the error) once the module is
        off, no client exists or every attempt failed. Attempts back off
        progressively, longer after a rate-limit error."""
        cfg = self.model_config(module)
        model = kwargs.pop("model", cfg["model"])
        temp = cfg["temperature"] if temperature is None else temperature
        attempts = max(0, int(kwargs.pop("max_retries", cfg["max_retries"]))) + 1

        if self._backend is not None:
            return self._backend(model, messages, float(temp), int(max_tokens)), None

        if not self.is_enabled(module):
            return None, RuntimeError(f"LLM disabled for module {self._module_name(module)}")
        client = self._client_for(model)
        if client is None:
            return None, RuntimeError(f"No LLM client available for model {model}")

        last_error: Optional[Exception] = None
        for attempt in range(1, attempts + 1):
            try:
                resp = client.chat.completions.create(
                    model=model, messages=messages, temperature=float(temp),
                    max_tokens=int(max_tokens), **kwargs)
            except Exception as exc:  # network dependent: retried, then reported
                last_error = exc
                if attempt >= attempts:
                    break
                wait = cfg["rate_limit_wait"] if _is_rate_limit_error(exc) else cfg["retry_wait"]
                wait = max(0.0, float(wait)) * attempt
                if cfg["retry_jitter"]:
                    wait += random.uniform(0, float(cfg["retry_jitter"]))
                if wait > 0:
                    time.sleep(wait)
                continue
            return resp.choices[0].message.content or "", None
        return None, last_error or RuntimeError("LLM call failed")

    def chat(self, module: Union[LLMModule, str], messages: List[Dict[str, str]],
             temperature: Optional[float] = None, max_tokens: int = 400, **kwargs: Any) -> str:
        """The assistant message text; raises the last error once every
        attempt failed, or when the module is off or has no client."""
        text, error = self._complete(module, messages, temperature, max_tokens, **kwargs)
        if error is not None:
            raise error
        return text

    def chat_or_none(self, module: Union[LLMModule, str], messages: List[Dict[str, str]],
                     temperature: Optional[float] = None, max_tokens: int = 400,
                     **kwargs: Any) -> Optional[str]:
        """``chat``, or None where ``chat`` would raise."""
        return self._complete(module, messages, temperature, max_tokens, **kwargs)[0]


_global_manager: Optional[LLMClientManager] = None


def get_llm_manager(config: Optional[Dict[str, Any]] = None) -> LLMClientManager:
    global _global_manager
    if _global_manager is None or config is not None:
        if config is None:
            from ahrag_tpu_torch.utils.config import load_config
            config = load_config()
        _global_manager = LLMClientManager(config)
    return _global_manager


def reset_llm_manager() -> None:
    global _global_manager
    _global_manager = None
