"""The port's config loader and profiling utilities against the JAX package's."""
import importlib.util
import os
import sys
import threading

import pytest
import torch

from ahrag_tpu.utils import config as jconfig
from ahrag_tpu.utils import profiling as jprofiling
from ahrag_tpu_torch.utils import config as tconfig
from ahrag_tpu_torch.utils import profiling as tprofiling

ENV = {"LOG_LEVEL": "debug", "REDACT": "no", "AHRAG_LLM_ENABLED": "TRUE",
       "AHRAG_ENCODER": "minilm", "AHRAG_READER_CKPT": "ckpt/reader.msgpack",
       "AHRAG_READER_MIN_CONF": "0.5", "AHRAG_READER_ONLY": "yes"}


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    for key in tconfig._ENV_OVERRIDES:
        monkeypatch.delenv(key, raising=False)


def test_defaults_and_overrides_table_are_the_jax_packages():
    assert tconfig.DEFAULT_CONFIG == jconfig.DEFAULT_CONFIG
    assert set(tconfig._ENV_OVERRIDES) == set(jconfig._ENV_OVERRIDES)
    assert {k: v[0] for k, v in tconfig._ENV_OVERRIDES.items()} == \
        {k: v[0] for k, v in jconfig._ENV_OVERRIDES.items()}


@pytest.mark.parametrize("path", ["configs/ahrag.yaml", None, "no/such/file.yaml"])
def test_load_config_matches_jax_with_yaml(path):
    overrides = {"search": {"top_k": 9}, "new": {"key": 1}}
    assert tconfig.load_config(path) == jconfig.load_config(path)
    assert tconfig.load_config(path, overrides=overrides) == \
        jconfig.load_config(path, overrides=overrides)


def test_load_config_matches_jax_without_yaml(monkeypatch):
    """Without PyYAML both loaders keep the defaults: the port asks
    ``find_spec``, the JAX package's import fails."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "yaml" else real(name, *a))
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = tconfig.load_config()
    assert got == jconfig.load_config() == tconfig.DEFAULT_CONFIG


@pytest.mark.parametrize("key", sorted(ENV))
@pytest.mark.parametrize("value", ["good", "abc", ""])
def test_each_env_override_matches_jax(monkeypatch, key, value):
    monkeypatch.setenv(key, ENV[key] if value == "good" else value)
    assert tconfig.load_config() == jconfig.load_config()


def test_set_nested_and_deep_merge_match_jax():
    for mod in (tconfig, jconfig):
        cfg = {"a": {"b": 1}, "c": 2}
        mod.set_nested(cfg, "a.x.y", 3)
        mod.set_nested(cfg, "c.d", 4)
        mod._deep_merge(cfg, {"a": {"b": {"z": 5}}, "e": [1]})
        assert cfg == {"a": {"b": {"z": 5}, "x": {"y": 3}}, "c": {"d": 4}, "e": [1]}


def test_timers_match_jax_and_record_when_the_body_raises():
    jt, tt = jprofiling.Timers(), tprofiling.Timers()
    for timers in (jt, tt):
        with timers.timed("a"):
            pass
        with pytest.raises(ZeroDivisionError):
            with timers.timed("a"):
                1 / 0
        with pytest.raises(KeyError):
            with timers.timed("b", block_on=torch.zeros(3)):
                {}["missing"]
    js, ts = jt.snapshot(), tt.snapshot()
    assert set(js) == set(ts) == {"a", "b"}
    for name in js:
        assert set(ts[name]) == set(js[name])
        assert ts[name]["count"] == js[name]["count"]
    assert ts["a"]["count"] == 2 and ts["b"]["count"] == 1
    tt.reset()
    assert tt.snapshot() == {}


def test_latency_recorder_matches_jax():
    jr, tr = jprofiling.LatencyRecorder(max_samples=5), tprofiling.LatencyRecorder(max_samples=5)
    for rec in (jr, tr):
        for s in (0.004, 0.001, 0.003, 0.010, 0.002, 0.007, 0.005):
            rec.record("request", s)
        with pytest.raises(RuntimeError):
            with rec.timed("raised"):
                raise RuntimeError("x")
    js, ts = jr.snapshot(), tr.snapshot()
    assert js["request"] == ts["request"]
    assert ts["raised"]["count"] == 1.0
    tr.reset()
    assert tr.snapshot() == {}


def test_timers_are_thread_safe():
    timers = tprofiling.Timers()

    def work():
        for _ in range(500):
            with timers.timed("x"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert timers.snapshot()["x"]["count"] == 4000


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with tprofiling.trace(None) as prof:
        assert prof is None
    with tprofiling.trace(str(tmp_path)) as prof:
        with tprofiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "my_region" in names and "aten::matmul" in names
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert os.path.exists(tmp_path / "trace.json")


@pytest.mark.parametrize("maxsize", [None, 2])
def test_locked_cache_computes_a_cold_key_once_and_keeps_maxsize(maxsize):
    """Of 8 threads that reach a cold key together one computes; with
    ``maxsize=2`` a third key evicts the first, bare ``locked_cache`` keeps all."""
    from ahrag_tpu_torch.utils.once import locked_cache
    calls, gate = [], threading.Barrier(8)

    def square(x):
        calls.append(x)
        return [x * x]

    fn = locked_cache(square) if maxsize is None else locked_cache(maxsize=maxsize)(square)
    out = []

    def worker():
        gate.wait()
        out.append(fn(3))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [3] and all(o is out[0] for o in out)
    first = fn(3)
    fn(4), fn(5)
    assert fn.cache_info().maxsize == maxsize
    assert fn.cache_info().currsize == (3 if maxsize is None else 2)
    assert (fn(3) is first) == (maxsize is None)
