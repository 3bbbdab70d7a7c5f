"""The port's MicroBatcher, RetrievalService, serve_http and run_load.

Every MicroBatcher scenario of ``tests/test_serve.py`` runs against the port's
class (the JAX test functions, with the class they use swapped), and so do the
service scenarios, ``answer`` and ``/answer`` included. The service on the film graph
(``device="cpu"``) is held against ``hg.search`` and against the JAX
``RetrievalService`` on the same saved graph: ids equal, scores within 1e-4
(the result entries round to four decimals).
"""
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import tests.test_serve as jtests
from ahrag_tpu.serve import RetrievalService as JRS
from ahrag_tpu_torch import native
from ahrag_tpu_torch import serve as tserve
from ahrag_tpu_torch.cli.serve_bench import run_load
from ahrag_tpu_torch.graph import HierarchicalGraph as THG
from ahrag_tpu_torch.ops import topk as ttopk
from tests.helpers import build_film_graph

QUERIES = ["Who directed Ed Wood?", "American film directors", "Doctor Strange",
           "Tim Burton", "Kathryn Bigelow", "Ed Wood film", "Adam Collis"]

BATCHER_SCENARIOS = [
    "test_microbatcher_coalesces",
    "test_microbatcher_quiet_window_grows_batches",
    "test_microbatcher_coalesce_cap_bounds_extension",
    "test_microbatcher_cross_generation_stress",
    "test_microbatcher_survives_process_exception",
    "test_microbatcher_submit_timeout",
    "test_microbatcher_close_drains_pending",
    "test_microbatcher_three_stage_pipeline_correctness",
    "test_microbatcher_mid_stage_exception_releases_batch",
    "test_microbatcher_close_poisons_wedged_pipeline",
    "test_microbatcher_parallel_last_stage_overlaps_round_trips",
    "test_microbatcher_mid_stage_workers",
]
SERVICE_SCENARIOS = [
    "test_service_search_and_answer",
    "test_http_endpoints",
    "test_concurrent_search_consistency",
    "test_fused_serving_path_matches_host_search",
    "test_serving_thread_safety_stress",
    "test_beam_endpoint",
    "test_http_timeout_maps_to_503",
]


@pytest.fixture(scope="module")
def saved_film(tmp_path_factory):
    hg = build_film_graph()
    hg.build_vector_index(layers=(0, 1, 2))
    d = tmp_path_factory.mktemp("film")
    hg.save(str(d))
    return str(d)


@pytest.fixture(scope="module")
def service(saved_film):
    svc = tserve.RetrievalService(graph_dir=saved_film, max_wait_s=0.005, device="cpu")
    yield svc
    svc.close()


def ids(results):
    return [r["node_id"] for r in results]


def assert_same_results(a, b):
    assert ids(a) == ids(b)
    for x, y in zip(a, b):
        assert abs(x["score"] - y["score"]) <= 1e-4
        assert abs(x["semantic"] - y["semantic"]) <= 1e-4


@pytest.mark.parametrize("name", BATCHER_SCENARIOS)
def test_port_microbatcher_passes_the_jax_scenario(name, monkeypatch):
    monkeypatch.setattr(jtests, "MicroBatcher", tserve.MicroBatcher)
    getattr(jtests, name)()


@pytest.mark.parametrize("name", SERVICE_SCENARIOS)
def test_port_service_passes_the_jax_scenario(name, service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)            # answers write their session files here
    monkeypatch.setattr(jtests, "serve_http", tserve.serve_http)
    fn = getattr(jtests, name)
    if name == "test_http_timeout_maps_to_503":
        fn(service, monkeypatch)
    else:
        fn(service)


def test_microbatcher_reports_a_stage_that_returns_no_sequence():
    mb = tserve.MicroBatcher(stages=[lambda items: items, lambda token: 42],
                             max_batch=1, max_wait_s=0.0005)
    with pytest.raises(RuntimeError, match="not a sequence"):
        mb.submit(1, timeout_s=5)
    mb2 = tserve.MicroBatcher(lambda items: items[:-1], max_batch=1, max_wait_s=0.0005)
    with pytest.raises(RuntimeError, match="0 results for 1 items"):
        mb2.submit(1, timeout_s=5)
    mb.close()
    mb2.close()


def test_search_search_many_warmup_labels_and_answer(service, saved_film, tmp_path,
                                                     monkeypatch):
    one = service.search("Who directed Ed Wood?")
    many = service.search_many(QUERIES)
    assert one == many[0] and len(many) == len(QUERIES)
    assert one and one[0]["score"] >= one[-1]["score"]
    timers = service.stats()["timers"]
    assert {"featurize", "search_batch_warmup", "search_finalize", "assemble"} <= set(timers)
    service.search_many(QUERIES)        # a warmed (bucket, packed shape)
    assert "search_batch" in service.stats()["timers"]
    stats = service.stats()
    assert stats["graph"]["n_nodes"] == 10 and "request" in stats["latency"]
    # answer (the agent and answer modules over the service's graph) gives the
    # JAX service's answer, rationale, citations and retrieved nodes; its
    # session files go under the working directory
    from ahrag_tpu.graph import HierarchicalGraph as JHG
    monkeypatch.chdir(tmp_path)
    jsvc = JRS(hg=JHG.load(saved_film), max_wait_s=0.002)
    keys = ("query", "answer", "rationale", "citations", "retrieved_nodes")
    for q in QUERIES[:3]:
        got, want = service.answer(q), jsvc.answer(q)
        assert set(got) == {*keys, "metrics"} and got["answer"] and got["retrieved_nodes"]
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert "answer" in service.stats()["timers"]
    assert len(list((tmp_path / "artifacts" / "sessions").iterdir())) == 6
    jsvc.close()


def test_fused_path_equals_host_search(service):
    for q, fused in zip(QUERIES, service.search_many(QUERIES)):
        assert_same_results(fused, service.hg.search(q, top_k=5))


def test_service_ids_equal_the_jax_service(saved_film):
    from ahrag_tpu.graph import HierarchicalGraph as JHG
    jsvc = JRS(hg=JHG.load(saved_film), max_wait_s=0.002)
    tsvc = tserve.RetrievalService(graph_dir=saved_film, max_wait_s=0.002, device="cpu")
    for a, b in zip(tsvc.search_many(QUERIES), jsvc.search_many(QUERIES)):
        assert_same_results(a, b)
    for q in QUERIES[:3]:
        assert_same_results(tsvc.search(q), jsvc.search(q))
        assert ids(tsvc.beam(q, beam_width=4, depth=2, top_k=5)) == \
            ids(jsvc.beam(q, beam_width=4, depth=2, top_k=5))
    jsvc.close()
    tsvc.close()


def test_service_without_a_device_needs_a_card(saved_film):
    hg = THG.load(saved_film, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.RetrievalService(hg=hg)


def _post(base, path, obj, raw=None):
    req = urllib.request.Request(f"{base}{path}", data=raw or json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post_error(base, path, obj, raw=None):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, path, obj, raw)
    return ei.value.code


def test_http_endpoints(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)            # /answer writes its session files here
    server = tserve.serve_http(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    want = service.search_many(QUERIES[:3])
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert r.status == 200 and json.loads(r.read()) == {"ok": True, "nodes": 10}
    status, body = _post(base, "/search", {"query": QUERIES[0]})
    assert status == 200 and [ids(r) for r in body["results"]] == [ids(want[0])]
    status, body = _post(base, "/search", {"queries": QUERIES[:3]})
    assert status == 200 and [ids(r) for r in body["results"]] == [ids(w) for w in want]
    status, body = _post(base, "/beam", {"query": QUERIES[0], "beam_width": 4,
                                         "depth": 2, "top_k": 5})
    assert status == 200 and ids(body["results"]) == ids(
        service.beam(QUERIES[0], beam_width=4, depth=2, top_k=5))
    status, body = _post(base, "/answer", {"query": QUERIES[0], "steps": 3})
    want = service.answer(QUERIES[0], steps=3)
    assert status == 200 and {k: v for k, v in body.items() if k != "metrics"} == \
        {k: v for k, v in want.items() if k != "metrics"}
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        assert r.status == 200 and "search_finalize" in json.loads(r.read())["timers"]
    assert _post_error(base, "/search", None, raw=b"{not json") == 400
    assert _post_error(base, "/search", {"queries": []}) == 400
    assert _post_error(base, "/beam", {}) == 400
    assert _post_error(base, "/nowhere", {"query": "x"}) == 404
    assert _post_error(base, "/answer", {}) == 400
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_run_load_percentiles_and_batcher_stats(service):
    before = service._batcher.stats()["items"]
    report = run_load(service, QUERIES[:3], threads=4, requests_per_thread=3, warmup=1)
    assert report["errors"] == 0 and report["requests"] == 12
    lat = report["latency_ms"]
    assert lat["count"] == 12
    assert 0 < lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"] <= lat["max_ms"]
    assert report["batcher"]["items"] - before == 12
    assert report["batcher"]["mean_batch"] >= 1.0
    assert "search_batch" in report["server_timers"]        # warm shapes only:
    assert "search_batch_warmup" not in report["server_timers"]   # reset after warm-up


def test_run_load_counts_errors(service, monkeypatch):
    def failing(query):
        raise TimeoutError("synthetic deadline")

    monkeypatch.setattr(service, "search", failing)
    report = run_load(service, QUERIES[:2], threads=2, requests_per_thread=2, warmup=1)
    assert report["errors"] == 4 and report["requests"] == 4


def test_eight_cold_threads_calibrate_once(saved_film, monkeypatch):
    """Eight threads that reach a service with cold calibration caches at once
    get one calibration between them and their own, correct results."""
    svc = tserve.RetrievalService(graph_dir=saved_film, max_wait_s=0.001, device="cpu")
    expected = [ids(r) for r in svc.search_many(QUERIES)]
    calls = []
    orig = ttopk._calibration_inputs
    monkeypatch.setattr(ttopk, "_calibration_inputs",
                        lambda *a: calls.append(a) or orig(*a))
    ttopk.matmul_eps.cache_clear()
    ttopk.binmax_eps.cache_clear()
    barrier = threading.Barrier(8)
    got = {}

    def worker(i):
        barrier.wait()
        got[i] = [ids(r) for r in svc.search_many(QUERIES[i % 7:] + QUERIES[:i % 7])]
        got[f"single{i}"] = ids(svc.search(QUERIES[i % 7]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    svc.close()
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1, calls
    for i in range(8):
        assert got[i] == expected[i % 7:] + expected[:i % 7]
        assert got[f"single{i}"] == expected[i % 7]


def test_native_library_loads_once_under_eight_threads(monkeypatch):
    calls = []
    orig = native.build
    monkeypatch.setattr(native, "build", lambda: calls.append(1) or orig())
    native.load_library.cache_clear()
    barrier = threading.Barrier(8)
    libs = []

    def worker():
        barrier.wait()
        libs.append(native.load_library())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_launch_counter_is_exact_under_threads():
    """``count_launch`` adds one per call under a lock: 8 threads x 2,000
    calls leave the count at 16,000."""
    from ahrag_tpu_torch.ops._build import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(wrapper)
                                                    for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16000


def test_lazy_top_level_exports():
    import ahrag_tpu_torch
    assert ahrag_tpu_torch.HierarchicalGraph is THG
    assert ahrag_tpu_torch.RetrievalService is tserve.RetrievalService
    with pytest.raises(AttributeError):
        ahrag_tpu_torch.GraphEnvironment


def test_serve_cli_answers_and_stops_on_sigterm(saved_film):
    """``python -m ahrag_tpu_torch.cli.serve`` serves /healthz and exits 0 on
    SIGTERM."""
    import os
    import signal
    import subprocess
    import time
    proc = subprocess.Popen(
        [sys.executable, "-m", "ahrag_tpu_torch.cli.serve", "--graph", saved_film,
         "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    line = proc.stdout.readline()
    assert line.startswith("serving on http://"), line
    base = line.split()[2]
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert json.loads(r.read())["nodes"] == 10
    proc.send_signal(signal.SIGTERM)
    t0 = time.time()
    assert proc.wait(timeout=30) == 0 and time.time() - t0 < 30


def test_serve_bench_cli_sweep(saved_film, tmp_path):
    from ahrag_tpu_torch.cli import serve_bench
    out = tmp_path / "report.json"
    serve_bench.main(["--graph", saved_film, "--threads", "2", "--requests", "2",
                      "--sweep", "1,4", "--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    assert [r["max_batch"] for r in report["sweep"]] == [1, 4]
    assert all(r["errors"] == 0 and r["device"] == "cpu" for r in report["sweep"])
    assert report["best_p99"] in (1, 4)
    assert np.isfinite(report["sweep"][0]["latency_ms"]["p99_ms"])
