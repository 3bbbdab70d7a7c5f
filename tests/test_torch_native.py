"""The port's native graph runtime against the JAX package's, on the CPU.

``ahrag_tpu_torch.native``'s ELL construction (``ell_from_edges``), degree scan
(``max_degree``) and host top-k (``exact_topk``), the port's ``_ell`` on both
sides of its 10,000-edge threshold and ``build_graph_tensors`` from dict
adjacencies above it, each held against the JAX package on the same seeded
numpy inputs. The JAX package is taken on both of its routes: its library,
compiled from its own ``ahrag_native.cpp`` into pytest's temporary directory
(never the port's build), and its Python fallback (the library marked absent).

Tolerances: tables, degrees and ids equal; top-k values within
``rtol=1e-5`` (the Python route scores with a numpy matmul, the library
with its own float32 loop).
"""
import os
import pathlib
import subprocess

import numpy as np
import pytest

from ahrag_tpu import native as jnative
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu_torch import native
from ahrag_tpu_torch.graph import tensors as ttensors

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_NATIVE_SOURCE = os.path.join(ROOT, "ahrag_tpu", "native", "ahrag_native.cpp")
ROUTES = ("jax_native", "jax_python")


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """The JAX package's library, compiled from its own source."""
    so = tmp_path_factory.mktemp("jax_native") / "libahrag_native.so"
    subprocess.run([native.find_cxx(), *native.CXX_FLAGS, "-o", str(so),
                    JAX_NATIVE_SOURCE, "-lpthread"], check=True, capture_output=True)
    return str(so)


@pytest.fixture(params=ROUTES)
def jax_route(request, jax_library, monkeypatch):
    """The JAX package's bindings on its library or on its Python fallback."""
    if request.param == "jax_native":
        monkeypatch.setattr(jnative, "_SO", jax_library)
        monkeypatch.setattr(jnative, "_tried", False)
        monkeypatch.setattr(jnative, "_lib", None)
        assert jnative.available()
    else:
        monkeypatch.setattr(jnative, "_tried", True)
        monkeypatch.setattr(jnative, "_lib", None)
        assert not jnative.available()
    return request.param


def test_the_port_loads_its_own_build(jax_library):
    assert native.available()
    assert native.load_library()._name == native.build()["path"]
    assert os.path.dirname(native.build()["path"]) == str(native.BUILD_DIR)
    assert os.path.dirname(jax_library) != str(native.BUILD_DIR)


@pytest.mark.parametrize("call", [
    lambda: native.ell_from_edges(np.array([0]), np.array([1]), 2, 2, 8),
    lambda: native.max_degree(np.array([0, 0]), 2),
    lambda: native.exact_topk(np.ones((1, 4)), np.ones((3, 4)), 2)],
    ids=["ell_from_edges", "max_degree", "exact_topk"])
def test_no_python_fallback_without_a_compiler(call, monkeypatch):
    """With the library unloaded and no compiler on PATH, ``available`` says
    False and each binding raises instead of computing in Python."""
    native.load_library.cache_clear()
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        call()
    monkeypatch.undo()
    native.load_library.cache_clear()
    assert native.available()


def _edges(case: str):
    """(src, dst, n_nodes, n_pad, k) of each ``ell_from_edges`` case."""
    rng = np.random.default_rng(11)
    if case == "order":            # every row's neighbours in edge order
        src = rng.integers(0, 50, 400)
        return src, rng.integers(0, 10_000, 400), 50, 64, 16
    if case == "overflow":         # rows past k truncated
        src = rng.integers(0, 6, 300)
        return src, rng.integers(0, 500, 300), 6, 8, 4
    if case == "out_of_range":     # src outside [0, n_nodes) dropped
        src = rng.integers(-5, 45, 500)
        return src, rng.integers(0, 40, 500), 40, 40, 24
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 30, 32, 8
    src = rng.integers(0, 60, 700)   # n_pad > n_nodes: rows past n_nodes stay -1
    return src, rng.integers(0, 60, 700), 40, 128, 32


@pytest.mark.parametrize("case", ["order", "overflow", "out_of_range", "empty",
                                  "n_pad_above_n_nodes"])
def test_ell_from_edges_matches_jax(case, jax_route):
    src, dst, n_nodes, n_pad, k = _edges(case)
    port = native.ell_from_edges(src, dst, n_nodes, n_pad, k)
    ref = jnative.ell_from_edges(src, dst, n_nodes, n_pad, k)
    assert port.dtype == np.int32 and port.shape == (n_pad, k)
    np.testing.assert_array_equal(port, ref)
    if case == "order":
        for s in range(n_nodes):
            row = dst[src == s][:k]
            np.testing.assert_array_equal(port[s, :len(row)], row)
    if case == "overflow":
        assert (port[:n_nodes] >= 0).all()
    if case in ("empty", "n_pad_above_n_nodes"):
        assert (port[n_nodes:] == -1).all()
    if case == "empty":
        assert (port == -1).all()


@pytest.mark.parametrize("case", ["random", "out_of_range", "empty"])
def test_max_degree_matches_jax(case, jax_route):
    rng = np.random.default_rng(5)
    src = {"random": rng.integers(0, 100, 2_000),
           "out_of_range": np.concatenate([rng.integers(0, 30, 200), np.full(90, 31),
                                           np.full(80, -1)]),
           "empty": np.zeros(0, np.int32)}[case]
    port = native.max_degree(src, 30 if case == "out_of_range" else 100)
    assert port == jnative.max_degree(src, 30 if case == "out_of_range" else 100)
    assert port == (0 if case == "empty" else
                    np.bincount(src[(src >= 0) & (src < 30)]).max() if case == "out_of_range"
                    else np.bincount(src).max())


def _topk_inputs(case: str):
    rng = np.random.default_rng(7)
    if case == "random":
        return (rng.standard_normal((3, 32)).astype(np.float32),
                rng.standard_normal((500, 32)).astype(np.float32), 7)
    row = rng.integers(-3, 4, (1, 32)).astype(np.float32)   # exact scores in any order
    if case == "identical_rows":
        return rng.integers(-3, 4, (2, 32)).astype(np.float32), np.repeat(row, 40, 0), 9
    return rng.standard_normal((2, 32)).astype(np.float32), \
        rng.standard_normal((5, 32)).astype(np.float32), 12          # k > n


@pytest.mark.parametrize("case", ["random", "identical_rows", "k_above_n"])
def test_exact_topk_matches_jax(case, jax_route):
    q, emb, k = _topk_inputs(case)
    vals, ids = native.exact_topk(q, emb, k)
    ref_vals, ref_ids = jnative.exact_topk(q, emb, k)
    kk = min(k, emb.shape[0])
    assert vals.shape == ids.shape == (q.shape[0], kk)
    assert vals.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-5)
    np.testing.assert_allclose(vals, np.take_along_axis(q @ emb.T, ids.astype(np.int64), 1),
                               rtol=1e-5)
    if case == "identical_rows":      # every tie to the lowest index
        np.testing.assert_array_equal(ids, np.tile(np.arange(kk), (q.shape[0], 1)))
    if case == "k_above_n":
        assert sorted(ids[0].tolist()) == list(range(emb.shape[0]))


def _adjacency(case: str):
    """(dict adjacency, n_pad) of each ``_ell`` case."""
    rng = np.random.default_rng(13)
    if case == "9999_edges":          # one edge short of the native path
        deg = np.full(1_000, 10)
        deg[0], deg[1] = 17, 2        # row 0 sets K = 24
        n, n_pad = 1_000, 1_024
    elif case == "10000_edges":       # exactly at the threshold
        deg = np.full(1_000, 10)
        deg[0], deg[1] = 13, 7
        n, n_pad = 1_000, 1_024
    elif case == "1000x12":
        deg = np.full(1_000, 12)
        n, n_pad = 1_000, 1_024
    else:                             # 20,000 nodes, ragged rows, some empty
        deg = rng.integers(0, 4, 20_000)
        n, n_pad = 20_000, 20_480
    adj = {i: [int(x) for x in rng.integers(0, n, int(m))]
           for i, m in enumerate(deg) if m or case != "20000_nodes"}
    return adj, n_pad


@pytest.mark.parametrize("case", ["9999_edges", "10000_edges", "1000x12", "20000_nodes"])
def test_ell_matches_jax_on_both_sides_of_the_threshold(case, jax_route, monkeypatch):
    adj, n_pad = _adjacency(case)
    total = sum(len(v) for v in adj.values())
    assert (total == 9_999) == (case == "9999_edges")
    native_calls = []
    ell_from_edges = native.ell_from_edges

    def counted(*a):
        native_calls.append(a[2:])
        return ell_from_edges(*a)

    monkeypatch.setattr(ttensors.native, "ell_from_edges", counted)
    port = ttensors._ell(adj, n_pad)
    np.testing.assert_array_equal(port, jtensors._ell(adj, n_pad))
    k = port.shape[1]
    assert native_calls == ([] if total < 10_000 else [(n_pad, n_pad, k)])
    np.testing.assert_array_equal(port, ttensors._ell_loop(adj, n_pad, k))


@pytest.fixture(scope="module")
def dict_graph():
    """A 3,000-node graph whose children, parents and members each hold
    10,000 edges or more, ragged, with empty rows."""
    rng = np.random.default_rng(17)
    n, d = 3_000, 8
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    def ragged(lo, hi, every=1):
        return {i: [int(x) for x in rng.integers(0, n, int(rng.integers(lo, hi)))]
                for i in range(0, n, every)}

    children = ragged(0, 9)
    return dict(embeddings=emb, node_types=[i % 3 for i in range(n)],
                levels=[i % 2 for i in range(n)],
                judges=[None if i % 4 else 7.5 for i in range(n)],
                confs=[float(i % 9) if i % 5 else None for i in range(n)],
                indexed=[i % 11 != 0 for i in range(n)], parents=ragged(2, 7),
                children=children, related=ragged(0, 3, 5), hyperedges=ragged(3, 12, 2),
                members=ragged(4, 10), n_edges=sum(map(len, children.values())))


def test_build_graph_tensors_from_large_dicts_matches_jax(dict_graph, jax_route):
    totals = {f: sum(map(len, dict_graph[f].values()))
              for f in ("parents", "children", "related", "hyperedges", "members")}
    assert min(totals.values()) < 10_000 <= min(totals["parents"], totals["children"],
                                                   totals["hyperedges"], totals["members"])
    jgt = jtensors.build_graph_tensors(**dict_graph, pack_children=True)
    tgt = ttensors.build_graph_tensors(**dict_graph, pack_children=True, device="cpu")
    for name in ("parents", "children", "related", "hyperedges", "members",
                 "child_pack_slot", "child_pack_ids", "child_pack_emb"):
        np.testing.assert_array_equal(getattr(tgt, name).numpy(),
                                      np.asarray(getattr(jgt, name)), err_msg=name)
    assert tgt.n_edges == jgt.n_edges and tgt.n_pad == jgt.n_pad
