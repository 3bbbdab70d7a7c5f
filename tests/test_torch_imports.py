"""The port stands alone: it imports nothing of JAX or the JAX package, and
its entry points refuse to slide to the CPU when no card is present."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ahrag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "ahrag_tpu", "bench")

_GUARD = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None          # any import of these now raises
import torch
assert not torch.cuda.is_available(), "this check runs without a card"
import ahrag_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ahrag_tpu_torch.__path__, "ahrag_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import numpy as np
from ahrag_tpu_torch.graph.tensors import build_graph_tensors
from ahrag_tpu_torch.graph.search import SearchWeights
from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder
from ahrag_tpu_torch.bench_data import build_bench_arrays, bench_tensors
calls = [lambda: SearchWeights.create(),
         lambda: HashedNGramEncoder(dim=8, buckets=64),
         lambda: bench_tensors(build_bench_arrays(64, 8, d=8), "float32")]
for fn in calls:
    try:
        fn()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("an entry point ran without a card and without device='cpu'")
print("imported", len(mods), "modules")
"""


def _run(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    proc = _run(_GUARD.format(blocked=BLOCKED), ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path.name} imports {name}"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_NEW_ENTRY_POINTS = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
from ahrag_tpu_torch.models.encoder import create_encoder
from ahrag_tpu_torch.ops import dense_topk, dense_topk_fused
try:
    create_encoder()
except RuntimeError as e:
    assert "CUDA" in str(e), e
else:
    raise AssertionError("create_encoder ran without a card and without device='cpu'")
q, e = torch.zeros(2, 8), torch.zeros(1024, 8)
assert dense_topk(q, e, 1024, 3)[1].shape == (2, 3)     # CPU tensors: the plain path
print("ok")
"""


def test_new_entry_points_refuse_cpu_fallback():
    proc = _run(_NEW_ENTRY_POINTS.format(blocked=BLOCKED), ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok" in proc.stdout


def test_no_try_in_the_port():
    """No kernel falls back to its plain version, and no native call to
    Python, on failure: the port has no ``try`` statement at all."""
    for path in PORT_FILES:
        tries = [n.lineno for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, (ast.Try, getattr(ast, "TryStar", ast.Try)))]
        assert not tries, f"{path.relative_to(ROOT)} has a try at lines {tries}"


def test_signatures_match_the_cuda_launchers():
    """``_build._SIGNATURES`` names every ``extern "C"`` launcher of
    ``csrc/*.cu`` with its argument count, and nothing else."""
    import re
    from ahrag_tpu_torch.ops import _build
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert found, "no extern \"C\" launcher found"
    assert {n: len(a) for n, a in _build._SIGNATURES.items()} == found
