"""The port's top-k ladder benchmark (``cli/topk_bench.py``) against the JAX
package's, on the CPU at a small size.

JAX's ``run_ladder`` runs on the CPU only the variants that need no Pallas
kernel (its bin-max variants need the TPU or interpret mode), so the report
keys are compared at an N that is no multiple of 2048, where both run flat,
approx and refined; the port's seven variants (the kernels' plain versions
on the CPU) run at N = 8192. Every oracle mismatch is 0. The ``approx``
variant is an exact top-k: on the CPU, JAX's ``approx_max_k`` gives the ids
of ``lax.top_k``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ahrag_tpu.cli import topk_bench as jbench
from ahrag_tpu_torch.cli import topk_bench as tbench
from ahrag_tpu_torch.device import stable_topk

ALL_VARIANTS = "flat,approx,binmax,binmax_hi,binned,binned_hi,refined"
# the variants whose final ids are held against the oracle
ORACLE = ("flat", "approx", "binned", "binned_hi", "refined")


@pytest.fixture(scope="module")
def ladders():
    jax_rep = jbench.run_ladder(5000, 16, 32, 5, reps=1)
    port_rep = tbench.run_ladder(5000, 16, 32, 5, reps=1, device="cpu")
    full = tbench.run_ladder(8192, 16, 32, 5, reps=1, variants=ALL_VARIANTS, device="cpu")
    return jax_rep, port_rep, full


def _variants(rep):
    return {k for k, v in rep.items() if isinstance(v, dict)}


def test_report_has_the_jax_keys_for_every_variant_jax_runs(ladders):
    jax_rep, port_rep, _ = ladders
    assert _variants(jax_rep) == _variants(port_rep) == {"flat", "approx", "refined"}
    assert set(jax_rep) <= set(port_rep)
    for v in _variants(jax_rep):
        assert set(jax_rep[v]) <= set(port_rep[v]), v
        assert jax_rep[v]["oracle_mismatch"] == port_rep[v]["oracle_mismatch"] == 0, v
    assert port_rep["backend"] == jax_rep["backend"] == "cpu"
    assert port_rep["flat_hbm_model_gb"] == pytest.approx(jax_rep["flat_hbm_model_gb"])


@pytest.mark.parametrize("variant", ALL_VARIANTS.split(","))
def test_every_variant_runs_with_its_keys(ladders, variant):
    rep = ladders[2][variant]
    assert rep["ms"] > 0 and rep["qps"] > 0 and rep["tflops"] > 0
    if variant in ORACLE:
        assert rep["oracle_mismatch"] == 0
    if variant.startswith("binned"):
        assert rep["cert_rate"] == 1.0
    if variant.startswith("binmax"):
        assert rep["gbps"] > 0
    if variant == "binmax":
        assert rep["hbm_stream_gb"] == pytest.approx(8192 * 32 * 4 / 1e9)


def test_approx_is_an_exact_topk_as_jax_computes_it_on_the_cpu():
    """JAX's ``approx_max_k(recall_target=0.99)`` on the CPU gives
    ``lax.top_k``'s ids on 8 x 50,000 float32 scores; so does the port's
    ``approx`` (a stable top-k), which the report marks."""
    scores = np.random.default_rng(0).standard_normal((8, 50000)).astype(np.float32)
    _, ai = jax.lax.approx_max_k(jnp.asarray(scores), 10, recall_target=0.99)
    _, ti = jax.lax.top_k(jnp.asarray(scores), 10)
    _, pi = stable_topk(torch.from_numpy(scores), 10)
    np.testing.assert_array_equal(np.asarray(ai), np.asarray(ti))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ai))


def test_approx_variant_says_it_is_exact(ladders):
    assert ladders[1]["approx"]["approx_is_exact"] is True


def test_data_is_seeded_and_unit_norm():
    q1, e1 = tbench.make_data(512, 16, 4, device="cpu")
    q2, e2 = tbench.make_data(512, 16, 4, device="cpu")
    assert torch.equal(q1, q2) and torch.equal(e1, e2)
    torch.testing.assert_close(e1.norm(dim=1), torch.ones(512))
    qb, eb = tbench.make_data(512, 16, 4, device="cpu", dtype=torch.bfloat16)
    assert eb.dtype == torch.bfloat16 and torch.equal(eb, e1.to(torch.bfloat16))


def test_main_prints_and_writes_the_report(tmp_path, capsys):
    out = tmp_path / "reports" / "ladder.json"
    tbench.main(["--n", "4096", "--b", "8", "--d", "16", "--k", "3", "--reps", "1",
                 "--variants", "flat,binmax,binned", "--device", "cpu", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(out.read_text())
    assert _variants(printed) == {"flat", "binmax", "binned"}
    assert printed["n"] == 4096 and printed["flat"]["oracle_mismatch"] == 0
