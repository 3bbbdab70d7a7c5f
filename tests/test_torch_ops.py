"""The port's ops against the JAX package on the same inputs.

The bin-max kernels' plain versions are held against the Pallas kernels run in
interpret mode, and the certified top-k paths against their JAX counterparts.
Inputs are seeded numpy arrays handed to both packages; bf16 inputs are
rounded once (to nearest even) by each framework, which gives the same bits.

Tolerances: bins and values 1e-6 (float32 accumulation of the same products
in another order, on unit vectors); ids and certificates exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ahrag_tpu.ops import topk as jtopk
from ahrag_tpu_torch.device import stable_topk
from ahrag_tpu_torch.ops import binmax as tbin
from ahrag_tpu_torch.ops import topk as ttopk

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _inputs(n, d, b, seed, dtype, masked=True):
    rng = np.random.default_rng(seed)
    q, e = _unit(rng, b, d), _unit(rng, n, d)
    mask = rng.random(n) > 0.2 if masked else np.ones(n, bool)
    jq, tq = _both(q, dtype)
    je, te = _both(e, dtype)
    return jq, tq, je, te, jnp.asarray(mask), torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trivial", [False, True])
@pytest.mark.parametrize("tile_n", [256, 1024])
def test_binmax2_ref_matches_pallas(dtype, trivial, tile_n):
    jq, tq, je, te, jm, tm = _inputs(2048, 64, 128, 1, dtype)
    n_valid = 2048 - 77
    jb, js = jtopk.dense_binmax2_pallas(jq, je, jnp.int32(n_valid), jm,
                                        tile_n=tile_n, interpret=True,
                                        trivial=trivial)
    tb, ts = tbin.dense_binmax2(tq, te, n_valid, tm, tile_n=tile_n, trivial=trivial)
    assert tb.shape == jb.shape and ts.shape == js.shape
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4, 5, 16, 64, 100, 128, 200])
@pytest.mark.parametrize("tile_n", [1024, 2048, 4096])
def test_binmax_ref_matches_pallas(dtype, b, tile_n):
    jq, tq, je, te, jm, tm = _inputs(8192, 64, b, 2, dtype)
    n_valid = 8192 - 130
    jout = jtopk.dense_binmax_pallas(jq, je, jnp.int32(n_valid), jm, tile_n=tile_n,
                                     interpret=True)
    tout = tbin.dense_binmax(tq, te, n_valid, tm, tile_n=tile_n)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binmax_default_tile_matches_pallas(dtype):
    """Called without tile_n, both packages tile by 4096 rows: the same
    [B, N / 32] bins."""
    jq, tq, je, te, jm, tm = _inputs(8192, 64, 5, 8, dtype)
    jout = jtopk.dense_binmax_pallas(jq, je, jnp.int32(8000), jm, interpret=True)
    tout = tbin.dense_binmax(tq, te, 8000, tm)
    assert tout.shape == jout.shape == (5, 8192 // 32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
    assert tbin.dense_binmax_ref(tq, te, 8000, tm).shape == (5, 8192 // 32)


def test_binmax_wrappers_reject_bad_input():
    q, e = torch.zeros(4, 64), torch.zeros(2048, 64)
    with pytest.raises(ValueError):
        tbin.dense_binmax(q, e, 2048, torch.ones(2048), tile_n=1024)   # mask not bool
    with pytest.raises(ValueError):
        tbin.dense_binmax(q, e[:2000], 2000, torch.ones(2000, dtype=torch.bool))
    with pytest.raises(TypeError):
        tbin.dense_binmax(q.double(), e.double(), 2048,
                          torch.ones(2048, dtype=torch.bool), tile_n=1024)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [128, 5, 64])
@pytest.mark.parametrize("binpack", [False, True])
def test_binned_hier_matches_jax(dtype, b, binpack):
    """hier-v2 (B % 128 == 0) and hier-v1 (B 5, and 64, the largest serving
    bucket below 128), with and without the bin-packed candidate copy,
    through the plain versions."""
    n, d = 4096, 64
    jq, tq, je, te, jm, tm = _inputs(n, d, b, 3, dtype)
    jpack = tpack = None
    if binpack:
        jpack = je.reshape(n // 1024, 8, 128, d).transpose(0, 2, 1, 3).reshape(-1, 8, d)
        tpack = te.reshape(n // 1024, 8, 128, d).transpose(1, 2).reshape(-1, 8, d)
    jv, ji, jc = jtopk.binned_refined_topk(jq, je, jm, 5, margin=8, tile_n=1024,
                                           interpret=True, select="hier",
                                           emb_binpack=jpack)
    tv, ti, tc = ttopk.binned_refined_topk(tq, te, tm, 5, margin=8, tile_n=1024,
                                           select="hier", emb_binpack=tpack)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("select", ["exact", "approx"])
def test_binned_flat_select_matches_jax_exact(select):
    """"approx" maps to exact selection in the port; ids equal JAX's exact."""
    jq, tq, je, te, jm, tm = _inputs(4096, 64, 16, 4, "float32")
    jv, ji, jc = jtopk.binned_refined_topk(jq, je, jm, 5, margin=8, tile_n=1024,
                                           interpret=True, select="exact")
    tv, ti, tc = ttopk.binned_refined_topk(tq, te, tm, 5, margin=8, tile_n=1024,
                                           select=select)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flush", [0.0, 1e-5])
def test_refined_masked_topk_flat_matches_jax(dtype, flush):
    jq, tq, je, te, jm, tm = _inputs(3000, 64, 7, 5, dtype)
    jv, ji = jtopk.refined_masked_topk(jq, je, jm, 5, margin=12, flush_eps=flush)
    tv, ti = ttopk.refined_masked_topk(tq, te, tm, 5, margin=12, flush_eps=flush)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    _, _, jc = jtopk.refined_masked_topk_cert(jq, je, jm, 5, margin=12)
    _, _, tc = ttopk.refined_masked_topk_cert(tq, te, tm, 5, margin=12)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_refined_masked_topk_exact_ties_pick_lowest_index():
    """Rows 5 and 40..59 are identical; a query equal to them ties 21 rows at
    the top, and both packages must return the lowest indices in order."""
    rng = np.random.default_rng(6)
    e = _unit(rng, 400, 32)
    e[40:60] = e[5]
    q = e[5:6].copy()
    mask = np.ones(400, bool)
    mask[41] = False
    jv, ji = jtopk.refined_masked_topk(jnp.asarray(q), jnp.asarray(e),
                                       jnp.asarray(mask), 5, margin=4)
    tv, ti = ttopk.refined_masked_topk(torch.from_numpy(q), torch.from_numpy(e),
                                       torch.from_numpy(mask), 5, margin=4)
    np.testing.assert_array_equal(ti.numpy()[0], [5, 40, 42, 43, 44])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    # the ties leave no gap over the coarse bound: the certificate fails and
    # the result above came from the full float32 fallback
    _, _, tc = ttopk.refined_masked_topk_cert(
        torch.from_numpy(q), torch.from_numpy(e), torch.from_numpy(mask), 5, margin=4)
    assert not bool(tc.any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stable_topk_matches_lax_top_k_on_ties(seed):
    import jax
    x = np.random.default_rng(seed).integers(0, 6, size=(4, 300)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 17)
    tv, ti = stable_topk(torch.from_numpy(x), 17)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dense_topk_ref_matches_xla():
    jq, tq, je, te, _, _ = _inputs(1000, 64, 3, 7, "float32")
    jv, ji = jtopk.dense_topk_xla(jq, je, jnp.int32(900), 10)
    tv, ti = ttopk.dense_topk_ref(tq, te, 900, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bf16_in", [False, True])
def test_eps_calibrations_are_small_and_positive(bf16_in):
    """On the CPU both bands are float32 accumulation noise: far under the
    1e-5 flush threshold and above the 1e-7 floor."""
    e1 = ttopk.matmul_eps("cpu", 64, bf16_in)
    e2 = ttopk.binmax_eps("cpu", 64, 1024, bf16_in)
    for e in (e1, e2):
        assert 1e-7 <= e < 1e-5



def test_binmax_eps_reads_the_binmax2_kernel(monkeypatch):
    """The band is calibrated through ``dense_binmax2`` (the certified path's
    coarse kernel) as well as ``dense_binmax``: an error of 1e-4 in
    ``dense_binmax2``'s bins alone carries the band past it, where
    ``dense_binmax``'s reading would stay under 1e-5."""
    offset = 1e-4
    real = ttopk.dense_binmax2

    def off_by(*args, **kwargs):
        bins, smax = real(*args, **kwargs)
        return bins + offset, smax + offset

    ttopk.binmax_eps.cache_clear()
    try:
        clean = ttopk.binmax_eps("cpu", 64, 1024, False)
        monkeypatch.setattr(ttopk, "dense_binmax2", off_by)
        ttopk.binmax_eps.cache_clear()
        shifted = ttopk.binmax_eps("cpu", 64, 1024, False)
    finally:
        ttopk.binmax_eps.cache_clear()
    assert clean < 1e-5
    assert shifted >= 8 * offset > clean


def test_binmax2_kernel_shape_rules_raise_before_launch():
    """The kernel's own rules (B % 128, the bf16 query chunk within shared
    memory: 128 queries up to D = 576, then 32 up to D = 2560) raise
    ValueError on any non-CPU tensor before the library is touched; any
    D % 8 == 0 within them reaches the device check."""
    mask = torch.ones(2048, dtype=torch.bool, device="meta")

    def call(b, d, dtype):
        q = torch.zeros(b, d, dtype=dtype, device="meta")
        e = torch.zeros(2048, d, dtype=dtype, device="meta")
        tbin.dense_binmax2(q, e, 2048, mask, tile_n=1024)

    with pytest.raises(ValueError, match="B % 128"):
        call(64, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        call(128, 2568, torch.bfloat16)
    assert (tbin.binmax2_chunk(576), tbin.binmax2_chunk(584)) == (128, 32)
    assert tbin.binmax2_smem_bytes(2560, True) <= 232448
    for d, dtype in ((384, torch.bfloat16), (96, torch.bfloat16), (200, torch.bfloat16),
                     (768, torch.bfloat16), (96, torch.float32), (200, torch.float32)):
        with pytest.raises(ValueError, match="no CUDA kernel for device meta"):
            call(128, d, dtype)      # every shape rule holds: the device check


def test_binmax_kernel_shape_rules_raise_before_launch():
    """``dense_binmax``'s kernel rules (D % 8, the bf16 query chunk within
    shared memory) raise ValueError on any non-CPU tensor before the library
    is touched; any B and any D % 8 == 0 within them reach the device check,
    and an empty batch returns its empty bins without a launch."""
    mask = torch.ones(8192, dtype=torch.bool, device="meta")

    def call(b, d, dtype, tile_n=4096):
        q = torch.zeros(b, d, dtype=dtype, device="meta")
        e = torch.zeros(8192, d, dtype=dtype, device="meta")
        return tbin.dense_binmax(q, e, 8192, mask, tile_n=tile_n)

    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="D % 8"):
            call(4, 100, dtype)
    with pytest.raises(ValueError, match="shared memory"):
        call(1, 10368, torch.bfloat16)         # 8 resident queries past the limit
    assert tbin.ring_smem_bytes(10304, 8, True) <= 232448
    assert call(0, 384, torch.bfloat16).shape == (0, 256)
    for b, d, dtype, tile_n in ((1, 384, torch.bfloat16, 1024), (4, 10304, torch.bfloat16, 4096),
                                (200, 768, torch.bfloat16, 2048), (64, 8, torch.float32, 4096),
                                (5, 6336, torch.float32, 1024), (200, 200, torch.float32, 4096)):
        with pytest.raises(ValueError, match="no CUDA kernel for device meta"):
            call(b, d, dtype, tile_n)       # every shape rule holds: the device check


@pytest.mark.parametrize("b, d, is_bf16, chunk", [
    (1, 384, True, 8), (4, 384, True, 8), (8, 384, True, 8), (9, 384, True, 16),
    (16, 384, True, 16), (17, 384, True, 32), (64, 384, True, 64), (65, 384, True, 128),
    (100, 384, True, 128), (200, 384, True, 128), (128, 640, True, 128), (128, 648, True, 64),
    (200, 768, True, 64), (200, 1288, True, 32), (64, 2568, True, 16), (4, 10304, True, 8),
    (1, 384, False, 8), (16, 384, False, 16), (20, 384, False, 32), (64, 384, False, 64),
    (200, 384, False, 64), (200, 6336, False, 64)])
def test_binmax_chunk_follows_batch_and_shared_memory(b, d, is_bf16, chunk):
    """The smallest chunk that holds the batch (bf16 up to 128, the wgmma N;
    float32 up to 64), halved in bf16 while the resident chunk does not fit,
    and the block's bytes within the opt-in limit either way."""
    assert tbin.binmax_chunk(b, d, is_bf16) == chunk
    assert tbin.ring_smem_bytes(d, chunk, is_bf16) <= 232448
