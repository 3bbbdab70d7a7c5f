"""Flat exact top-k: the port's fused per-tile top-k and ``dense_topk`` against
the JAX package on the same inputs.

On the CPU ``dense_topk_fused`` takes its plain version; it is held against
``dense_topk_pallas`` run in interpret mode at the shapes of
``tests/test_topk.py``. Inputs are seeded numpy arrays handed to both
packages; bf16 inputs are rounded once (to nearest even) by each framework,
which gives the same bits.

Tolerances: values 1e-6 on unit vectors and 1e-5 relative on unnormalised
ones (float32 accumulation of the same products in another order); ids
exactly, including the ids of the ``NEG_INF`` slots past the eligible rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ahrag_tpu.ops import topk as jtopk
from ahrag_tpu_torch import ops as tops
from ahrag_tpu_torch.ops import tile_topk as ttile

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _check(tv, ti, jv, ji, atol=1e-6):
    assert ti.dtype == torch.int64 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,tile", [(2048, 512), (1024, 1024), (4096, 1024)])
def test_fused_matches_pallas_interpret(n, tile, dtype):
    rng = np.random.default_rng(1)
    jq, tq = _both(_unit(rng, 2, 128), dtype)
    je, te = _both(_unit(rng, n, 128), dtype)
    n_valid = n - 37
    jv, ji = jtopk.dense_topk_pallas(jq, je, jnp.int32(n_valid), 8, tile_n=tile,
                                     interpret=True)
    tv, ti = tops.dense_topk_fused(tq, te, n_valid, 8, tile_n=tile)
    _check(tv, ti, jv, ji)


def test_fused_masked_matches_pallas_masked():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 128)).astype(np.float32)
    e = rng.normal(size=(2048, 128)).astype(np.float32)
    mask = rng.random(2048) > 0.3
    jv, ji = jtopk.dense_topk_pallas(jnp.asarray(q), jnp.asarray(e), jnp.int32(2048),
                                     7, tile_n=512, interpret=True,
                                     mask=jnp.asarray(mask))
    tv, ti = tops.dense_topk_fused(torch.from_numpy(q), torch.from_numpy(e), 2048, 7,
                                   tile_n=512, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)


def test_fused_tie_break_lowest_index():
    e = np.zeros((1024, 128), dtype=np.float32)
    e[:, 0] = 1.0   # all rows identical
    q = np.zeros((1, 128), dtype=np.float32)
    q[0, 0] = 1.0
    _, ji = jtopk.dense_topk_pallas(jnp.asarray(q), jnp.asarray(e), jnp.int32(1024), 5,
                                    tile_n=256, interpret=True)
    _, ti = tops.dense_topk_fused(torch.from_numpy(q), torch.from_numpy(e), 1024, 5,
                                  tile_n=256)
    np.testing.assert_array_equal(np.asarray(ji)[0], np.arange(5))
    np.testing.assert_array_equal(ti.numpy()[0], np.arange(5))


def _sparse_mask_case(dtype):
    """Few eligible rows: tile 0 keeps 3 of its rows, tile 1 is fully masked,
    tile 2 keeps rows up to n_valid."""
    rng = np.random.default_rng(7)
    n, tile = 3 * 256, 256
    mask = np.zeros(n, bool)
    mask[[5, 17, 200]] = True
    mask[512:] = rng.random(256) > 0.9
    n_valid = 512 + 180
    jq, tq = _both(_unit(rng, 3, 64), dtype)
    je, te = _both(_unit(rng, n, 64), dtype)
    return n, tile, n_valid, mask, jq, tq, je, te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [12, 300])
def test_tiles_past_the_eligible_rows_match_pallas(dtype, k):
    """Every slot of every tile, NEG_INF slots included, against the TPU kernel
    run on that tile alone (one tile: its merge returns the tile's slots)."""
    n, tile, n_valid, mask, jq, tq, je, te = _sparse_mask_case(dtype)
    tv, ti = ttile.tile_topk(tq, te, n_valid, k, tile_n=tile,
                             mask=torch.from_numpy(mask))
    kk = min(k, tile)
    assert tv.shape == ti.shape == (n // tile, 3, kk) and ti.dtype == torch.int32
    for t in range(n // tile):
        rows = slice(t * tile, (t + 1) * tile)
        jv, ji = jtopk.dense_topk_pallas(
            jq, je[rows], jnp.int32(n_valid - t * tile), kk, tile_n=tile,
            interpret=True, mask=jnp.asarray(mask[rows]))
        np.testing.assert_array_equal(ti[t].numpy(), np.asarray(ji) + t * tile)
        np.testing.assert_allclose(tv[t].numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    # the fully masked tile: kk copies of (NEG_INF, its first row)
    assert (tv[1] == ttile.NEG_INF).all() and (ti[1] == tile).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [12, 300])
def test_merged_past_the_eligible_rows_matches_pallas(dtype, k):
    n, tile, n_valid, mask, jq, tq, je, te = _sparse_mask_case(dtype)
    jv, ji = jtopk.dense_topk_pallas(jq, je, jnp.int32(n_valid), k, tile_n=tile,
                                     interpret=True, mask=jnp.asarray(mask))
    tv, ti = tops.dense_topk_fused(tq, te, n_valid, k, tile_n=tile,
                                   mask=torch.from_numpy(mask))
    _check(tv, ti, jv, ji)
    n_elig = int((mask & (np.arange(n) < n_valid)).sum())
    assert (tv[:, :min(k, n_elig)] > ttile.NEG_INF).all()
    assert (tv[:, n_elig:] == ttile.NEG_INF).all()


def test_plain_version_is_not_a_sort():
    """Past the eligible rows the passes repeat column 0; a sort would list the
    unused rows instead."""
    e = torch.eye(8, 128)[torch.arange(256) % 8]
    q = torch.ones(1, 128)
    vals, idx = ttile.dense_topk_fused_ref(q, e, 3, 5, tile_n=128)
    assert idx.tolist() == [[[0, 1, 2, 0, 0]], [[128, 128, 128, 128, 128]]]
    assert vals[0, 0, :3].tolist() == [1.0, 1.0, 1.0]


def test_merge_pads_past_the_candidates():
    tv = torch.tensor([[[3.0, 1.0]], [[2.0, ttile.NEG_INF]]])
    ti = torch.tensor([[[4, 9]], [[130, 128]]], dtype=torch.int32)
    vals, idx = ttile.merge_tiles(tv, ti, 6)
    assert idx.tolist() == [[4, 130, 9, 128, 0, 0]]
    neg = float(np.float32(ttile.NEG_INF))
    assert vals.tolist() == [[3.0, 2.0, 1.0, neg, neg, neg]]


@pytest.mark.parametrize("n,n_valid,k", [(256, 200, 10), (1024, 1024, 5),
                                         (3072, 3000, 7), (1000, 990, 4),
                                         (1024, 3, 6)])
def test_dense_topk_matches_jax(n, n_valid, k):
    """The entry point on the CPU against JAX ``dense_topk`` (the XLA path on
    the CPU), ``dense_topk_xla`` and, where the kernel takes the shape,
    ``dense_topk_pallas``."""
    rng = np.random.default_rng(n)
    q, e = _unit(rng, 3, 64), _unit(rng, n, 64)
    tq, te = torch.from_numpy(q), torch.from_numpy(e)
    jv, ji = jtopk.dense_topk(jnp.asarray(q), jnp.asarray(e), n_valid, k)
    xv, xi = jtopk.dense_topk_xla(jnp.asarray(q), jnp.asarray(e), jnp.int32(n_valid), k)
    _check(*tops.dense_topk(tq, te, n_valid, k), jv, ji)
    _check(*tops.dense_topk_ref(tq, te, n_valid, k), xv, xi)
    if n % 1024 == 0:   # the shapes the kernel takes on the card
        pv, pi = jtopk.dense_topk_pallas(jnp.asarray(q), jnp.asarray(e),
                                         jnp.int32(n_valid), k, interpret=True)
        _check(*tops.dense_topk_fused(tq, te, n_valid, k), pv, pi)


def test_masked_topk_matches_jax():
    scores = np.asarray([[1.0, 5.0, 3.0, 4.0], [2.0, 2.0, 2.0, 0.0]], np.float32)
    mask = np.asarray([[True, False, True, True], [True, True, False, True]])
    jv, ji = jtopk.masked_topk(jnp.asarray(scores), jnp.asarray(mask), 3)
    tv, ti = tops.masked_topk(torch.from_numpy(scores), torch.from_numpy(mask), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_wrapper_checks_and_counts_no_cpu_launch():
    q, e = torch.zeros(2, 64), torch.zeros(1024, 64)
    before = ttile.tile_topk.launches
    tops.dense_topk_fused(q, e, 1024, 3)
    assert ttile.tile_topk.launches == before   # the CPU takes the plain version
    with pytest.raises(TypeError):
        tops.dense_topk_fused(q.to(torch.bfloat16), e, 1024, 3)
    with pytest.raises(ValueError):
        tops.dense_topk_fused(q, e[:1000], 1000, 3)
    with pytest.raises(ValueError):
        tops.dense_topk_fused(q, e, 1024, 3, mask=torch.ones(1024))
    with pytest.raises(ValueError, match="no CUDA kernel for device meta"):
        tops.dense_topk_fused(q.to("meta"), e.to("meta"), 1024, 3)


@pytest.mark.parametrize("dtype,d,tile_n,match", [
    (torch.bfloat16, 3080, 1024, "shared memory"),
    (torch.float32, 384, 2688, "shared memory"),
    (torch.bfloat16, 384, 1024, "no CUDA kernel for device meta"),
    (torch.bfloat16, 200, 1024, "no CUDA kernel for device meta"),
    (torch.bfloat16, 768, 1024, "no CUDA kernel for device meta"),
    (torch.bfloat16, 384, 2048, "no CUDA kernel for device meta"),
    (torch.float32, 200, 2048, "no CUDA kernel for device meta"),
])
def test_kernel_shape_rules_raise_before_launch(dtype, d, tile_n, match):
    """The kernel's shared-memory rule raises ValueError on any non-CPU tensor
    before the library is touched; shapes that meet it (any D % 8 == 0, the
    16-query chunk where 32 queries do not fit) reach the device check."""
    q = torch.zeros(4, d, dtype=dtype, device="meta")
    e = torch.zeros(2 * tile_n, d, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        ttile.tile_topk(q, e, 2 * tile_n, 5, tile_n)


@pytest.mark.parametrize("d,tile_n,is_bf16,chunk", [
    (384, 1024, True, 32), (384, 1024, False, 32), (512, 1024, True, 32),
    (520, 1024, True, 16), (384, 1152, False, 32), (384, 1280, False, 16),
])
def test_tile_topk_chunk_follows_shared_memory(d, tile_n, is_bf16, chunk):
    """32 queries a block where their shared memory fits, else 16, and the
    block's bytes within the opt-in limit either way."""
    assert ttile.tile_topk_chunk(d, tile_n, is_bf16) == chunk
    assert ttile.tile_topk_smem_bytes(d, tile_n, is_bf16) <= 232448
