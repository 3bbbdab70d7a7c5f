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


# Clusters of 1, 2, 4 and 8 blocks an H100 SXM (NVIDIA H100 80GB HBM3) runs
# at once, one block per SM: its 132 SMs, then ``device_slots``'s reading of
# the occupancy API on that card, which chip_smoke.py logs. Clusters stay
# within a GPC, so 30 of 4 and 15 of 8 fit, not 33 and 16.
SLOTS = (132, 66, 30, 15)
SMS = SLOTS[0]
SMEM_LIMIT = 232448


def _plan(kernel, b, n, d, tile_n, is_bf16):
    fn = tbin.binmax2_plan if kernel == "binmax2" else tbin.binmax_plan
    qc, split, grid = fn(b, n, d, tile_n, is_bf16, SLOTS)
    smem = (tbin.binmax2_smem_bytes(d, is_bf16, qc) if kernel == "binmax2"
            else tbin.ring_smem_bytes(d, qc, is_bf16))
    assert (tile_n // 128) % split == 0 and split in tbin.SPLITS
    assert smem <= SMEM_LIMIT
    items = -(-b // qc) * (n // tile_n)
    assert grid == tbin.ring_grid(-(-b // qc), n // tile_n, split, not is_bf16, SMS)
    return qc, split, items


@pytest.mark.parametrize("kernel, b, n, d, tile_n, is_bf16", [
    ("binmax2", 512, 1067008, 384, 1024, True),      # the 1M bf16 rung
    ("binmax", 4, 1067008, 384, 1024, True),
    ("binmax", 64, 1067008, 384, 1024, True),
    ("binmax2", 1024, 133120, 384, 1024, False),     # the 131k float32 rung
    ("binmax2", 1024, 134144, 384, 1024, False),
    ("binmax", 64, 133120, 384, 1024, False),
    ("binmax", 64, 134144, 384, 1024, False),
    ("binmax", 4, 135168, 384, 1024, False),
    ("binmax", 64, 262144, 384, 2048, True),         # a shard of 1M over 4 ranks
    ("binmax", 64, 262144, 384, 2048, False),
    ("binmax", 256, 1048576, 384, 4096, False),      # topk_bench's binmax
    ("binmax", 256, 1048576, 384, 2048, False),      # and binmax_hi
    ("binmax2", 256, 1048576, 384, 1024, False),     # and its refined stage
])
def test_binmax_plan_keeps_one_block_per_item_where_items_fill_the_card(
        kernel, b, n, d, tile_n, is_bf16):
    """Where two blocks an item would not fit one wave of the SMs (more than
    66 items), the plan keeps split 1 and the chunk of old: the persistent
    grid of one block per SM, as before the split existed."""
    qc, split, _ = _plan(kernel, b, n, d, tile_n, is_bf16)
    assert split == 1
    if kernel == "binmax2":
        assert qc == (tbin.binmax2_chunk(d) if is_bf16 else 128)
    else:
        assert qc == tbin.binmax_chunk(b, d, is_bf16)


@pytest.mark.parametrize("kernel, b", [("binmax", 1), ("binmax", 4), ("binmax", 64),
                                       ("binmax", 256), ("binmax2", 128), ("binmax2", 256)])
@pytest.mark.parametrize("n", [5120, 6144])
@pytest.mark.parametrize("d", [384, 768])
@pytest.mark.parametrize("is_bf16", [True, False])
def test_binmax_plan_splits_the_items_of_small_graphs(kernel, b, n, d, is_bf16):
    """On the answer path's and the learned graph's 5-6 tiles the plan splits
    every item among 2-8 blocks: up to the cap of 8 (tile_n 1024's slices),
    or as far as one wave of the SMs holds the blocks."""
    qc, split, items = _plan(kernel, b, n, d, 1024, is_bf16)
    assert split > 1 and items <= SLOTS[tbin.SPLITS.index(split)]
    assert split == 8 or items > SLOTS[tbin.SPLITS.index(2 * split)]


@pytest.mark.parametrize("b, n, d, plan", [
    (128, 5120, 768, (64, 8, 80)), (128, 6144, 384, (64, 8, 96)),
    (128, 1024, 384, (64, 8, 16)), (256, 5120, 768, (96, 8, 120)),
    (512, 5120, 384, (96, 4, 120)), (256, 6144, 384, (128, 8, 96)),
    (384, 5120, 384, (128, 8, 120)), (128, 16384, 384, (128, 4, 64)),
    (1024, 134144, 384, (128, 1, 132)), (256, 1048576, 384, (128, 1, 132))])
def test_binmax2_plan_narrows_the_float32_chunk_only_where_it_spreads_the_work(b, n, d, plan):
    """float32 ``dense_binmax2`` takes 96 or 64 queries a block only in a
    split where that gives each block less work by count (slices times
    queries), ties to the wider chunk: at B 256 over 5 tiles 120 blocks of
    96 queries instead of 80 of 128, at B 128 over 1-8 tiles 80 of 64
    instead of 40. Over 6 tiles B 256's 18 items of 96 would need a second
    wave, so 128 stays, as it does everywhere split 1 holds."""
    assert tbin.binmax2_plan(b, n, d, 1024, False, SLOTS) == plan


@pytest.mark.parametrize("items, slices, split", [
    (1, 8, 8), (5, 8, 8), (15, 8, 8), (16, 8, 4), (30, 8, 4), (31, 8, 2), (66, 8, 2),
    (67, 8, 1), (100, 8, 1), (131, 8, 1), (132, 8, 1), (1042, 8, 1), (5, 2, 2), (5, 1, 1),
    (5, 16, 8), (5, 32, 8), (128, 16, 1), (20, 4, 4), (40, 4, 2)])
def test_split_for_fills_one_wave(items, slices, split):
    """``split_for``: the largest split dividing the slices whose items x S
    blocks fit in one wave (at most the clusters of S the card runs at once);
    1 once even a split of 2 would need a second wave."""
    assert tbin.split_for(items, slices, SLOTS) == split


@pytest.mark.parametrize("items, slots, split", [
    (15, (132, 66, 33, 16), 8), (15, (132, 66, 32, 14), 4), (14, (132, 66, 32, 14), 8),
    (33, (132, 66, 32, 14), 2), (5, (132, 66, 32, 4), 4), (67, (132, 66, 32, 14), 1)])
def test_split_for_takes_the_wave_from_the_cards_cluster_slots(items, slots, split):
    """Where clusters cannot fill every SM (GPCs of unequal size), the wave
    is the card's count of clusters of S, not SMs / S: 15 items of 8 blocks
    on a card that runs 14 clusters of 8 take clusters of 4."""
    assert tbin.split_for(items, 8, slots) == split


@pytest.mark.parametrize("chunks, tiles, split, stream_q, grid", [
    (1, 1042, 1, False, 132), (4, 1042, 1, False, 132), (5, 1042, 1, False, 130),
    (1, 5, 1, False, 5), (200, 3, 1, False, 200), (8, 130, 1, True, 132), (1, 5, 1, True, 5),
    (1, 5, 8, True, 40), (3, 5, 8, False, 120), (2, 6, 4, True, 48)])
def test_ring_grid_is_the_persistent_grid_or_a_cluster_an_item(chunks, tiles, split,
                                                               stream_q, grid):
    """``ring_grid``, the blocks a ring kernel launches: at split 1 one per
    SM and at most one per item, with resident queries (bf16) a multiple of
    the chunks and at least one a chunk; with a split, split blocks an item."""
    assert tbin.ring_grid(chunks, tiles, split, stream_q, SMS) == grid
    if split == 1 and not stream_q:
        assert grid % chunks == 0


@pytest.mark.parametrize("kernel", ["binmax", "binmax2"])
@pytest.mark.parametrize("b", [1, 128])
def test_binmax_ref_matches_pallas_at_the_learned_graph_layout(kernel, b):
    """The plain versions the card's kernels are held against stay JAX's at
    the learned graph's layout: 5 tiles of 1,024 rows, D 768 float32, tile 2
    fully masked and n_valid short of N (interpret mode; ``dense_binmax2`` at
    B 128 only, its kernel's rule)."""
    if kernel == "binmax2" and b == 1:
        b = 256
    n, d, tile_n = 5120, 768, 1024
    jq, tq, je, te, jm, tm = _inputs(n, d, b, 11, "float32")
    jm = jm.at[2 * tile_n:3 * tile_n].set(False)
    tm[2 * tile_n:3 * tile_n] = False
    n_valid = n - 300
    if kernel == "binmax":
        jout = jtopk.dense_binmax_pallas(jq, je, jnp.int32(n_valid), jm, tile_n=tile_n,
                                         interpret=True)
        tout = tbin.dense_binmax(tq, te, n_valid, tm, tile_n=tile_n)
        assert tout.shape == jout.shape == (b, 5 * 128)
        assert bool((tout[:, 256:384] == tbin.NEG_INF).all())
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
        return
    jb, js = jtopk.dense_binmax2_pallas(jq, je, jnp.int32(n_valid), jm, tile_n=tile_n,
                                        interpret=True)
    tb, ts = tbin.dense_binmax2(tq, te, n_valid, tm, tile_n=tile_n)
    assert tb.shape == jb.shape == (5, b, 128) and ts.shape == js.shape == (b, 5)
    assert bool((tb[2] == tbin.NEG_INF).all() and (ts[:, 2] == tbin.NEG_INF).all())
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
