# The JAX package's ``ahrag_tpu.ops`` exports under the port's names:
# dense_topk_fused is ``dense_topk_pallas`` and dense_topk_ref is
# ``dense_topk_xla``. ``spherical_kmeans`` comes with the build-time
# clustering (ROADMAP item 10).
from ahrag_tpu_torch.ops.tile_topk import dense_topk_fused
from ahrag_tpu_torch.ops.topk import dense_topk, dense_topk_ref, masked_topk

__all__ = ["dense_topk", "dense_topk_fused", "dense_topk_ref", "masked_topk"]
