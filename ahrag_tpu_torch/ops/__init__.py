# The JAX package's ``ahrag_tpu.ops`` exports under the port's names:
# dense_topk_fused is ``dense_topk_pallas`` and dense_topk_ref is
# ``dense_topk_xla``; spherical_kmeans is the build-time clustering.
from ahrag_tpu_torch.ops.kmeans import spherical_kmeans
from ahrag_tpu_torch.ops.tile_topk import dense_topk_fused
from ahrag_tpu_torch.ops.topk import dense_topk, dense_topk_ref, masked_topk

__all__ = ["dense_topk", "dense_topk_fused", "dense_topk_ref", "masked_topk",
           "spherical_kmeans"]
