"""ahrag_tpu_torch — the PyTorch/CUDA port of ``ahrag_tpu`` for NVIDIA Hopper.

The port mirrors ``ahrag_tpu``'s module layout so that each function has an
obvious counterpart, and is tested against it on the same inputs
(``tests/test_torch_*.py``). It imports torch and numpy only: nothing of JAX
and nothing of ``ahrag_tpu``.

    ahrag_tpu_torch.device               device selection, precision policy, stable top-k
    ahrag_tpu_torch.ops.binmax           the hand-written CUDA bin-max kernels
    ahrag_tpu_torch.ops.topk             certified exact top-k around those kernels
    ahrag_tpu_torch.graph.tensors        GraphTensors and build_graph_tensors
    ahrag_tpu_torch.graph.search         batched hybrid search
    ahrag_tpu_torch.models.encoder.hashed  hashed n-gram query encoder
    ahrag_tpu_torch.serve                fused query encode + search
    ahrag_tpu_torch.bench_data           synthetic bench corpus and CPU reference search
    ahrag_tpu_torch.convert              state carried across from ``ahrag_tpu`` as numpy

Entry points take a ``device`` argument and run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card they raise rather than fall back.
"""

__version__ = "0.1.0"
