"""ahrag_tpu_torch — the PyTorch/CUDA port of ``ahrag_tpu`` for NVIDIA Hopper.

The port mirrors ``ahrag_tpu``'s module layout so that each function has an
obvious counterpart, and is tested against it on the same inputs
(``tests/test_torch_*.py``). It imports torch and numpy only: nothing of JAX
and nothing of ``ahrag_tpu``.

    ahrag_tpu_torch.device               device selection, precision policy, stable top-k
    ahrag_tpu_torch.schema               the pipeline's data contracts (plain dataclasses)
    ahrag_tpu_torch.ops.binmax           the hand-written CUDA bin-max kernels
    ahrag_tpu_torch.ops.kmeans           spherical k-means (the build-time clustering)
    ahrag_tpu_torch.ops.topk             certified exact top-k around those kernels
    ahrag_tpu_torch.graph.tensors        GraphTensors and build_graph_tensors
    ahrag_tpu_torch.graph.search         batched hybrid search
    ahrag_tpu_torch.graph.host           HierarchicalGraph: build, save/load, index, search
    ahrag_tpu_torch.graph.beam           multi-level beam-search traversal
    ahrag_tpu_torch.graph.multi          stacked graphs: many-graph search and rollouts
    ahrag_tpu_torch.agent                featurizer, rewards, the batched traversal
                                         environment (vec_env), PPO, BC, RLPolicyAgent,
                                         per-question fleets;
                                         GraphEnvironment, the rule/LLM agent and
                                         InferenceEngine (question answering)
    ahrag_tpu_torch.answer               fact layer (qa), extractive spans, the
                                         token-budgeted context, AnswerGenerator
    ahrag_tpu_torch.baselines            NaiveRAG, the flat baseline
    ahrag_tpu_torch.extract              chunking and hypergraph extraction
    ahrag_tpu_torch.aggregate            SemanticAggregator: topics, summaries, relations,
                                         communities
    ahrag_tpu_torch.eval                 SQuAD F1/EM, the rule judges, AnswerEvaluator,
                                         recall@k
    ahrag_tpu_torch.models.policy.nets   the policy networks (MLPPolicy, ActorCritic)
    ahrag_tpu_torch.models.encoder.hashed  hashed n-gram query encoder
    ahrag_tpu_torch.serve                fused query encode + search, MicroBatcher,
                                         RetrievalService (search, beam, answer),
                                         serve_http
    ahrag_tpu_torch.utils                config loader, parse guards, timers and
                                         profiler traces, session logger, token
                                         counts, the LLM client manager
    ahrag_tpu_torch.cli                  serve (HTTP), serve_bench (load test),
                                         env, agent, answer, demo (the build
                                         pipeline), benchmark and eval_gate
    ahrag_tpu_torch.bench_data           synthetic bench corpus and CPU reference search
    ahrag_tpu_torch.convert              state carried across from ``ahrag_tpu`` as numpy
                                         (graph tensors, weights, flax policy params)

Entry points take a ``device`` argument and run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card they raise rather than fall back.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports, as ``ahrag_tpu`` has them."""
    if name == "HierarchicalGraph":
        from ahrag_tpu_torch.graph import HierarchicalGraph
        return HierarchicalGraph
    if name == "RetrievalService":
        from ahrag_tpu_torch.serve import RetrievalService
        return RetrievalService
    raise AttributeError(name)
