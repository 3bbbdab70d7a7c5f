"""Entry points: the flagship forward step and the multi-device dry run.

Port of the repo's ``__graft_entry__.py``. ``entry()`` returns the flagship
forward step, MiniLM's encode (``max_len`` 64) fused with the exact dense
top-k (``dense_topk_ref``, the counterpart of ``dense_topk_xla``) over a
2,048-row corpus, with its arguments on the card (or on ``device``).

``dryrun_multichip(n)`` starts ``n`` ranks through
``parallel.distributed.spawn`` (the JAX package forced an n-device virtual
mesh in one process instead) over a 131,072-entity bench graph
(``bench_data``, 133,376 nodes, float32) and runs its four checks on every
rank: sharded dense and refined top-k ids equal to the flat exact ranking;
sharded hybrid search equal to the flat search (ids equal, scores within
1e-6); the ``{slice 2, corpus n/2}`` top-k equal to the flat ranking; one
sharded PPO step with finite metrics. Each rank builds the graph on the CPU
and keeps only its rows of the embeddings on its device; the flat references
run on the CPU. It prints one ``dryrun_multichip ok: ...`` line.

    python -m ahrag_tpu_torch.entry [--device cuda|cpu] [--dryrun N]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device

QUERIES = ["Who directed the film Ed Wood?", "American film directors of the 1990s"]
N_ENTITIES = 131072


def _forward(model, ids: torch.Tensor, mask: torch.Tensor, corpus_emb: torch.Tensor):
    from ahrag_tpu_torch.ops.topk import dense_topk_ref
    with torch.no_grad():
        q = model(ids, mask)
        return dense_topk_ref(q, corpus_emb, corpus_emb.shape[0], 10)


def entry(device: Optional[str] = None):
    """(fn, example_args): ``fn(*example_args)`` encodes two queries with a
    seeded MiniLM and returns their exact top-10 over a seeded unit corpus
    of 2,048 rows, as ([2, 10] scores, [2, 10] ids)."""
    from ahrag_tpu_torch.models.encoder.minilm import MiniLMConfig, MiniLMEncoder
    dev = resolve_device(device)
    enc = MiniLMEncoder(MiniLMConfig(max_len=64), seed=0, device=dev)
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(2048, enc.dim)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    ids, attn = enc._tokenize(QUERIES)
    return _forward, (enc.model, torch.from_numpy(ids).to(dev),
                      torch.from_numpy(attn).to(dev), torch.from_numpy(corpus).to(dev))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(device: str) -> Dict[str, Any]:
    """One rank of ``dryrun_multichip``: the four checks; returns the mesh
    shapes, the node count, the PPO metrics and the kernels' launches."""
    import torch.distributed as dist

    from ahrag_tpu_torch.agent.featurizer import OBS_DIM
    from ahrag_tpu_torch.agent.ppo import PPOConfig, PPOLearner, make_sharded_train_step
    from ahrag_tpu_torch.bench_data import bench_tensors, build_bench_arrays
    from ahrag_tpu_torch.graph.search import SearchWeights, hybrid_search_batch
    from ahrag_tpu_torch.ops.topk import dense_topk_ref
    from ahrag_tpu_torch.parallel.distributed import rank_device
    from ahrag_tpu_torch.parallel.mesh import (CORPUS_AXIS, DATA_AXIS, SLICE_AXIS,
                                               local_rows, make_mesh)
    from ahrag_tpu_torch.parallel.programs import launches
    from ahrag_tpu_torch.parallel.sharded import (shard_graph_tensors, shard_queries,
                                                  sharded_dense_topk, sharded_refined_topk,
                                                  sharded_topk_2level)

    dev = rank_device(device)
    n = dist.get_world_size()
    dp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(dp=dp)
    # >= 131k nodes: every shard holds tens of thousands of rows (the
    # binned local stage on the card once a shard reaches 65,536)
    gt_host = bench_tensors(build_bench_arrays(N_ENTITIES, N_ENTITIES // 64),
                            "float32", device="cpu")
    gt = shard_graph_tensors(gt_host, mesh, dev)
    rng = np.random.default_rng(0)
    q_host = rng.standard_normal((8, gt_host.dim)).astype(np.float32)
    q_host /= np.linalg.norm(q_host, axis=1, keepdims=True)
    q_cpu = torch.from_numpy(q_host)
    q = q_cpu.to(dev)
    n_nodes = gt_host.n_nodes

    # 1) sharded top-k, exact and certified, against the flat exact ranking
    _, ref_idx = dense_topk_ref(q_cpu, gt_host.emb, n_nodes, 5)
    _, idx = sharded_dense_topk(q, gt.emb, n_nodes, 5, mesh)
    _, ridx = sharded_refined_topk(q, gt.emb, n_nodes, 5, mesh)
    for name, got in (("dense", idx), ("refined", ridx)):
        _check(torch.equal(got.cpu(), ref_idx),
               f"sharded {name} top-k diverged from the flat exact ranking:\n"
               f"{got.cpu()}\nvs\n{ref_idx}")

    # 2) hybrid search: sharded against flat
    res_flat = hybrid_search_batch(gt_host, q_cpu, SearchWeights.create(device="cpu"),
                                   top_k=5, member_top_m=5)
    w = SearchWeights.create(device=dev)
    res_shard = hybrid_search_batch(gt, q, w, top_k=5, member_top_m=5)
    _check(torch.equal(res_shard.reranked_idx.cpu(), res_flat.reranked_idx),
           f"sharded hybrid search diverged:\n{res_shard.reranked_idx.cpu()}\nvs\n"
           f"{res_flat.reranked_idx}")
    err = (res_shard.reranked_score.cpu() - res_flat.reranked_score).abs().max().item()
    _check(err <= 1e-6, f"sharded hybrid search scores differ by {err}")

    # 3) the {slice, corpus} mesh: hierarchical merge, exact parity
    mesh2 = make_mesh(dp=2, axis_names=(SLICE_AXIS, CORPUS_AXIS))
    emb2 = local_rows(gt_host.emb, mesh2, (SLICE_AXIS, CORPUS_AXIS)).to(dev, copy=True)
    _, i2 = sharded_topk_2level(q, emb2, n_nodes, 5, mesh2)
    _check(torch.equal(i2.cpu(), ref_idx),
           f"2-level top-k diverged:\n{i2.cpu()}\nvs\n{ref_idx}")

    # 4) one sharded PPO step (dp episodes x corpus-sharded graph)
    learner = PPOLearner(OBS_DIM, 6, PPOConfig(epochs=1), device=dev)
    step = make_sharded_train_step(learner, w, mesh, max_steps=3)
    gen = torch.Generator(device=dev).manual_seed(mesh.get_local_rank(DATA_AXIS))
    metrics = {k: float(v) for k, v in step(gt, shard_queries(q, mesh), generator=gen).items()}
    _check(all(np.isfinite(v) for v in metrics.values()), f"PPO metrics {metrics}")
    return {"mesh": {DATA_AXIS: dp, CORPUS_AXIS: n // dp},
            "mesh2": {SLICE_AXIS: 2, CORPUS_AXIS: n // 2}, "nodes": int(n_nodes),
            "metrics": metrics, "launches": launches()}


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> Dict[str, Any]:
    """Start ``n_devices`` gloo ranks (on the card unless ``device`` says
    ``cpu``; gloo lets them share one card) and run the four checks; prints
    the ``dryrun_multichip ok`` line and returns rank 0's summary with every
    rank's launch counts."""
    from ahrag_tpu_torch.parallel.distributed import spawn
    dev = resolve_device(device)
    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"the dry run's meshes need an even number of ranks, got {n_devices}")
    results = spawn(_dryrun_rank, n_devices, dev.type, backend="gloo")
    summary = dict(results[0], launches=[r["launches"] for r in results])
    print(f"dryrun_multichip ok: mesh={summary['mesh']} mesh2={summary['mesh2']} "
          f"nodes={summary['nodes']} topk_parity=exact hybrid_search_parity=exact "
          f"topk_2level_parity=exact metrics={summary['metrics']}", flush=True)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", type=int, default=0, help="ranks of dryrun_multichip (0: skip)")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    vals, ids = fn(*example)
    print("entry() forward ok:", tuple(vals.shape), tuple(ids.shape), flush=True)
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=args.device)


if __name__ == "__main__":
    main()
