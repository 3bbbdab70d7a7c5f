"""Rank programs: what each rank of a ``distributed.spawn`` launch runs.

Each function below is started on every rank by
``spawn(fn, world_size, *args)``; it builds its mesh over the group, takes
its rows of the data, runs the sharded functions and returns its results as
CPU tensors (with the kernels' launch counts on this rank), for the caller to
hold against an unsharded run. Data travels as a callable (a module-level
function bound with ``functools.partial``) that each rank calls on its own
device, so that a 1M-row corpus is drawn on the card by every rank rather
than sent to it. The tests (on the CPU over gloo), ``chip_smoke.py`` (four
ranks sharing one card over gloo) and ``entry.dryrun_multichip`` start them.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.parallel.distributed import rank_device
from ahrag_tpu_torch.parallel.mesh import (CORPUS_AXIS, DATA_AXIS, SLICE_AXIS, local_rows,
                                           make_mesh)
from ahrag_tpu_torch.parallel.sharded import (_binned_topk, shard_graph_tensors,
                                              shard_minilm_params, shard_queries,
                                              sharded_dense_topk, sharded_refined_topk_cert,
                                              sharded_topk_2level)

Data = Callable[[torch.device], Tuple[torch.Tensor, torch.Tensor]]


def to_cpu(x: Any) -> Any:
    """``x`` with every tensor inside dicts, lists and tuples on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(to_cpu(v) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*(to_cpu(v) for v in x))
    return x


def launches() -> Dict[str, int]:
    """This process's kernel launch counts (``ops``' counters)."""
    from ahrag_tpu_torch.ops.binmax import dense_binmax, dense_binmax2
    from ahrag_tpu_torch.ops.tile_topk import tile_topk
    return {"binmax2_cuda": dense_binmax2.launches, "binmax_cuda": dense_binmax.launches,
            "tile_topk_cuda": tile_topk.launches}


def several(calls: Sequence[Tuple[Callable[..., Any], tuple]]) -> list:
    """Run ``fn(*args)`` for each ``(fn, args)`` in turn on this rank: several
    programs in one launch."""
    return [fn(*args) for fn, args in calls]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def arrays(q: np.ndarray, emb: np.ndarray, dtype: str, device: torch.device):
    """Data from numpy arrays, stored as ``dtype``."""
    dt = getattr(torch, dtype)
    return (torch.from_numpy(np.ascontiguousarray(q)).to(device, dt),
            torch.from_numpy(np.ascontiguousarray(emb)).to(device, dt))


def ladder(n: int, d: int, b: int, seed: int, dtype: str, dup_rows: int,
           device: torch.device):
    """``cli/topk_bench.make_data``'s clustered corpus in ``dtype``. With
    ``dup_rows`` > 0 the first ``dup_rows`` rows are copies of row 0 and every
    query lies close to it: the top-k are ties spread over many bins, so a
    binned certificate cannot hold."""
    from ahrag_tpu_torch.cli.topk_bench import make_data
    q, e = make_data(n, d, b, seed=seed, device=device)
    if dup_rows:
        e[:dup_rows] = e[0]
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        q = e[0] + 0.05 * torch.randn((b, d), generator=gen, device=device)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    dt = getattr(torch, dtype)
    return q.to(dt), e.to(dt)


def bench_graph(n_entities: int, n_topics: int, emb_dtype: str):
    """The bench rung's graph (``bench_data``) built on the CPU."""
    from ahrag_tpu_torch.bench_data import bench_tensors, build_bench_arrays
    return bench_tensors(build_bench_arrays(n_entities, n_topics), emb_dtype, device="cpu")


def topk_program(data: Data, ks: Sequence[int], n_valid: int, device: str,
                 margin: int = 16, two_level: bool = True) -> Dict[str, Any]:
    """``sharded_dense_topk`` and ``sharded_refined_topk`` over a ``{1, S}``
    mesh and, with ``two_level``, ``sharded_topk_2level`` over ``{slice 2,
    corpus S/2}``, at each k of ``ks``; per k the (vals, ids) of each, the
    refined certificate and the seconds of a call after a warm one."""
    dev = rank_device(device)
    q, emb = data(dev)
    mesh = make_mesh()
    emb_l = local_rows(emb, mesh).clone()
    emb2 = None
    if two_level:
        mesh2 = make_mesh(dp=2, axis_names=(SLICE_AXIS, CORPUS_AXIS))
        emb2 = local_rows(emb, mesh2, (SLICE_AXIS, CORPUS_AXIS)).clone()
    del emb
    out: Dict[str, Any] = {"rows": emb_l.shape[0], "by_k": {}}
    for k in ks:
        res: Dict[str, Any] = {}
        for name, fn in (("dense", lambda: sharded_dense_topk(q, emb_l, n_valid, k, mesh)),
                         ("refined", lambda: sharded_refined_topk_cert(
                             q, emb_l, n_valid, k, mesh, margin)),
                         ("two_level", lambda: sharded_topk_2level(q, emb2, n_valid, k, mesh2))):
            if name == "two_level" and not two_level:
                continue
            fn()                  # warm: first launches, the eps calibration
            _sync(dev)
            t0 = time.perf_counter()
            r = fn()
            _sync(dev)
            res[name] = r[:2]
            res[f"{name}_s"] = time.perf_counter() - t0
            if name == "refined":
                res["certified"] = r[2]
        out["by_k"][k] = res
    out["launches"] = launches()
    return to_cpu(out)


def binned_program(data: Data, k: int, n_valid: int, device: str,
                   margin: int = 16) -> Dict[str, Any]:
    """The binned local stage (``sharded._binned_topk``) called directly
    over a ``{1, S}`` mesh, whatever the device: (vals, ids, certified)."""
    dev = rank_device(device)
    q, emb = data(dev)
    mesh = make_mesh()
    emb_l = local_rows(emb, mesh).clone()
    offset = mesh.get_local_rank(CORPUS_AXIS) * emb_l.shape[0]
    mask_l = offset + torch.arange(emb_l.shape[0], device=dev) < n_valid
    v, i, cert = _binned_topk(q, emb_l, mask_l, offset, k, margin,
                              mesh.get_group(CORPUS_AXIS))
    return to_cpu({"vals": v, "ids": i, "certified": cert, "launches": launches()})


def graph_program(graph: Callable[[], Any], q_search: torch.Tensor, device: str,
                  top_k: int = 5, member_top_m: int = 5,
                  q_ppo: Optional[torch.Tensor] = None, ppo_seed: int = 0,
                  max_steps: int = 3) -> Dict[str, Any]:
    """Hybrid search on the graph sharded over a ``{1, S}`` mesh, for all of
    ``q_search``; then, given ``q_ppo``, one ``make_sharded_train_step`` on
    the graph sharded over ``{dp 2, corpus S/2}``, each dp rank on its rows of
    ``q_ppo`` with a generator seeded ``ppo_seed + dp index``. ``graph()``
    returns the whole graph on the CPU. Returns the search result and its
    seconds (after a warm call at the same shape), and for the step the
    rank's rollout (drawn from the same seed before the step, warm and then
    timed), the metrics, the step's seconds, the initial and the updated
    parameters, the gradient the step applied (summed over dp), and the
    seconds of a second step."""
    from ahrag_tpu_torch.agent.featurizer import OBS_DIM
    from ahrag_tpu_torch.agent.ppo import PPOConfig, PPOLearner, make_sharded_train_step
    from ahrag_tpu_torch.agent.vec_env import N_ACTIONS, rollout_batch
    from ahrag_tpu_torch.graph.search import (MEMBER_SIM_CAP, SEM_FLUSH_EPS, SearchWeights,
                                              hybrid_search_batch)

    dev = rank_device(device)
    gt_host = graph()
    w = SearchWeights.create(device=dev)
    mesh = make_mesh()
    gt = shard_graph_tensors(gt_host, mesh, dev)
    q = q_search.to(dev)
    hybrid_search_batch(gt, q, w, top_k=top_k, member_top_m=member_top_m)   # warm
    _sync(dev)
    t0 = time.perf_counter()
    res = hybrid_search_batch(gt, q, w, top_k=top_k, member_top_m=member_top_m)
    _sync(dev)
    out: Dict[str, Any] = {"search": res, "search_s": time.perf_counter() - t0,
                           "emb_rows": gt.emb.shape[0]}
    # the search's two collective stages alone: the seeds, and the member rows
    # (every seed's first MEMBER_SIM_CAP children, as expand_candidates reads them)
    for name, fn in (("seeds_s", lambda: gt.shard.seed_topk(
                          gt, q, top_k, max(12, 2 * top_k + 2), SEM_FLUSH_EPS)),
                     ("member_rows_s", lambda: gt.shard.gather_rows(gt.emb, gt.children[
                          res.seed_idx.clamp(0, gt.n_pad - 1)][..., :MEMBER_SIM_CAP]
                          .long().clamp(0, gt.n_pad - 1)))):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out[name] = time.perf_counter() - t0
    del gt
    if q_ppo is not None:
        mesh2 = make_mesh(dp=2)
        gt2 = shard_graph_tensors(gt_host, mesh2, dev)
        learner = PPOLearner(OBS_DIM, N_ACTIONS, PPOConfig(epochs=1), seed=ppo_seed,
                             device=dev)
        params0 = {k: v.clone() for k, v in learner.model.state_dict().items()}
        q_l = shard_queries(q_ppo.to(dev), mesh2)
        seed = ppo_seed + mesh2.get_local_rank(DATA_AXIS)
        for _ in range(2):        # a warm rollout, then a timed one from the same seed
            _sync(dev)
            t0 = time.perf_counter()
            traj, _ = rollout_batch(gt2, q_l, learner.model, w, max_steps=max_steps,
                                    generator=torch.Generator(device=dev).manual_seed(seed))
            _sync(dev)
        out["rollout_s"] = time.perf_counter() - t0
        step = make_sharded_train_step(learner, w, mesh2, max_steps=max_steps)
        _sync(dev)
        t0 = time.perf_counter()
        metrics = step(gt2, q_l, generator=torch.Generator(device=dev).manual_seed(seed))
        _sync(dev)
        out.update(traj=traj, metrics=metrics, step_s=time.perf_counter() - t0,
                   params0=params0, dp_seed=seed,
                   params={k: v.clone() for k, v in learner.model.state_dict().items()},
                   grads={k: p.grad.clone() for k, p in learner.model.named_parameters()})
        # a second step, once the first has made its backward's first launches
        t0 = time.perf_counter()
        step(gt2, q_l, generator=torch.Generator(device=dev).manual_seed(seed + 2))
        _sync(dev)
        out["warm_step_s"] = time.perf_counter() - t0
    out["launches"] = launches()
    return to_cpu(out)


def minilm_program(cfg_kwargs: Dict[str, Any], state: Optional[Dict[str, torch.Tensor]],
                   seed: int, ids: np.ndarray, mask: np.ndarray, device: str) -> torch.Tensor:
    """MiniLM's encode with its blocks split over all ranks
    (``shard_minilm_params`` over the corpus axis of a ``{1, S}`` mesh), from
    ``state`` or, when it is None, the seeded initial weights."""
    from ahrag_tpu_torch.models.encoder.minilm import MiniLMConfig, MiniLMModel
    dev = rank_device(device)
    model = MiniLMModel(MiniLMConfig(**cfg_kwargs), seed=seed, device=dev).eval()
    if state is not None:
        model.load_state_dict(state)
    tp = shard_minilm_params(model, make_mesh())
    with torch.no_grad():
        out = tp(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
    return out.cpu()
