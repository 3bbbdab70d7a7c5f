"""The port's stacked graphs, multi-graph search and rollouts against
``ahrag_tpu.graph.multi`` on the same graphs and queries.

Each graph is compiled by the JAX package and carried across leaf by leaf
(or a JAX stack leaf by leaf). Tolerances: leaves, ids, flags, actions,
masks and dones exactly; scores, rewards and observations within 1e-6
(float32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.helpers as helpers
from ahrag_tpu.agent import vec_env as jv
from ahrag_tpu.graph import multi as jm
from ahrag_tpu.graph import search as jsearch
from ahrag_tpu_torch import bench_data, convert
from ahrag_tpu_torch.agent import ppo as tppo
from ahrag_tpu_torch.agent import vec_env as tv
from ahrag_tpu_torch.graph import multi as tm
from ahrag_tpu_torch.graph.search import hybrid_search_batch
from tests.test_multi_graph import _mini_items, _science_graph
from tests.test_torch_agent import (SCHEDULES, _bench_jgt, _jax_scripted, _pair,
                                    _torch_policy, assert_state)

TOL = 1e-6
QUERIES = ["Who directed the film Ed Wood?", "Who discovered radium?"]


def _port_stack(jb) -> tm.BatchedGraphTensors:
    return tm.BatchedGraphTensors(
        **{n: convert.tensor_from_numpy(np.asarray(getattr(jb, n)), "cpu") for n in jm._LEAVES},
        n_nodes=tuple(jb.n_nodes))


def _hgs():
    a = helpers.build_film_graph()
    a.build_vector_index(layers=(0, 1, 2))
    return [a, _science_graph()]


@pytest.fixture(scope="module")
def small():
    """Film and science graphs: each package's stack, per-graph port
    tensors and one query per graph."""
    hgs = _hgs()
    pairs = [_pair(h.tensors()) for h in hgs]
    q = np.stack([np.array(h.encode_query([t])[0]) for h, t in zip(hgs, QUERIES)])
    return (jm.stack_graph_tensors([p[0] for p in pairs]),
            tm.stack_graph_tensors([p[1] for p in pairs]), [p[1] for p in pairs], q)


@pytest.fixture(scope="module")
def large():
    """Two bench graphs whose stack has 4,096 rows: the graph-by-graph seed
    path (the kernel path on the card)."""
    arrs = [bench_data.build_bench_arrays(4000, 64, d=32),
            bench_data.build_bench_arrays(2500, 40, d=32, seed=3)]
    pairs = [_pair(_bench_jgt(a, "float32")) for a in arrs]
    q = np.stack([bench_data.bench_queries(a, 1)[0] for a in arrs])
    return (jm.stack_graph_tensors([p[0] for p in pairs]),
            tm.stack_graph_tensors([p[1] for p in pairs]), [p[1] for p in pairs], q)


def _assert_fields(jres, tres, names):
    for name in names:
        jval, tval = np.asarray(getattr(jres, name)), getattr(tres, name).numpy()
        assert tval.shape == jval.shape, name
        if jval.dtype.kind == "f":
            np.testing.assert_allclose(tval, jval, rtol=0, atol=TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(tval, jval, err_msg=name)


@pytest.mark.parametrize("which", ["small", "large"])
def test_stack_leaves_equal_jax(request, which):
    jb, tb, _, _ = request.getfixturevalue(which)
    for name in jm._LEAVES:
        tval = getattr(tb, name)
        assert tval.dtype == convert.tensor_from_numpy(np.asarray(getattr(jb, name)), "cpu").dtype
        np.testing.assert_array_equal(tval.numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    assert tb.n_nodes == jb.n_nodes and tb.n_pad == jb.n_pad and tb.n_graphs == jb.n_graphs
    assert not bool(tb.valid[1, int(tb.n_nodes[1]):].any())


@pytest.mark.parametrize("which", ["small", "large"])
def test_search_multi_equals_jax_and_per_graph_search(request, which):
    jb, tb, gts, q = request.getfixturevalue(which)
    jres = jm.hybrid_search_multi(jb, jnp.asarray(q), jsearch.SearchWeights.create())
    w = tv.SearchWeights.create(device="cpu")
    tres = tm.hybrid_search_multi(tb, torch.from_numpy(q), w)
    _assert_fields(jres, tres, jres._fields)
    for g, gt in enumerate(gts):
        one = hybrid_search_batch(gt, torch.from_numpy(q[g:g + 1]), w)
        ok = tres.reranked_valid[g]
        assert torch.equal(ok, one.reranked_valid[0])
        assert torch.equal(tres.reranked_idx[g][ok], one.reranked_idx[0][ok])
        np.testing.assert_allclose(tres.reranked_score[g][ok].numpy(),
                                   one.reranked_score[0][ok].numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_rollout_multi_scripted_matches_jax(small, sched):
    jb, tb, _, q = small
    jtraj, jfinal = jm.rollout_multi(jb, jnp.asarray(q), jnp.asarray(SCHEDULES[sched]),
                                     _jax_scripted, jax.random.PRNGKey(0),
                                     jsearch.SearchWeights.create(), max_steps=6)
    ttraj, tfinal = tm.rollout_multi(tb, torch.from_numpy(q), _torch_policy(SCHEDULES[sched]),
                                     tv.SearchWeights.create(device="cpu"), max_steps=6,
                                     generator=torch.Generator().manual_seed(0))
    _assert_fields(jtraj, ttraj, tv.Trajectory._fields)
    assert_state(jfinal, tfinal, "final")
    assert torch.equal(tfinal.graph, torch.arange(2))


def test_multi_steps_with_lca_match_jax(small):
    """Every action, LCA included, on lanes that each walk their own graph."""
    jb, tb, _, q = small
    g = jm._as_graph(jb)
    js = jax.vmap(lambda gg, qq: jv.env_reset(gg, qq, jsearch.SearchWeights.create()))(
        g, jnp.asarray(q))
    res = tm.hybrid_search_multi(tb, torch.from_numpy(q), tv.SearchWeights.create(device="cpu"),
                                 certify=False)
    ts = tv.reset_from_search(res, tb.n_pad, graph=torch.arange(2))
    assert_state(js, ts, "reset")
    step = jax.jit(jax.vmap(lambda gg, s, a: jv.env_step(gg, s, a, enable_lca=True)))
    for t, a in enumerate([[6, 2], [0, 6], [3, 1], [2, 3], [6, 6], [1, 0], [4, 4]]):
        a = np.asarray(a, np.int32)
        js, jr, jd = step(g, js, jnp.asarray(a))
        ts, tr, td = tv.env_step(tb, ts, torch.from_numpy(a), enable_lca=True)
        assert_state(js, ts, f"step {t}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=TOL)
        np.testing.assert_allclose(tv.observe(tb, ts).numpy(),
                                   np.asarray(jax.vmap(jv.observe)(g, js)), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def fleet():
    from ahrag_tpu.agent.fleet import build_question_fleet
    jb, q, gold, _ = build_question_fleet(_mini_items(), log=lambda s: None)
    return _port_stack(jb), q, gold


def test_ppo_train_multi_smoke(fleet, tmp_path):
    import json
    tb, q, gold = fleet
    learner = tppo.ppo_train_multi(tb, q, tv.SearchWeights.create(device="cpu"),
                                   gold_masks=gold, n_updates=3,
                                   ppo_cfg=tppo.PPOConfig(epochs=1),
                                   save_path=str(tmp_path / "ppo.pt"),
                                   curve_out=str(tmp_path / "curve.json"),
                                   log=lambda s: None, seed=0)
    curve = json.loads((tmp_path / "curve.json").read_text())
    assert curve["n_updates"] == 3 and curve["n_graphs"] == 2
    assert all("mean_final_recall" in c and np.isfinite(c["mean_ep_reward"])
               for c in curve["curve"])
    assert tppo.PPOLearner.load(str(tmp_path / "ppo.pt"), device="cpu").n_actions == \
        learner.n_actions


def test_commit_policy_captures_gold_nodes(fleet):
    """Committing the top 3 every step selects the gold node of these
    two-paragraph graphs (the question names it)."""
    tb, q, gold = fleet

    def commit_policy(obs):
        logits = torch.full((obs.shape[0], tv.N_ACTIONS), -1e9)
        logits[:, 3] = 0.0
        return logits, torch.zeros(obs.shape[0])

    _, final = tm.rollout_multi(tb, torch.from_numpy(q), commit_policy,
                                tv.SearchWeights.create(device="cpu"), max_steps=4)
    assert int((final.selection & torch.from_numpy(gold)).sum()) >= 1


def test_stack_refuses_mixed_dims():
    a = _pair(_science_graph().tensors())[1]
    b = dataclasses.replace(a, emb=a.emb[:, :8])
    with pytest.raises(ValueError):
        tm.stack_graph_tensors([a, b])
    with pytest.raises(ValueError):
        tm.stack_graph_tensors([])
