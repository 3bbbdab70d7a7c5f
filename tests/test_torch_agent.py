"""The port's featurizer, reward and batched environment against the JAX
package's, on the same graphs and queries.

Graphs: the film graph (``tests.helpers.build_film_graph``) and small bench
graphs (``bench_data``) in float32 and bf16, each compiled by the JAX package
and carried across leaf by leaf (``convert.graph_tensors_from_numpy``), and a
128-node bench graph whose ``n_pad`` equals its node count, so that its last
real node sits where the JAX package parks invalid writes. The JAX
environment runs one lane per query under ``vmap``; the port steps all
lanes at once.

Tolerances: ids, sizes, masks, steps, dones and actions exactly; scores,
rewards, observations and log-probabilities within 1e-6 (the seed scores
are float32 sums in another order; every other float is the same formula
on them). The featurizer is exact on equal inputs, the reward formulas
within 1e-7.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.helpers as helpers
from ahrag_tpu.agent import featurizer as jfeat
from ahrag_tpu.agent import reward as jreward
from ahrag_tpu.agent import vec_env as jv
from ahrag_tpu.graph import search as jsearch
from ahrag_tpu.graph import tensors as jtensors
from ahrag_tpu_torch import bench_data, convert
from ahrag_tpu_torch.agent import featurizer as tfeat
from ahrag_tpu_torch.agent import reward as treward
from ahrag_tpu_torch.agent import vec_env as tv

FILM_QUERIES = ["Who directed the film Ed Wood?", "American directors", "Doctor Strange",
                "Tim Burton", "superhero film 2016", "no overlap with anything qqq",
                "Scott Derrickson horror"]
STATE_FIELDS = [f.name for f in dataclasses.fields(jv.EnvState)]
# TestVecEnvParity's four sequences (tests/test_rl.py), then: a commit that
# empties the top list, a skipped query_node_details, end and a step after it
SEQUENCES = {"p0": [0, 3, 2, 1], "p1": [3, 0, 0, 2], "p2": [1, 2, 3, 4],
             "p3": [4, 3, 1, 0], "skip_end": [3, 3, 4, 5, 0, 2]}
TOL = 1e-6


# ------------------------------------------------------------------ graphs
def _leaves(jgt) -> dict:
    return {f.name: (getattr(jgt, f.name) if f.name in ("n_nodes", "n_edges", "mask_trivial")
                     else None if getattr(jgt, f.name) is None
                     else np.asarray(getattr(jgt, f.name)))
            for f in dataclasses.fields(jgt)}


def _pair(jgt):
    return jgt, convert.graph_tensors_from_numpy(_leaves(jgt), device="cpu")


def _bench_jgt(arrs, emb_dtype):
    empty = np.empty((0, 0), np.int32)
    return jtensors.build_graph_tensors(
        emb_dtype=emb_dtype, embeddings=arrs.emb, node_types=arrs.node_type,
        levels=arrs.level, judges=arrs.judge, confs=arrs.conf,
        indexed=np.ones(arrs.n, bool), parents=arrs.parents_ell,
        children=arrs.children_ell, related=arrs.related_ell, hyperedges=empty,
        members=empty)


@pytest.fixture(scope="module")
def graphs():
    hg = helpers.build_film_graph()
    hg.build_vector_index(layers=(0, 1, 2))
    out = {"film": (*_pair(hg.tensors()), np.array(hg.encode_query(FILM_QUERIES)))}
    arrs = bench_data.build_bench_arrays(600, 24, d=48)
    q = bench_data.bench_queries(arrs, 7)
    for dt in ("float32", "bfloat16"):
        out[f"bench_{dt}"] = (*_pair(_bench_jgt(arrs, dt)), q)
    # 119 entities + 8 topics + 1 community = 128 nodes = n_pad: node 127 is
    # the community, every topic's parent; queries near topics and one at it
    edge = bench_data.build_bench_arrays(119, 8, d=32)
    qe = np.concatenate([bench_data.bench_queries(edge, 5), edge.emb[127:128]])
    out["n_pad_eq_n"] = (*_pair(_bench_jgt(edge, "float32")), qe)
    return out


# -------------------------------------------------------------- JAX side
@jax.jit
def j_reset(gt, q, w):
    return jax.vmap(lambda qq: jv.env_reset(gt, qq, w))(q)


@jax.jit
def j_step(gt, s, a):
    return jax.vmap(lambda ss, aa: jv.env_step(gt, ss, aa, enable_lca=True))(s, a)


@jax.jit
def j_observe(gt, s):
    return jax.vmap(lambda ss: jv.observe(gt, ss))(s)


def assert_state(js, ts, what=""):
    """Every field of JAX's EnvState (lanes stacked) against the port's."""
    for name in STATE_FIELDS:
        jval, tval = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert tval.shape == jval.shape, (what, name)
        if jval.dtype.kind == "f":
            np.testing.assert_allclose(tval, jval, rtol=0, atol=TOL, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(tval, jval, err_msg=f"{what} {name}")
    np.testing.assert_array_equal(ts.sel_count.numpy(), ts.selection.sum(1).numpy())
    np.testing.assert_array_equal(ts.front_count.numpy(), ts.frontier.sum(1).numpy())


def _run_both(pair, q, actions):
    """Reset both environments on ``q`` and step both through ``actions
    [T, B]`` with the LCA action enabled, holding every state, reward, done
    and observation."""
    jgt, tgt, _ = pair
    jw, tw = jsearch.SearchWeights.create(), tv.SearchWeights.create(device="cpu")
    js, ts = j_reset(jgt, jnp.asarray(q), jw), tv.env_reset(tgt, torch.from_numpy(q), tw)
    assert_state(js, ts, "reset")
    history = []
    for t, a in enumerate(actions):
        a = np.asarray(a, np.int32)
        pre_top_empty = np.asarray(js.top_ids[:, 0]) >= jgt.n_pad
        pre_done = np.asarray(js.done)
        js, jr, jd = j_step(jgt, js, jnp.asarray(a))
        ts, tr, td = tv.env_step(tgt, ts, torch.from_numpy(a), enable_lca=True)
        assert_state(js, ts, f"step {t} actions {a.tolist()}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=TOL)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tv.observe(tgt, ts).numpy(), np.asarray(j_observe(jgt, js)),
                                   rtol=0, atol=TOL)
        history.append((a, pre_top_empty, pre_done))
    return js, ts, history


# ------------------------------------------------------- featurizer/reward
def test_featurize_device_equals_jax():
    rng = np.random.default_rng(0)
    B, K = 9, tfeat.K_NODES
    g = {"step": rng.integers(0, 9, B).astype(np.int32),
         "selection_size": rng.integers(0, 30, B).astype(np.int32),
         "frontier_size": rng.integers(0, 50, B).astype(np.int32),
         "n_seeds": rng.integers(0, 6, B).astype(np.int32)}
    n = {"top_valid": rng.random((B, K)) < 0.7,
         "top_type": rng.integers(-1, 3, (B, K)).astype(np.int32),
         "top_layer": rng.integers(0, 3, (B, K)).astype(np.int32),
         **{k: rng.standard_normal((B, K)).astype(np.float32)
            for k in ("top_score", "top_sem", "top_judge", "top_conf")}}
    ref = jax.vmap(jfeat.featurize_device)(**{k: jnp.asarray(v) for k, v in {**g, **n}.items()})
    got = tfeat.featurize_device(**{k: torch.from_numpy(v) for k, v in {**g, **n}.items()})
    assert got.shape == (B, tfeat.OBS_DIM) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n_sel", [0, 3, 10, 14])
def test_featurize_observation_equals_jax(n_sel):
    rng = np.random.default_rng(n_sel)
    types = ["entity", "summary", "hyperedge", None]
    obs = {"step": 3, "seeds": list(range(n_sel % 4)),
           "state": {"selection_ids": list(range(n_sel)), "frontier_ids": list(range(7))},
           "selection": [{"node_id": f"n{i}", "node_type": types[i % 4], "layer": i % 3,
                          "score": float(rng.random()), "semantic": float(rng.random()),
                          "judge_overall": None if i % 2 else 7.5, "confidence": i * 0.5}
                         for i in range(n_sel)]}
    tv_, tinfo = tfeat.featurize_observation(obs)
    jv_, jinfo = jfeat.featurize_observation(obs)
    np.testing.assert_array_equal(tv_, jv_)
    assert tinfo == jinfo and tv_.dtype == np.float32 and tv_.shape == (tfeat.OBS_DIM,)


def test_rewards_equal_jax():
    rng = np.random.default_rng(1)
    sizes = [rng.integers(0, 60, 64).astype(np.int32) for _ in range(4)]
    ref = jreward.step_reward_device(*(jnp.asarray(s) for s in sizes))
    got = treward.step_reward_device(*(torch.from_numpy(s) for s in sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-7)
    prev = {"state": {"selection_ids": ["a"], "frontier_ids": ["x", "y"]}}
    for cur in ({"state": {"selection_ids": ["a", "b", "c"], "frontier_ids": list("xyzuvwpqrstu")}},
                {"state": {}}, {}):
        for p in (None, prev):
            assert abs(treward.step_reward(p, cur) - jreward.step_reward(p, cur)) <= 1e-7
    m = {"f1": 0.5, "faithfulness": 0.25, "answer_relevancy": 1.0}
    assert abs(treward.final_reward(m) - jreward.final_reward(m)) <= 1e-7


# --------------------------------------------------------------- env steps
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("graph", ["film", "bench_float32", "bench_bfloat16"])
def test_env_sequences_match_jax(graphs, graph, seq):
    pair = graphs[graph]
    B = pair[2].shape[0]
    actions = [[a] * B for a in SEQUENCES[seq]]
    _, ts, history = _run_both(pair, pair[2], actions)
    if seq == "skip_end":
        # the second commit emptied some lane's top list, so its
        # query_node_details was skipped; the step after end is inert
        assert any(e.any() for a, e, _ in history if a[0] == 4)
        assert history[-1][2].all() and bool(ts.done.all())


@pytest.mark.parametrize("graph", ["film", "bench_float32", "bench_bfloat16", "n_pad_eq_n"])
def test_env_seeded_mixed_actions_match_jax(graphs, graph):
    """Each lane its own seeded action per step, 0-6 with the LCA action
    enabled, over more steps than ``max_steps``."""
    pair = graphs[graph]
    B = pair[2].shape[0]
    actions = np.random.default_rng(7).integers(0, 7, (9, B))
    _, _, history = _run_both(pair, pair[2], actions)
    taken = {int(x) for acts, _, done in history for x, d in zip(acts, done) if not d}
    assert taken == set(range(7)), taken


def test_batched_step_equals_jax_per_lane(graphs):
    """One env_step with a different action on each lane equals the JAX
    env_step of each lane alone."""
    jgt, tgt, q = graphs["film"]
    jw, tw = jsearch.SearchWeights.create(), tv.SearchWeights.create(device="cpu")
    js = j_reset(jgt, jnp.asarray(q), jw)
    ts = tv.env_reset(tgt, torch.from_numpy(q), tw)
    actions = np.arange(q.shape[0], dtype=np.int32) % 7
    ts, tr, td = tv.env_step(tgt, ts, torch.from_numpy(actions), enable_lca=True)
    step_one = jax.jit(functools.partial(jv.env_step, enable_lca=True))
    for b, a in enumerate(actions):
        lane = jax.tree_util.tree_map(lambda x: x[b], js)
        jl, jr, jd = step_one(jgt, lane, jnp.int32(a))
        for name in STATE_FIELDS:
            jval, tval = np.asarray(getattr(jl, name)), getattr(ts, name)[b].numpy()
            if jval.dtype.kind == "f":
                np.testing.assert_allclose(tval, jval, rtol=0, atol=TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(tval, jval, err_msg=f"lane {b} {name}")
        assert abs(float(tr[b]) - float(jr)) <= TOL and bool(td[b]) == bool(jd)


def test_last_real_node_stays_selected(graphs):
    """On a graph with n_pad == n the last row is a real node (the topics'
    community). It enters the frontier by expand_parents and the selection
    by a commit in steps whose other ids are invalid, and stays selected."""
    pair = graphs["n_pad_eq_n"]
    jgt, tgt, q = pair
    assert jgt.n_pad == jgt.n_nodes == 128
    B = q.shape[0]
    js, ts, _ = _run_both(pair, q, [[0] * B, [3] * B, [0] * B, [1] * B, [3] * B])
    last = tgt.n_pad - 1
    assert bool(ts.selection[:, last].all()), ts.selection[:, last]
    np.testing.assert_array_equal(np.asarray(js.selection[:, last]), True)


def test_action_mask_end_only_without_top(graphs):
    jgt, tgt, q = graphs["film"]
    ts = tv.env_reset(tgt, torch.from_numpy(q), tv.SearchWeights.create(device="cpu"))
    ts = ts.replace(top_ids=ts.top_ids.clone())
    ts.top_ids[1:3] = tgt.n_pad
    m = tv.action_mask(ts, tgt.n_pad)
    ref = jax.vmap(lambda s: jv.action_mask(s, jgt.n_pad))(
        jv.EnvState(**{n: jnp.asarray(getattr(ts, n).numpy()) for n in STATE_FIELDS}))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref))
    assert m[1].tolist() == [False] * 5 + [True] and bool(m[0].all())


# ---------------------------------------------------------------- rollouts
SCHEDULES = {"a": [0, 0, 3, 2, 1, 4, 5, 5], "b": [3, 3, 4, 1, 0, 2, 3, 3]}


def _jax_scripted(sched, obs):
    """The scripted policy as a JAX ``apply_fn``, the schedule as its params
    (one compile for every schedule)."""
    a = sched[jnp.clip(obs[:, 0].astype(jnp.int32), 0, sched.shape[0] - 1)]
    return jax.nn.one_hot(a, tv.N_ACTIONS) * 1e4, obs[:, :4].sum(1) * 0.01


def _torch_policy(schedule):
    sched = torch.tensor(schedule)

    def policy(obs):
        a = sched[obs[:, 0].long().clamp(0, len(schedule) - 1)]
        return torch.nn.functional.one_hot(a, tv.N_ACTIONS).float() * 1e4, obs[:, :4].sum(1) * 0.01
    return policy


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("graph", ["film", "bench_bfloat16"])
def test_rollout_batch_scripted_matches_jax(graphs, graph, sched):
    jgt, tgt, q = graphs[graph]
    jtraj, jfinal = jv.rollout_batch(jgt, jnp.asarray(q), jnp.asarray(SCHEDULES[sched]),
                                     _jax_scripted,
                                     jax.random.PRNGKey(0), jsearch.SearchWeights.create(),
                                     max_steps=6)
    ttraj, tfinal = tv.rollout_batch(tgt, torch.from_numpy(q), _torch_policy(SCHEDULES[sched]),
                                     tv.SearchWeights.create(device="cpu"), max_steps=6,
                                     generator=torch.Generator().manual_seed(0))
    for name in tv.Trajectory._fields:
        jval, tval = np.asarray(getattr(jtraj, name)), getattr(ttraj, name).numpy()
        assert tval.shape == jval.shape, name
        if jval.dtype.kind == "f":
            np.testing.assert_allclose(tval, jval, rtol=0, atol=TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(tval, jval, err_msg=name)
    assert_state(jfinal, tfinal, "final")
    assert bool(ttraj.mask[:, 0].all())


# ---------------------------------------------------------------- sampling
def test_sampler_never_takes_a_masked_action_and_repeats_with_its_seed():
    logits = torch.randn(4096, tv.N_ACTIONS, generator=torch.Generator().manual_seed(3))
    mask = torch.rand(4096, tv.N_ACTIONS, generator=torch.Generator().manual_seed(4)) < 0.5
    mask[:, -1] = True
    masked = torch.where(mask, logits, -1e9)
    a = tv.sample_actions(masked, torch.Generator().manual_seed(5))
    assert bool(mask.gather(1, a[:, None]).all())
    b = tv.sample_actions(masked, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert not torch.equal(a, tv.sample_actions(masked, torch.Generator().manual_seed(6)))


def test_sampler_frequencies_follow_softmax():
    n = 20000
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0, -3.0, 1.0])
    draws = tv.sample_actions(logits.expand(n, -1), torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=6).double() / n
    p = torch.softmax(logits.double(), 0)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert bool(((freq - p).abs() <= 4 * sigma).all()), (freq, p)
