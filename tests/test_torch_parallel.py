"""The port's multi-device path against the JAX package's, on the same inputs.

JAX runs on the 8-device virtual CPU mesh of ``tests/conftest.py``; the port
runs on 4 gloo ranks (processes) started by ``parallel.distributed.spawn``
with a ``file://`` rendezvous under ``tmp_path``. Each group of cases is one
launch: the ranks run the port's own rank programs (``parallel/programs.py``)
and the tests hold every rank's result against JAX's, or against the port's
unsharded path where JAX has no counterpart of the run (its random stream).

Tolerances: ids exactly; top-k values within 1e-5 relatively (float32 sums
in another order); hybrid search scores within 1e-6; MiniLM within 2e-4 /
2e-5 (the JAX test's); rollouts' observations and the updated parameters
within 1e-6.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.helpers as helpers
from ahrag_tpu.graph.search import SearchWeights as JSearchWeights
from ahrag_tpu.graph.search import hybrid_search_batch as j_hybrid_search_batch
from ahrag_tpu.models.encoder.minilm import MiniLMConfig as JMiniLMConfig
from ahrag_tpu.models.encoder.minilm import MiniLMEncoder as JMiniLMEncoder
from ahrag_tpu.ops.topk import NEG_INF
from ahrag_tpu.parallel.mesh import make_mesh as j_make_mesh
from ahrag_tpu.parallel.sharded import SLICE_AXIS as J_SLICE
from ahrag_tpu.parallel.sharded import sharded_dense_topk as j_sharded_dense_topk
from ahrag_tpu.parallel.sharded import sharded_refined_topk as j_sharded_refined_topk
from ahrag_tpu.parallel.sharded import sharded_topk_2level as j_sharded_topk_2level
from ahrag_tpu_torch import convert, entry
from ahrag_tpu_torch.agent import ppo as tppo
from ahrag_tpu_torch.agent import vec_env as tv
from ahrag_tpu_torch.agent.featurizer import OBS_DIM
from ahrag_tpu_torch.graph.search import SearchWeights
from ahrag_tpu_torch.ops.topk import dense_topk_ref
from ahrag_tpu_torch.parallel import distributed, programs
from ahrag_tpu_torch.parallel.distributed import spawn
from tests.test_torch_agent import _leaves

RANKS = 4
FILM_QUERIES = ["Who directed the film Ed Wood?", "American directors", "Doctor Strange",
                "Tim Burton", "superhero film 2016", "no overlap with anything qqq",
                "Scott Derrickson horror", "Who directed Ed Wood?"]
PPO_QUERIES = ["Who directed Ed Wood?", "American directors", "Doctor Strange",
               "Tim Burton films"]
PPO_SEED = 3
BINNED_N = 4 * 65536          # 65,536 rows per shard: the binned stage's window


def _tie_inputs():
    e = np.zeros((1024, 64), np.float32)
    e[:, 0] = 1.0
    q = np.zeros((1, 64), np.float32)
    q[0, 0] = 1.0
    return q, e


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    dense = (rng.normal(size=(3, 64)).astype(np.float32),
             rng.normal(size=(1024, 64)).astype(np.float32))
    rng = np.random.default_rng(3)
    refined = (rng.normal(size=(4, 64)).astype(np.float32),
               rng.normal(size=(2048, 64)).astype(np.float32))
    rng = np.random.default_rng(9)
    emb2 = rng.normal(size=(1024, 64)).astype(np.float32)
    emb2 /= np.linalg.norm(emb2, axis=1, keepdims=True)
    q2 = rng.normal(size=(6, 64)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    hg = helpers.build_film_graph()
    hg.build_vector_index(layers=(0, 1, 2))
    jgt = hg.tensors()
    enc = JMiniLMEncoder(JMiniLMConfig(layers=2, max_len=16), seed=0)
    texts = ["hello world", "tensor parallel encoders"]
    ids, attn = enc._tokenize(texts)
    return {"dense": dense, "tie": _tie_inputs(), "refined": refined, "two_level": (q2, emb2),
            "jgt": jgt, "leaves": _leaves(jgt),
            "q_film": np.array(hg.encode_query(FILM_QUERIES), np.float32),
            "q_ppo": np.array(hg.encode_query(PPO_QUERIES), np.float32),
            "minilm": (enc, texts, ids, attn)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """One 4-rank launch of every program of this module but the binned stage
    and the dry run; returns each rank's results."""
    enc, _, ids, attn = inputs["minilm"]
    state = convert.flax_params_from_numpy(jax.tree_util.tree_map(np.asarray, enc.params))
    graph = functools.partial(convert.graph_tensors_from_numpy, inputs["leaves"], "cpu")
    calls = [
        (programs.topk_program, (functools.partial(programs.arrays, *inputs["dense"], "float32"),
                                 [7], 1000, "cpu", 16, False)),
        (programs.topk_program, (functools.partial(programs.arrays, *inputs["tie"], "float32"),
                                 [5], 1024, "cpu", 16, False)),
        (programs.topk_program, (functools.partial(programs.arrays, *inputs["refined"],
                                                   "float32"), [7], 2000, "cpu", 16, False)),
        (programs.topk_program, (functools.partial(programs.arrays, *inputs["refined"],
                                                   "float32"), [300, 3000], 2000, "cpu", 4,
                                 False)),
        (programs.topk_program, (functools.partial(programs.arrays, *inputs["two_level"],
                                                   "float32"), [7], 1024 - 100, "cpu")),
        (programs.graph_program, (graph, torch.from_numpy(inputs["q_film"]), "cpu", 5, 5,
                                  torch.from_numpy(inputs["q_ppo"]), PPO_SEED, 3)),
        (programs.minilm_program, ({"layers": 2, "max_len": 16}, state, 0, ids, attn, "cpu")),
        (distributed.initialize, ()),
        (distributed.process_info, ()),
    ]
    return spawn(programs.several, RANKS, calls,
                 init_file=str(tmp_path_factory.mktemp("rdv") / "init"), timeout_s=300)


def _jax_topk(fn, q, e, n_valid, k, mesh, **kw):
    v, i = fn(jnp.asarray(q), jnp.asarray(e), n_valid, k, mesh, **kw)
    return np.asarray(v), np.asarray(i)


def _same_on_every_rank(results, pick):
    first = pick(results[0])
    for r in results[1:]:
        for a, b in zip(first, pick(r)):
            assert torch.equal(a, b)
    return [x.numpy() for x in first]


# ------------------------------------------------------------ top-k
def test_sharded_dense_topk_matches_jax(ranks, inputs):
    results = ranks
    q, e = inputs["dense"]
    jv, ji = _jax_topk(j_sharded_dense_topk, q, e, 1000, 7, j_make_mesh(dp=1))
    v, i = _same_on_every_rank(results, lambda r: r[0]["by_k"][7]["dense"])
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-5)


def test_sharded_dense_topk_tie_break_across_shards(ranks, inputs):
    results = ranks
    q, e = inputs["tie"]
    _, ji = _jax_topk(j_sharded_dense_topk, q, e, 1024, 5, j_make_mesh(dp=1))
    _, i = _same_on_every_rank(results, lambda r: r[1]["by_k"][5]["dense"])
    np.testing.assert_array_equal(i[0], np.arange(5))
    np.testing.assert_array_equal(i, ji)


def test_sharded_refined_topk_matches_jax(ranks, inputs):
    results = ranks
    q, e = inputs["refined"]
    jv, ji = _jax_topk(j_sharded_refined_topk, q, e, 2000, 7, j_make_mesh(dp=1))
    v, i = _same_on_every_rank(results, lambda r: r[2]["by_k"][7]["refined"])
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    assert all(r[2]["by_k"][7]["certified"] for r in results)   # the exact stage


@pytest.mark.parametrize("k", [300, 3000])
def test_sharded_refined_topk_large_k_matches_jax(ranks, inputs, k):
    """k 300 (JAX's case) and k 3000 > N, where both pad with NEG_INF, ids 0."""
    results = ranks
    q, e = inputs["refined"]
    jv, ji = _jax_topk(j_sharded_refined_topk, q, e, 2000, k, j_make_mesh(dp=1), margin=4)
    v, i = _same_on_every_rank(results, lambda r: r[3]["by_k"][k]["refined"])
    assert v.shape == i.shape == (4, k)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    if k > 2048:
        assert (v[:, 2048:] == NEG_INF).all() and (i[:, 2048:] == 0).all()


def test_sharded_topk_2level_matches_jax(ranks, inputs):
    """The port's {slice 2, corpus 2} against JAX's {slice 2, corpus 4}."""
    results = ranks
    q, e = inputs["two_level"]
    mesh = j_make_mesh(n_devices=8, dp=2, axis_names=(J_SLICE, "corpus"))
    emb = jax.device_put(jnp.asarray(e), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec((J_SLICE, "corpus"), None)))
    jv, ji = j_sharded_topk_2level(jnp.asarray(q), emb, 1024 - 100, 7, mesh)
    v, i = _same_on_every_rank(results, lambda r: r[4]["by_k"][7]["two_level"])
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5)
    scores = q @ e.T
    scores[:, 1024 - 100:] = NEG_INF
    np.testing.assert_array_equal(i, np.argsort(-scores, axis=1, kind="stable")[:, :7])


# ------------------------------------------------------------ the graph
def test_sharded_hybrid_search_matches_jax(ranks, inputs):
    results = ranks
    jres = j_hybrid_search_batch(inputs["jgt"], jnp.asarray(inputs["q_film"]),
                                 JSearchWeights.create(), top_k=5, member_top_m=5)
    for r in results:
        res = r[5]["search"]
        assert r[5]["emb_rows"] == inputs["jgt"].emb.shape[0] // RANKS
        np.testing.assert_array_equal(res.reranked_idx.numpy(), np.asarray(jres.reranked_idx))
        np.testing.assert_array_equal(res.seed_idx.numpy(), np.asarray(jres.seed_idx))
        np.testing.assert_allclose(res.reranked_score.numpy(),
                                   np.asarray(jres.reranked_score), rtol=0, atol=1e-6)


def _flat_rollouts(inputs):
    tgt = convert.graph_tensors_from_numpy(inputs["leaves"], device="cpu")
    w = SearchWeights.create(device="cpu")
    learner = tppo.PPOLearner(OBS_DIM, 6, tppo.PPOConfig(epochs=1), seed=PPO_SEED,
                              device="cpu")
    q = torch.from_numpy(inputs["q_ppo"])
    trajs = [tv.rollout_batch(tgt, q[2 * d:2 * d + 2], learner.model, w, max_steps=3,
                              generator=torch.Generator().manual_seed(PPO_SEED + d))[0]
             for d in range(2)]
    return learner, trajs


def test_sharded_train_step_rollouts_equal_the_unsharded_ones(ranks, inputs):
    results = ranks
    _, trajs = _flat_rollouts(inputs)
    for rank, r in enumerate(results):
        dp = rank // 2                                  # mesh {dp 2, corpus 2}
        got, want = r[5]["traj"], trajs[dp]
        assert r[5]["dp_seed"] == PPO_SEED + dp
        for f in ("actions", "rewards", "dones", "mask"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        torch.testing.assert_close(got.obs, want.obs, rtol=0, atol=1e-6)
        torch.testing.assert_close(got.logps, want.logps, rtol=0, atol=1e-6)


def test_sharded_train_step_is_one_adam_step_on_the_global_loss(ranks, inputs):
    """The gradient the step applied equals that of ``ppo_loss`` of both dp
    rows' trajectories concatenated, weighted by the global live mask, and
    the updated parameters equal one Adam step on it. (The clip to norm 1
    and Adam's first step hide a uniform scale error in the dp sum from the
    parameters; the gradient shows it.)"""
    results = ranks
    learner, trajs = _flat_rollouts(inputs)
    cat = tv.Trajectory(*(torch.cat(x) for x in zip(*trajs)))
    adv, ret = tppo.gae_device(cat.rewards, cat.values, cat.dones, cat.mask)
    learner.opt.zero_grad()
    _, aux = tppo.ppo_loss(learner.model, learner.cfg, cat.obs.reshape(-1, OBS_DIM),
                           cat.actions.reshape(-1), cat.logps.reshape(-1), ret.reshape(-1),
                           adv.reshape(-1), weight=cat.mask.reshape(-1).float())
    _.backward()
    want_grads = {k: p.grad.clone() for k, p in learner.model.named_parameters()}
    learner.opt.step()
    want = learner.model.state_dict()
    for r in results:
        m = r[5]["metrics"]
        torch.testing.assert_close(torch.stack([m["policy_loss"], m["value_loss"],
                                                m["entropy"]]), aux, rtol=1e-6, atol=1e-6)
        assert r[5]["grads"].keys() == want_grads.keys()
        for name, g in r[5]["grads"].items():
            torch.testing.assert_close(g, want_grads[name], rtol=0, atol=1e-6)
        for name, p in r[5]["params"].items():
            torch.testing.assert_close(p, want[name], rtol=0, atol=1e-6)


def test_sharded_train_step_runs_on_the_mesh(ranks):
    """JAX's own check: finite metrics, and the parameters changed."""
    results = ranks
    for r in results:
        assert all(np.isfinite(float(v)) for v in r[5]["metrics"].values())
        changed = [not torch.allclose(r[5]["params0"][k], v) for k, v in r[5]["params"].items()]
        assert any(changed)
        for k, v in r[5]["params"].items():              # one update on every rank
            assert torch.equal(v, results[0][5]["params"][k])


# ------------------------------------------------------------ MiniLM, processes
def test_minilm_tensor_parallel_matches_jax(ranks, inputs):
    results = ranks
    enc, texts, _, _ = inputs["minilm"]
    base = enc.encode(texts)
    for r in results:
        np.testing.assert_allclose(r[6].numpy(), base, rtol=2e-4, atol=2e-5)


def test_initialize_in_a_single_process_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.process_info() == {"process_index": 0, "process_count": 1,
                                          "local_devices": 1, "global_devices": 1}


def test_initialize_in_a_rank_returns_true_and_process_info(ranks):
    results = ranks
    for rank, r in enumerate(results):
        assert r[7] is True
        assert r[8] == {"process_index": rank, "process_count": RANKS,
                        "local_devices": RANKS, "global_devices": RANKS}


# ------------------------------------------------------------ the binned stage
@pytest.fixture(scope="module")
def binned(tmp_path_factory):
    """The binned local stage forced on the CPU (the plain ``dense_binmax``),
    4 x 65,536 x 64 float32, k 5: clustered rows, and the same with 4,096
    copies of row 0 that every query lies next to (the certificate fails)."""
    calls = [(programs.binned_program,
              (functools.partial(programs.ladder, BINNED_N, 64, 8, 5, "float32", dup), 5,
               BINNED_N - 1000, "cpu")) for dup in (0, 4096)]
    return spawn(programs.several, RANKS, calls,
                 init_file=str(tmp_path_factory.mktemp("rdv") / "init"), timeout_s=300)


@pytest.mark.parametrize("case,certified", [(0, True), (1, False)],
                         ids=["certified", "fallback"])
def test_binned_local_stage_matches_the_flat_ranking(binned, case, certified):
    q, e = programs.ladder(BINNED_N, 64, 8, 5, "float32", 4096 * case, torch.device("cpu"))
    rv, ri = dense_topk_ref(q, e, BINNED_N - 1000, 5)
    for r in binned:
        got = r[case]
        assert got["certified"] is certified     # every rank took the same branch
        assert torch.equal(got["ids"], ri)
        torch.testing.assert_close(got["vals"], rv, rtol=1e-5, atol=0)
    if not certified:
        assert torch.equal(ri, torch.arange(5).expand(8, 5))   # ties to the lowest ids


# ------------------------------------------------------------ the dry run
def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    t0 = time.perf_counter()
    summary = entry.dryrun_multichip(4, device="cpu")
    seconds = time.perf_counter() - t0
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh={'dp': 2, 'corpus': 2}" in out
    assert summary["nodes"] == 133376
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    assert seconds < 90, seconds


def test_entry_forward_runs_on_the_cpu():
    fn, args = entry.entry(device="cpu")
    vals, ids = fn(*args)
    assert vals.shape == ids.shape == (2, 10)
    assert bool(torch.isfinite(vals).all())
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())


def test_entry_forward_matches_jax_on_the_same_weights():
    """``entry()``'s forward with flax's MiniLM weights against the JAX
    package's ``__graft_entry__.entry()``: the same corpus, tokens, top-10."""
    import __graft_entry__ as graft
    jfn, jargs = graft.entry()
    jv, ji = jax.jit(jfn)(*jargs)
    fn, args = entry.entry(device="cpu")
    args[0].load_state_dict(convert.flax_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jargs[0])))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(args[3].numpy(), np.asarray(jargs[3]))
    vals, ids = fn(*args)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=2e-5)
