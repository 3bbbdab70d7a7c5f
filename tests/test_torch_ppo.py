"""The port's policy networks, GAE, PPO and BC updates and checkpoints
against the JAX package's (flax + optax), on the same parameters and data.

Parameters cross from flax to torch through ``convert.policy_params_from_numpy``.
Tolerances: forwards and updated parameters within 1e-5 (float32 products
and reductions in another order, then Adam steps on them), GAE within 1e-6;
a port step composed by hand must equal ``make_train_step`` exactly (the
same operations on the same device).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import tests.helpers as helpers
from ahrag_tpu.agent import ppo as jppo
from ahrag_tpu.agent.bc import train_bc as jax_train_bc
from ahrag_tpu.models.policy import nets as jnets
from ahrag_tpu_torch import convert
from ahrag_tpu_torch.agent import bc as tbc
from ahrag_tpu_torch.agent import ppo as tppo
from ahrag_tpu_torch.agent import vec_env as tv
from ahrag_tpu_torch.agent.featurizer import OBS_DIM
from ahrag_tpu_torch.agent.optim import global_norm
from ahrag_tpu_torch.agent.rl_agent import RLPolicyAgent
from ahrag_tpu_torch.models.policy import nets as tnets

ATOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_params(model, jparams):
    ref = convert.policy_params_from_numpy(_np_tree(jparams))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=ATOL, err_msg=k)


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, OBS_DIM)).astype(np.float32)


# ---------------------------------------------------------------- networks
@pytest.mark.parametrize("kind", ["actor_critic", "mlp"])
def test_forward_with_converted_params_matches_flax(kind):
    x = _obs(17)
    if kind == "actor_critic":
        jm, tm = jnets.ActorCritic(n_actions=6), tnets.ActorCritic(OBS_DIM, 6, device="cpu")
    else:
        jm, tm = jnets.MLPPolicy(n_actions=6), tnets.MLPPolicy(OBS_DIM, 6, device="cpu")
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS_DIM)))["params"]
    tm.load_state_dict(convert.policy_params_from_numpy(_np_tree(params)))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,), got if isinstance(got, tuple)
                    else (got,)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["actor_critic", "mlp"])
def test_init_statistics_match_flax(kind):
    """Kernels: std within 5% of fan_in^-1/2 (pooled over 8 seeds, as flax's
    own draws are), |w| within the two-sigma truncation; biases zero; the
    same seed gives the same weights."""
    cls = tnets.ActorCritic if kind == "actor_critic" else tnets.MLPPolicy
    jcls = jnets.ActorCritic if kind == "actor_critic" else jnets.MLPPolicy
    models = [cls(OBS_DIM, 6, seed=s, device="cpu") for s in range(8)]
    flax = [jcls(n_actions=6).init(jax.random.PRNGKey(s), jnp.zeros((1, OBS_DIM)))["params"]
            for s in range(8)]
    for name, layer in models[0].named_children():
        fan_in = layer.in_features
        target = fan_in ** -0.5
        w = torch.cat([getattr(m, name).weight.detach().reshape(-1) for m in models])
        fw = np.concatenate([np.asarray(p[name]["kernel"]).reshape(-1) for p in flax])
        for std in (float(w.std()), float(fw.std())):
            assert abs(std - target) <= 0.05 * target, (name, std, target)
        assert float(w.abs().max()) <= 2 * target / tnets._TRUNC_STD + 1e-6
        assert all(not getattr(m, name).bias.detach().any() for m in models)
    again = cls(OBS_DIM, 6, seed=0, device="cpu")
    for a, b in zip(again.parameters(), models[0].parameters()):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- GAE
def test_gae_device_matches_jax_and_compute_gae():
    rng = np.random.default_rng(0)
    B, T = 24, 7
    rewards = rng.standard_normal((B, T)).astype(np.float32)
    values = rng.standard_normal((B, T)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[:3] = (1, T, 2)
    mask = np.arange(T)[None, :] < lengths[:, None]
    dones = (rng.random((B, T)) < 0.2) & mask
    dones[np.arange(B), lengths - 1] |= lengths < T
    ja, jr = jppo.gae_device(*(jnp.asarray(x) for x in (rewards, values, dones, mask)))
    ta, tr = tppo.gae_device(*(torch.from_numpy(x) for x in (rewards, values, dones, mask)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    for b in range(B):
        L = lengths[b]
        ca, cr = jppo.compute_gae(rewards[b, :L], values[b, :L], dones[b, :L])
        pa, pr = tppo.compute_gae(rewards[b, :L], values[b, :L], dones[b, :L])
        np.testing.assert_array_equal(pa, ca)
        np.testing.assert_array_equal(pr, cr)
        np.testing.assert_allclose(ta[b, :L].numpy(), ca, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr[b, :L].numpy(), cr, rtol=0, atol=1e-6)
        assert not ta[b, L:].any() and not tr[b, L:].any()


# ----------------------------------------------------------------- updates
def _ppo_data(scale: float, n=80, seed=1, model=None):
    """(obs, actions, old_logp, returns, adv); returns sit ``scale`` away
    from ``model``'s values when it is given, from 0 otherwise."""
    rng = np.random.default_rng(seed)
    obs = _obs(n, seed)
    ret = (scale * rng.standard_normal(n)).astype(np.float32)
    if model is not None:
        with torch.no_grad():
            ret += model(torch.from_numpy(obs))[1].numpy()
    return (obs, rng.integers(0, 6, n), np.full(n, -1.8, np.float32), ret,
            (scale * rng.standard_normal(n)).astype(np.float32))


def _first_minibatch_norm(learner, data, seed):
    obs, act, logp, ret, adv = (torch.from_numpy(np.asarray(x)) for x in data)
    b = torch.from_numpy(np.random.default_rng(seed).permutation(len(obs))[:learner.cfg.batch_size])
    loss, _ = tppo.ppo_loss(learner.model, learner.cfg, obs[b], act[b], logp[b], ret[b], adv[b])
    grads = torch.autograd.grad(loss, list(learner.model.parameters()))
    return float(global_norm(grads))


@pytest.mark.parametrize("scale,clipped", [(30.0, True), (0.01, False)])
def test_ppo_update_matches_jax(scale, clipped):
    """Two epochs of minibatch updates from the same params, data and seed;
    one case's gradients are clipped by the global norm, the other's not."""
    cfg = tppo.PPOConfig(epochs=2, batch_size=32)
    jl = jppo.PPOLearner(OBS_DIM, 6, jppo.PPOConfig(epochs=2, batch_size=32), seed=0)
    tl = tppo.PPOLearner(OBS_DIM, 6, cfg, device="cpu")
    tl.model.load_state_dict(convert.policy_params_from_numpy(_np_tree(jl.params)))
    data = _ppo_data(scale, model=tl.model)
    assert (_first_minibatch_norm(tl, data, 3) > 1.0) == clipped
    jloss = jl.update(*data, seed=3)
    tloss = tl.update(*data, seed=3)
    _assert_params(tl.model, jl.params)
    assert set(tloss) == set(jloss) == {"policy", "value", "entropy"}
    for k in jloss:
        assert abs(tloss[k] - jloss[k]) <= ATOL * max(1.0, abs(jloss[k])), (k, tloss, jloss)


def _write_trajectories(path, n_traj=30, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_traj):
            steps = [{"action": int(rng.integers(0, 6)), "reward": 0.1,
                      "obs_vec": rng.normal(size=OBS_DIM).tolist()} for _ in range(4)]
            f.write(json.dumps({"query": "q", "steps": steps}) + "\n")
        f.write("not json\n")


def test_bc_training_matches_jax(tmp_path, monkeypatch):
    """``train_bc`` from flax's initial params (the port's MLPPolicy loaded
    with them) gives flax + optax's final params and loss history."""
    traj = tmp_path / "traj.jsonl"
    _write_trajectories(traj)
    jrep = jax_train_bc(str(traj), str(tmp_path / "bc.msgpack"), epochs=3, batch_size=32,
                        seed=4)
    jparams = serialization.msgpack_restore((tmp_path / "bc.msgpack").read_bytes())["params"]
    init = jnets.MLPPolicy(n_actions=6).init(jax.random.PRNGKey(4),
                                             jnp.zeros((1, OBS_DIM)))["params"]

    def flax_init_policy(in_dim, n_actions, seed=0, device=None):
        m = tnets.MLPPolicy(in_dim, n_actions, device=device)
        m.load_state_dict(convert.policy_params_from_numpy(_np_tree(init)))
        return m

    monkeypatch.setattr(tbc, "MLPPolicy", flax_init_policy)
    trep = tbc.train_bc(str(traj), str(tmp_path / "bc.pt"), epochs=3, batch_size=32, seed=4,
                        device="cpu")
    assert trep["n_samples"] == jrep["n_samples"] == 120
    np.testing.assert_allclose(trep["history"], jrep["history"], rtol=0, atol=ATOL)
    apply_fn, meta = tbc.load_bc(str(tmp_path / "bc.pt"), device="cpu")
    assert meta == {"in_dim": OBS_DIM, "n_actions": 6}
    x = _obs(5)
    ref = jnets.MLPPolicy(n_actions=6).apply({"params": jparams}, jnp.asarray(x))
    np.testing.assert_allclose(apply_fn(x).numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_bc_step_matches_optax():
    """One BC step: cross-entropy with integer labels and optax.adam."""
    x, y = _obs(32), np.random.default_rng(2).integers(0, 6, 32)
    jm = jnets.MLPPolicy(n_actions=6)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))["params"]
    tx = optax.adam(1e-3)
    state = tx.init(params)
    tm = tnets.MLPPolicy(OBS_DIM, 6, device="cpu")
    tm.load_state_dict(convert.policy_params_from_numpy(_np_tree(params)))
    opt = tbc.Adam(tm.parameters(), 1e-3)
    for _ in range(3):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y)).mean()
        jloss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state)
        params = optax.apply_updates(params, updates)
        tloss = tbc.bc_step(tm, opt, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= ATOL
    _assert_params(tm, params)


@pytest.fixture(scope="module")
def film():
    hg = helpers.build_film_graph()
    hg.build_vector_index(layers=(0, 1, 2))
    from tests.test_torch_agent import _pair
    _, tgt = _pair(hg.tensors())
    q = np.array(hg.encode_query(["Who directed Ed Wood?", "American directors",
                                  "Doctor Strange film", "Tim Burton"]))
    return tgt, torch.from_numpy(q)


def test_train_step_equals_its_parts_composed_by_hand(film):
    tgt, q = film
    w = tv.SearchWeights.create(device="cpu")
    a = tppo.PPOLearner(OBS_DIM, 6, device="cpu")
    b = tppo.PPOLearner(OBS_DIM, 6, device="cpu")
    step = tppo.make_train_step(a, w, max_steps=4)
    for s in range(2):
        metrics = step(tgt, q, generator=torch.Generator().manual_seed(s))
        traj, _ = tv.rollout_batch(tgt, q, b.model, w, max_steps=4,
                                   generator=torch.Generator().manual_seed(s))
        adv, ret = tppo.gae_device(traj.rewards, traj.values, traj.dones, traj.mask)
        b.opt.zero_grad()
        loss, aux = tppo.ppo_loss(b.model, b.cfg, traj.obs.reshape(-1, OBS_DIM),
                                  traj.actions.reshape(-1), traj.logps.reshape(-1),
                                  ret.reshape(-1), adv.reshape(-1),
                                  weight=traj.mask.reshape(-1).float())
        loss.backward()
        b.opt.step()
        assert torch.equal(torch.stack([metrics["policy_loss"], metrics["value_loss"],
                                        metrics["entropy"]]), aux)
        assert bool(torch.isfinite(metrics["mean_ep_reward"]))
        for pa, pb in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(pa, pb)


# ------------------------------------------------------------- checkpoints
def test_jax_checkpoint_converts_to_the_same_forward(tmp_path):
    jl = jppo.PPOLearner(OBS_DIM, 6, seed=5)
    jl.save(str(tmp_path / "ppo.msgpack"))
    payload = serialization.msgpack_restore((tmp_path / "ppo.msgpack").read_bytes())
    tl = tppo.PPOLearner(int(payload["in_dim"]), int(payload["n_actions"]), device="cpu")
    tl.model.load_state_dict(convert.policy_params_from_numpy(payload["params"]))
    x = _obs(9)
    jlog, jval = jl.apply_fn(jl.params, jnp.asarray(x))
    with torch.no_grad():
        tlog, tval = tl.model(torch.from_numpy(x))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0, atol=ATOL)


def test_port_checkpoints_round_trip(tmp_path):
    learner = tppo.PPOLearner(OBS_DIM, 6, tppo.PPOConfig(epochs=1, batch_size=16), seed=2,
                              device="cpu")
    data = _ppo_data(1.0, n=32)
    learner.update(*data, seed=0)
    learner.save(str(tmp_path / "p.pt"))
    loaded = tppo.load_ppo(str(tmp_path / "p.pt"), device="cpu")
    x = torch.from_numpy(_obs(4))
    with torch.no_grad():
        for u, v in zip(learner.model(x), loaded.model(x)):
            assert torch.equal(u, v)
    learner.save_training_state(str(tmp_path / "p.train"), {"next_index": 7, "best": 0.5})
    resumed = tppo.PPOLearner(OBS_DIM, 6, tppo.PPOConfig(epochs=1, batch_size=16), seed=9,
                              device="cpu")
    assert resumed.restore_training_state(str(tmp_path / "p.train")) == {
        "next_index": 7, "best": 0.5}
    assert resumed.opt.count == learner.opt.count
    learner.update(*data, seed=1)
    resumed.update(*data, seed=1)
    for pa, pb in zip(learner.model.parameters(), resumed.model.parameters()):
        assert torch.equal(pa, pb)
    other = tppo.PPOLearner(OBS_DIM + 1, 6, device="cpu")
    with pytest.raises(ValueError):
        other.restore_training_state(str(tmp_path / "p.train"))


# ------------------------------------------------------------------ smoke
def test_act_ppo_respects_mask():
    learner = tppo.PPOLearner(OBS_DIM, 6, device="cpu")
    mask = np.zeros(6, np.float32)
    mask[5] = 1.0
    for s in range(5):
        assert tppo.act_ppo(learner, np.zeros(OBS_DIM, np.float32), mask=mask, seed=s) == 5
    a, logp, value = learner.act_and_logp(np.zeros(OBS_DIM, np.float32), seed=1)
    assert 0 <= a < 6 and logp <= 0.0 and np.isfinite(value)


def test_ppo_train_device_smoke(film, tmp_path):
    tgt, q = film
    learner = tppo.ppo_train_device(tgt, q.numpy()[:2], tv.SearchWeights.create(device="cpu"),
                                    n_updates=2, max_steps=3, batch_size=2,
                                    ppo_cfg=tppo.PPOConfig(epochs=1, batch_size=8),
                                    save_path=str(tmp_path / "ppo_dev.pt"),
                                    log=lambda s: None, curve_out=str(tmp_path / "curve.json"))
    assert (tmp_path / "ppo_dev.pt").exists() and learner.in_dim == OBS_DIM
    curve = json.loads((tmp_path / "curve.json").read_text())
    assert curve["n_updates"] == 2 and len(curve["curve"]) == 2
    assert all(np.isfinite(c["mean_ep_reward"]) for c in curve["curve"])
    assert {"policy", "value", "entropy"} <= set(curve["curve"][0])


def test_train_bc_and_act_smoke(tmp_path):
    traj = tmp_path / "traj.jsonl"
    _write_trajectories(traj)
    report = tbc.train_bc(str(traj), str(tmp_path / "bc.pt"), epochs=2, device="cpu")
    assert report["n_samples"] == 120 and report["final_loss"] > 0
    apply_fn, meta = tbc.load_bc(str(tmp_path / "bc.pt"), device="cpu")
    assert meta == {"in_dim": OBS_DIM, "n_actions": 6}
    assert 0 <= tbc.act_bc(apply_fn, np.zeros(OBS_DIM, np.float32), seed=1) < 6
    (tmp_path / "empty.jsonl").write_text("{}\n")
    with pytest.raises(RuntimeError):
        tbc.load_trajectories(str(tmp_path / "empty.jsonl"))


def test_rl_policy_agent_decides(tmp_path):
    tppo.PPOLearner(OBS_DIM, 6, device="cpu").save(str(tmp_path / "p.pt"))
    agent = RLPolicyAgent(env=None, model_path=str(tmp_path / "p.pt"), device="cpu")
    assert agent.decide({"step": 1, "selection": []}) == {"action": "end_episode",
                                                         "params": {}}
    obs = {"step": 2, "seeds": ["a"], "state": {"selection_ids": [], "frontier_ids": ["a"]},
           "selection": [{"node_id": "a", "node_type": "entity", "score": 0.9},
                         {"node_id": "b", "node_type": "summary", "score": 0.5}]}
    verbs = {agent.decide(obs)["action"] for _ in range(40)}
    assert verbs <= {"expand_parents", "expand_children", "expand_related",
                     "commit_selection", "query_node_details", "end_episode"}
    assert len(verbs) > 1
