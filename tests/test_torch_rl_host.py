"""The port's host training path against the JAX package's, on the CPU: the
gym, ``ppo_train`` and its resume, the RL CLIs (``collect_trajectories``,
``train_rl``, ``train_bc``, ``train_ppo``, ``eval_rl_policy``,
``build_rl_snapshot``, ``rl_transfer``) and the knob policy.

Both packages run over the film graph of ``tests/helpers.py`` (each built by
its own package, or saved by the JAX package and loaded by each CLI). The
samplers differ by design (JAX's key stream against a ``torch.Generator``),
so wherever a policy samples, both packages get the same scripted sampler: the
action is a function of the step's seed and mask only, while log-probs and
values still come from each package's own forward. Where the JAX package
initialises flax parameters, the port starts from the same ones
(``convert.policy_params_from_numpy``).

Tolerances: observations within 1e-6 (float32 scores summed in another
order); rewards, dones, masks, aux, ids, actions, rows, log lines and
progress dicts equal; losses and parameters within 1e-5 (float32 products
and reductions in another order, then Adam steps on them), as in
``tests/test_torch_ppo.py``. The knob policy's features, its choices and its
evaluation are equal; one training step within 1e-5.
"""
import ast
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tests.helpers as helpers
from ahrag_tpu.agent import bc as jbc
from ahrag_tpu.agent import knob_policy as jkp
from ahrag_tpu.agent import ppo as jppo
from ahrag_tpu.agent import rl_agent as jrla
from ahrag_tpu.agent.gym import AHRAGGymEnv as JG
from ahrag_tpu.cli import build_rl_snapshot as jsnap
from ahrag_tpu.cli import collect_trajectories as jct
from ahrag_tpu.cli import eval_rl_policy as jeval
from ahrag_tpu.cli import rl_transfer as jxfer
from ahrag_tpu.cli import train_bc as jtbc
from ahrag_tpu.cli import train_ppo as jtppo
from ahrag_tpu.cli import train_rl as jtrl
from ahrag_tpu.models.policy import nets as jnets
from ahrag_tpu_torch import convert
from ahrag_tpu_torch.agent import bc as tbc
from ahrag_tpu_torch.agent import knob_policy as tkp
from ahrag_tpu_torch.agent import ppo as tppo
from ahrag_tpu_torch.agent import rl_agent as trla
from ahrag_tpu_torch.agent import vec_env as tv
from ahrag_tpu_torch.agent.featurizer import OBS_DIM
from ahrag_tpu_torch.agent.gym import AHRAGGymEnv as TG
from ahrag_tpu_torch.agent.optim import Adam
from ahrag_tpu_torch.cli import build_rl_snapshot as tsnap
from ahrag_tpu_torch.cli import collect_trajectories as tct
from ahrag_tpu_torch.cli import eval_rl_policy as teval
from ahrag_tpu_torch.cli import rl_transfer as txfer
from ahrag_tpu_torch.cli import train_bc as ttbc
from ahrag_tpu_torch.cli import train_ppo as ttppo
from ahrag_tpu_torch.cli import train_rl as ttrl
from ahrag_tpu_torch.graph.search import SearchWeights
from ahrag_tpu_torch.models.policy import nets as tnets
from ahrag_tpu_torch.utils import flax_msgpack
from chip_smoke import SAMPLES
from tests.test_torch_answer import (_fresh_port_llm, _jax_counts_tokens_natively,  # noqa: F401
                                     film)
from tests.test_torch_build import assert_same_build

OBS_TOL = 1e-6
ATOL = 1e-5
QUESTIONS = str(SAMPLES / "mini_questions.jsonl")
HOTPOT = str(SAMPLES / "mini_hotpot.jsonl")
FILM_QUERIES = ["Who directed the film Ed Wood?", "American directors", "Doctor Strange",
                "Tim Burton", "superhero film 2016", "Scott Derrickson horror"]
KNOB_MATRICES = ["knob_rewards_train_r5.json", "knob_rewards_dev_r5.json",
                 "knob_rewards_v6_train_r5.json", "knob_rewards_v6_dev_r5.json"]
KNOB_V6 = str(SAMPLES.parent / "checkpoints" / "knob_policy_v6.msgpack")
REPORTS = SAMPLES.parent / "reports"


@pytest.fixture(autouse=True)
def _cwd(tmp_path, monkeypatch):
    """Both gyms write their session files under the working directory."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def film_dir(tmp_path_factory, film):
    """The JAX package's film graph, saved; every CLI below loads it."""
    d = tmp_path_factory.mktemp("film_graph")
    film[0].save(str(d))
    return str(d)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def assert_params(state_dict, jparams, tol=ATOL):
    ref = convert.policy_params_from_numpy(_np_tree(jparams))
    assert set(state_dict) == set(ref)
    for k in ref:
        np.testing.assert_allclose(state_dict[k].cpu().numpy(), ref[k].numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def run_cli(module, argv, monkeypatch, capsys):
    """A JAX CLI through ``sys.argv``, a port CLI through ``main(argv)``;
    returns what it printed."""
    if module.__name__.startswith("ahrag_tpu_torch."):
        module.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
        module.main()
    return capsys.readouterr().out


# ----------------------------------------------------------- the scripted sampler
def scripted_pick(mask, seed: int) -> int:
    valid = np.flatnonzero(np.asarray(mask, np.float32) > 0.5)
    return int(valid[(7 * seed) % len(valid)])


@pytest.fixture
def scripted(monkeypatch):
    """Both learners start from flax's parameters for their seed and act by
    ``scripted_pick``, with log-probs and values from their own forward.
    Yields the step seeds each package asked for."""
    seeds = {"jax": [], "port": []}

    def j_act(self, obs_vec, mask=None, seed=0):
        seeds["jax"].append(seed)
        logits, value = self.apply_fn(self.params, jnp.asarray(obs_vec.reshape(1, -1)))
        logits = jnp.where(jnp.asarray(mask.reshape(1, -1)) > 0.5, logits, -1e9)
        a = scripted_pick(mask, seed)
        return a, float(jax.nn.log_softmax(logits[0])[a]), float(value[0])

    def t_act(self, obs_vec, mask=None, seed=0):
        seeds["port"].append(seed)
        with torch.no_grad():
            logits, value = self.model(torch.from_numpy(np.asarray(obs_vec, np.float32))
                                       .reshape(1, -1))
            logits = torch.where(torch.from_numpy(mask).reshape(1, -1) > 0.5, logits, -1e9)
        a = scripted_pick(mask, seed)
        return a, float(torch.log_softmax(logits[0], dim=-1)[a]), float(value[0])

    t_init = tppo.PPOLearner.__init__

    def flax_init(self, in_dim, n_actions, cfg=None, seed=0, device=None):
        t_init(self, in_dim, n_actions, cfg, seed=seed, device=device)
        ref = jnets.ActorCritic(n_actions=n_actions).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))["params"]
        self.model.load_state_dict(convert.policy_params_from_numpy(_np_tree(ref)))

    monkeypatch.setattr(jppo.PPOLearner, "act_and_logp", j_act)
    monkeypatch.setattr(tppo.PPOLearner, "act_and_logp", t_act)
    monkeypatch.setattr(tppo.PPOLearner, "__init__", flax_init)
    yield seeds


# ------------------------------------------------------------------ the gym
GYM_CASES = {
    "p0": ("Who directed the film Ed Wood?", [0, 3, 2, 1, 5], False),
    "p1": ("Who directed the film Ed Wood?", [3, 0, 0, 2, 5], False),
    "p2": ("American directors", [1, 2, 3, 4, 5], False),
    "p3": ("Doctor Strange", [4, 3, 1, 0, 5], False),
    "repeat_to_max_steps": ("Tim Burton", [3, 3, 0, 0, 2, 2, 1], False),
    "end": ("superhero film 2016", [5], False),
    "lca": ("Who directed the film Ed Wood?", [6, 3, 6, 2, 4, 5], True),
    "lca_off_is_end": ("Scott Derrickson horror", [1, 6], False),
}


@pytest.mark.parametrize("case", sorted(GYM_CASES))
def test_gym_matches_jax(film, case):
    query, actions, lca = GYM_CASES[case]
    jg = JG(hg=film[0], max_steps=6, include_lca_action=lca)
    tg = TG(hg=film[1], max_steps=6, include_lca_action=lca)
    assert tg.action_size == jg.action_size
    jvec, jinfo = jg.reset(query)
    tvec, tinfo = tg.reset(query)
    np.testing.assert_allclose(tvec, jvec, rtol=0, atol=OBS_TOL)
    assert tinfo["action_mask"] == jinfo["action_mask"] and tinfo["aux"] == jinfo["aux"]
    for a in actions:
        jvec, jr, jd, jinfo = jg.step(a)
        tvec, tr, td, tinfo = tg.step(a)
        np.testing.assert_allclose(tvec, jvec, rtol=0, atol=OBS_TOL, err_msg=f"action {a}")
        assert (tr, td) == (jr, jd), (a, tr, jr, td, jd)
        for key in ("action", "action_mask", "aux", "step"):
            assert tinfo[key] == jinfo[key], (a, key)
        assert ([n["node_id"] for n in tinfo["raw_obs"]["selection"]]
                == [n["node_id"] for n in jinfo["raw_obs"]["selection"]])
        if jd:
            break
    assert jd and td


def test_gym_mask_is_end_only_without_a_selection(film):
    """An observation with no selection allows only end_episode, in both."""
    for G, hg in ((JG, film[0]), (TG, film[1])):
        g = G(hg=hg, include_lca_action=True)
        g.reset("Tim Burton")
        g._last_raw_obs = {**g._last_raw_obs, "selection": []}
        assert g.get_action_mask() == [0, 0, 0, 0, 0, 1, 0]


@pytest.mark.parametrize("actions", [[0, 3, 2, 1], [3, 0, 0, 2], [1, 2, 3, 4], [4, 3, 1, 0]])
def test_gym_matches_the_port_vec_env(film, actions):
    """``TestVecEnvParity`` (tests/test_rl.py) within the port: the host gym
    against ``vec_env.env_reset``/``env_step`` on the same graph, at JAX's
    own tolerances (observations 2e-3, rewards 1e-5)."""
    th = film[1]
    query = "Who directed the film Ed Wood?"
    gt, w = th.tensors(), SearchWeights.create(device="cpu")
    gym = TG(hg=th, max_steps=6)
    hvec, _ = gym.reset(query)
    state = tv.env_reset(gt, th.encode_query_device([query]), w)
    np.testing.assert_allclose(hvec, tv.observe(gt, state)[0].numpy(), atol=2e-3)
    for a in actions:
        hvec, hr, hdone, _ = gym.step(a)
        state, dr, ddone = tv.env_step(gt, state, torch.tensor([a]))
        assert abs(float(dr[0]) - hr) < 1e-5, (a, float(dr[0]), hr)
        assert bool(ddone[0]) == hdone
        np.testing.assert_allclose(hvec, tv.observe(gt, state)[0].numpy(), atol=2e-3,
                                   err_msg=f"action {a}")
        if hdone:
            break


def test_gym_end_and_lca_match_the_port_vec_env(film):
    th = film[1]
    gt, w = th.tensors(), SearchWeights.create(device="cpu")
    state = tv.env_reset(gt, th.encode_query_device(["Tim Burton"]), w)
    state, r, done = tv.env_step(gt, state, torch.tensor([5]))
    assert bool(done[0]) and float(r[0]) == 0.0
    query = "Who directed the film Ed Wood?"
    gym = TG(hg=th, max_steps=6, include_lca_action=True)
    gym.reset(query)
    state = tv.env_reset(gt, th.encode_query_device([query]), w)
    hvec, hr, _, hinfo = gym.step(6)
    state, dr, _ = tv.env_step(gt, state, torch.tensor([6]), enable_lca=True)
    np.testing.assert_allclose(hvec, tv.observe(gt, state)[0].numpy(), atol=2e-3)
    assert abs(float(dr[0]) - hr) < 1e-5
    dev_ids = [th.idx_to_id(int(i)) for i in state.top_ids[0].tolist() if i < gt.n_pad]
    assert dev_ids == hinfo["aux"]["top_node_ids"]


# ----------------------------------------------------------------- ppo_train
def _progress(path: str, port: bool) -> dict:
    if port:
        return torch.load(path, map_location="cpu", weights_only=True)["progress"]
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())["progress"]


def assert_same_logs(tlogs, jlogs):
    """Log lines equal, with each ``loss=`` dict within ``ATOL`` and the
    saved policy's path left out."""
    assert len(tlogs) == len(jlogs), (tlogs, jlogs)
    for t, j in zip(tlogs, jlogs):
        if "loss=" in j:
            (tp, tl), (jp, jl) = t.split("loss="), j.split("loss=")
            assert tp == jp
            tl, jl = ast.literal_eval(tl), ast.literal_eval(jl)
            assert set(tl) == set(jl)
            for k in jl:
                assert abs(tl[k] - jl[k]) <= ATOL, (k, tl[k], jl[k])
        elif j.startswith("Saved PPO policy to "):
            assert t.startswith("Saved PPO policy to ")
        else:
            assert t == j


def train_both(film, tmp, questions, lca=False, runs=({},), **kw):
    """``ppo_train`` in both packages over the same questions, once per entry
    of ``runs`` (extra keywords, e.g. a resume); returns the logs of the last
    run and both learners."""
    out = {}
    for name, G, hg, train, path, extra in (
            ("jax", JG, film[0], jppo.ppo_train, str(tmp / "jax.msgpack"), {}),
            ("port", TG, film[1], tppo.ppo_train, str(tmp / "port.pt"), {"device": "cpu"})):
        for run in runs:
            logs = []
            learner = train(lambda: G(hg=hg, max_steps=kw.get("max_steps", 6),
                                      include_lca_action=lca),
                            questions, save_path=path, log=logs.append,
                            **{**kw, **run, **extra})
        out[name] = (logs, learner, path)
    return out


PPO_CASES = {
    "two_envs": dict(total_episodes=3, n_envs=2, max_steps=3,
                     ppo_cfg=dict(epochs=2, batch_size=4)),
    "early_stop": dict(total_episodes=4, n_envs=1, max_steps=2, early_stop_patience=1,
                       early_stop_min_improve=100.0, ppo_cfg=dict(epochs=1)),
    "lca": dict(total_episodes=2, n_envs=2, max_steps=4, ppo_cfg=dict(epochs=1, batch_size=8),
                lca=True),
}


@pytest.mark.parametrize("case", sorted(PPO_CASES))
def test_ppo_train_matches_jax(film, tmp_path, scripted, case):
    kw = dict(PPO_CASES[case])
    lca = kw.pop("lca", False)
    cfg = kw.pop("ppo_cfg")
    res = train_both(film, tmp_path, FILM_QUERIES, lca=lca, seed=3,
                     ppo_cfg=tppo.PPOConfig(**cfg), **kw)
    (jlogs, jl, jpath), (tlogs, tl, tpath) = res["jax"], res["port"]
    assert_same_logs(tlogs, jlogs)
    assert any("update mavg_ep_reward" in s for s in tlogs)
    if case == "early_stop":
        assert any("early stopping" in s for s in tlogs)
    assert scripted["port"] == scripted["jax"]
    assert_params(tl.model.state_dict(), jl.params)
    assert _progress(tpath + ".train", True) == _progress(jpath + ".train", False)
    saved = tppo.PPOLearner.load(tpath, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(saved.model.state_dict().values(),
                                                  tl.model.state_dict().values()))


def test_ppo_train_resume_matches_jax(film, tmp_path, scripted, monkeypatch):
    """``test_ppo_train_resume``'s scenario (tests/test_profiling_and_resume.py)
    in both packages: 2 episodes, then a resumed run to 4. The port restores
    the saved parameters and Adam state bit for bit; both restart the step
    seeds at ``seed`` (the JAX package's resume, kept)."""
    restored = []
    orig = tppo.PPOLearner.restore_training_state

    def restore(self, path):
        progress = orig(self, path)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        restored.append(all(torch.equal(v, saved["params"][k])
                            for k, v in self.model.state_dict().items())
                        and self.opt.count == saved["opt_state"]["count"]
                        and all(torch.equal(a, b) for a, b in
                                zip(self.opt.mu + self.opt.nu,
                                    saved["opt_state"]["mu"] + saved["opt_state"]["nu"])))
        return progress

    monkeypatch.setattr(tppo.PPOLearner, "restore_training_state", restore)
    qs = ["Who directed Ed Wood?", "American directors", "Doctor Strange", "Tim Burton films"]
    res = train_both(film, tmp_path, qs, max_steps=2, n_envs=1,
                     ppo_cfg=tppo.PPOConfig(epochs=1),
                     runs=({"total_episodes": 2}, {"total_episodes": 4, "resume": True}))
    (jlogs, jl, jpath), (tlogs, tl, tpath) = res["jax"], res["port"]
    assert any("resumed" in s for s in tlogs)
    assert restored == [True]
    assert_same_logs(tlogs, jlogs)
    assert scripted["port"] == scripted["jax"]
    first_run = 2 * 2                    # 2 episodes of 2 steps, then the resume
    assert scripted["port"][first_run] == 1
    assert_params(tl.model.state_dict(), jl.params)
    assert _progress(tpath + ".train", True) == _progress(jpath + ".train", False)


# ------------------------------------------------------------- the RL CLIs
@pytest.fixture
def trajectories(film_dir, tmp_path, monkeypatch, capsys):
    """``collect_trajectories`` (gym route) from both packages: the JAX file
    and the port's."""
    argv = ["--data", QUESTIONS, "--limit", "4", "--graph", film_dir, "--max-steps", "3",
            "--seed", "5"]
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    outs = {"jax": run_cli(jct, argv + ["--out", paths["jax"]], monkeypatch, capsys),
            "port": run_cli(tct, argv + ["--out", paths["port"], "--torch-device", "cpu"],
                            monkeypatch, capsys)}
    return paths, outs


def test_collect_trajectories_matches_jax(trajectories):
    paths, outs = trajectories
    assert outs["port"].replace("port.jsonl", "jax.jsonl") == outs["jax"]
    jt = [json.loads(ln) for ln in open(paths["jax"], encoding="utf-8")]
    tt = [json.loads(ln) for ln in open(paths["port"], encoding="utf-8")]
    assert len(tt) == len(jt) == 4
    for a, b in zip(tt, jt):
        assert a["query"] == b["query"] and len(a["steps"]) == len(b["steps"])
        for sa, sb in zip(a["steps"], b["steps"]):
            assert (sa["action"], sa["reward"], sa["obs_aux"]) == \
                (sb["action"], sb["reward"], sb["obs_aux"])
            np.testing.assert_allclose(sa["obs_vec"], sb["obs_vec"], rtol=0, atol=OBS_TOL)


def test_train_rl_matches_jax(trajectories, tmp_path, monkeypatch, capsys):
    """Action frequencies from the same file, with a line that does not parse
    and a step whose action is not an int: both skipped."""
    src = tmp_path / "mixed.jsonl"
    src.write_text(open(trajectories[0]["jax"]).read() + "not json\n"
                   + '{"steps": [{"action": 2}, {"action": "x"}]}\n')
    res = {}
    for name, mod in (("jax", jtrl), ("port", ttrl)):
        out = str(tmp_path / f"{name}_policy.json")
        printed = run_cli(mod, ["--traj", str(src), "--out", out], monkeypatch, capsys)
        assert printed == f"Saved naive policy to {out}\n"
        res[name] = open(out).read()
    assert res["port"] == res["jax"]
    probs = json.loads(res["port"])["action_probs"]
    assert abs(sum(probs.values()) - 1.0) < 1e-6


@pytest.fixture
def flax_mlp_init(monkeypatch):
    """The port's BC policy starts from flax's parameters for its seed."""
    def mlp(in_dim, n_actions=6, hidden=128, seed=0, device=None):
        m = tnets.MLPPolicy(in_dim, n_actions, hidden, seed=seed, device=device)
        ref = jnets.MLPPolicy(n_actions=n_actions).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))["params"]
        m.load_state_dict(convert.policy_params_from_numpy(_np_tree(ref)))
        return m
    monkeypatch.setattr(tbc, "MLPPolicy", mlp)


def test_train_bc_cli_matches_jax(trajectories, tmp_path, monkeypatch, capsys,
                                  flax_mlp_init):
    reports, paths = {}, {}
    for name, mod, extra in (("jax", jtbc, []), ("port", ttbc, ["--device", "cpu"])):
        paths[name] = str(tmp_path / f"{name}_bc")
        out = run_cli(mod, ["--traj", trajectories[0]["jax"], "--out", paths[name],
                            "--epochs", "3", "--lr", "0.01", *extra], monkeypatch, capsys)
        reports[name] = json.loads(out)
    j, t = reports["jax"], reports["port"]
    assert (t["epochs"], t["n_samples"]) == (j["epochs"], j["n_samples"])
    np.testing.assert_allclose(t["history"], j["history"], rtol=0, atol=ATOL)
    with open(paths["jax"], "rb") as f:
        jparams = serialization.msgpack_restore(f.read())["params"]
    assert_params(torch.load(paths["port"], weights_only=True)["params"], jparams)


@pytest.fixture
def scripted_acts(monkeypatch):
    """``act_ppo`` and ``act_bc`` in both packages (and the PPO agent's
    import of ``act_ppo``) replaced by ``scripted_pick`` (BC: no mask, all six
    actions)."""
    ppo = lambda learner, vec, mask=None, seed=0: scripted_pick(  # noqa: E731
        np.ones(6) if mask is None else mask, seed)
    bc = lambda apply_fn, vec, seed=0: scripted_pick(np.ones(6), seed)  # noqa: E731
    for mod in (jppo, tppo, jrla, trla):
        monkeypatch.setattr(mod, "act_ppo", ppo)
    for mod in (jbc, tbc):
        monkeypatch.setattr(mod, "act_bc", bc)


def _policy_files(tmp_path, trajectories, monkeypatch, capsys):
    """Each package's own policy files: action probabilities (``train_rl``),
    a PPO learner and a BC policy (``train_bc``)."""
    files = {}
    for name, rl, bcm, extra in (("jax", jtrl, jtbc, []), ("port", ttrl, ttbc,
                                                           ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        run_cli(rl, ["--traj", trajectories[0]["jax"], "--out", str(d / "p.json")],
                monkeypatch, capsys)
        run_cli(bcm, ["--traj", trajectories[0]["jax"], "--out", str(d / "bc"),
                      "--epochs", "1", *extra], monkeypatch, capsys)
        if name == "jax":
            jppo.PPOLearner(OBS_DIM, 6).save(str(d / "ppo"))
        else:
            tppo.PPOLearner(OBS_DIM, 6, device="cpu").save(str(d / "ppo"))
        files[name] = d
    return files


@pytest.mark.parametrize("route", ["policy", "random", "ppo", "bc"])
def test_eval_rl_policy_matches_jax(route, film_dir, tmp_path, trajectories, monkeypatch,
                                    capsys, scripted_acts):
    files = _policy_files(tmp_path, trajectories, monkeypatch, capsys)
    rows = {}
    for name, mod, extra in (("jax", jeval, []), ("port", teval, ["--device", "cpu"])):
        d = files[name]
        pick = {"policy": ["--policy", str(d / "p.json")],
                "random": ["--policy", str(d / "none.json")],
                "ppo": ["--ppo-model", str(d / "ppo")],
                "bc": ["--bc-model", str(d / "bc")]}[route]
        out = str(d / "eval.json")
        printed = run_cli(mod, ["--data", QUESTIONS, "--limit", "4", "--graph", film_dir,
                                "--out", out, "--max-steps", "4", "--seed", "2", *pick,
                                *extra], monkeypatch, capsys)
        assert printed == f"Saved eval to {out}\n"
        rows[name] = json.load(open(out))
    assert len(rows["port"]["items"]) == 4
    assert rows["port"] == rows["jax"]


def test_build_rl_snapshot_matches_jax(tmp_path, monkeypatch, capsys):
    """``test_cli.py``'s scenario: mini_hotpot at limit 2. Both snapshots
    equal, ``structure.json`` included, floats within 1e-6 (as
    ``tests/test_torch_build.py`` holds the pipeline)."""
    for name, mod, extra in (("jax", jsnap, []), ("port", tsnap, ["--device", "cpu"])):
        d = tmp_path / name
        out = run_cli(mod, ["--data", HOTPOT, "--limit", "2", "--out-graph", str(d / "graph"),
                            "--artifacts", str(d / "artifacts"), *extra], monkeypatch, capsys)
        assert "Frozen snapshot" in out
    # meta.json names the temporary corpus file, which differs by its path only
    metas = [tmp_path / name / "graph" / "meta.json" for name in ("jax", "port")]
    jmeta, tmeta = (json.load(open(m)) for m in metas)
    assert jmeta.pop("source").endswith(".txt") and tmeta.pop("source").endswith(".txt")
    assert tmeta == jmeta
    metas[1].write_text(metas[0].read_text())
    assert_same_build(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_train_ppo_host_route_matches_jax(film_dir, tmp_path, monkeypatch, capsys, scripted):
    paths = {}
    for name, mod, extra in (("jax", jtppo, []), ("port", ttppo, ["--torch-device", "cpu"])):
        paths[name] = str(tmp_path / f"{name}_ppo")
        run_cli(mod, ["--data", QUESTIONS, "--graph", film_dir, "--episodes", "2",
                      "--envs", "2", "--max-steps", "3", "--epochs", "1",
                      "--out", paths[name], *extra], monkeypatch, capsys)
    assert scripted["port"] == scripted["jax"] and scripted["port"]
    with open(paths["jax"], "rb") as f:
        jparams = serialization.msgpack_restore(f.read())["params"]
    assert_params(torch.load(paths["port"], weights_only=True)["params"], jparams)


@pytest.mark.parametrize("route", ["device", "multi"])
def test_train_ppo_batched_routes(route, film_dir, tmp_path, monkeypatch, capsys):
    """``--device`` (``test_ppo_train_device_smoke``'s sizes) and ``--multi``
    (a fleet of two per-question graphs): the port's sampler is its own, so
    the curves are held to the JAX package's layout, not its numbers."""
    curves = {}
    for name, mod, extra in (("jax", jtppo, []), ("port", ttppo, ["--torch-device", "cpu"])):
        args = (["--data", QUESTIONS, "--graph", film_dir, "--device", "--batch", "2"]
                if route == "device" else ["--data", HOTPOT, "--multi", "--graphs", "2"])
        curve, out = str(tmp_path / f"{name}_curve.json"), str(tmp_path / f"{name}_ppo")
        run_cli(mod, [*args, "--updates", "2", "--max-steps", "3", "--epochs", "1",
                      "--out", out, "--curve-out", curve, *extra], monkeypatch, capsys)
        curves[name] = json.load(open(curve))
    j, t = curves["jax"], curves["port"]
    assert set(t) == set(j) and t["n_updates"] == j["n_updates"] == 2
    assert [set(c) for c in t["curve"]] == [set(c) for c in j["curve"]]
    assert all(np.isfinite(c["mean_ep_reward"]) for c in t["curve"])
    learner = tppo.PPOLearner.load(str(tmp_path / "port_ppo"), device="cpu")
    assert (learner.in_dim, learner.n_actions) == (OBS_DIM, 6)


def test_collect_trajectories_device_route(film_dir, tmp_path, monkeypatch, capsys):
    """``test_collect_trajectories_device_mode``: the batched route writes one
    trajectory per question of live steps only, and BC trains from it."""
    out = str(tmp_path / "traj.jsonl")
    run_cli(tct, ["--data", QUESTIONS, "--limit", "3", "--graph", film_dir, "--out", out,
                  "--max-steps", "3", "--device", "--torch-device", "cpu"], monkeypatch, capsys)
    lines = [json.loads(ln) for ln in open(out).read().splitlines()]
    assert len(lines) == 3
    assert all(1 <= len(t["steps"]) <= 3 for t in lines)
    assert all(len(s["obs_vec"]) == OBS_DIM and 0 <= s["action"] < 6
               for t in lines for s in t["steps"])
    report = tbc.train_bc(out, str(tmp_path / "bc"), epochs=1, device="cpu")
    assert report["n_samples"] == sum(len(t["steps"]) for t in lines)


@pytest.mark.parametrize("case", ["strip_context", "no_name"])
def test_rl_transfer_matches_jax(case, film_dir, tmp_path, monkeypatch, capsys, scripted_acts):
    """Rule against PPO over the film graph: both rows equal to the JAX
    package's (the PPO agent acts by the scripted sampler in both)."""
    data, extra = ((QUESTIONS, ["--strip-context"]) if case == "strip_context" else
                   (str(SAMPLES / "synth_v2_dev.jsonl"), ["--qtypes", "no_name",
                                                          "--strip-context"]))
    reports = {}
    for name, mod, dev in (("jax", jxfer, []), ("port", txfer, ["--device", "cpu"])):
        model = str(tmp_path / f"{name}_ppo")
        if name == "jax":
            jppo.PPOLearner(OBS_DIM, 6).save(model)
        else:
            tppo.PPOLearner(OBS_DIM, 6, device="cpu").save(model)
        out = str(tmp_path / f"{name}.json")
        printed = run_cli(mod, ["--data", data, "--model", model, "--limit", "4", "--graph",
                                film_dir, "--out", out, *extra, *dev], monkeypatch, capsys)
        assert printed.startswith("filtered ")
        reports[name] = json.load(open(out))
    j, t = reports["jax"], reports["port"]
    assert t["n"] == j["n"] and t["n"] > 0
    for key in ("rule", "ppo", "ppo_minus_rule"):
        assert t[key] == j[key], key


# ---------------------------------------------------------------- knob policy
@pytest.mark.parametrize("matrix", KNOB_MATRICES)
def test_featurize_question_matches_jax(matrix):
    items = json.load(open(REPORTS / matrix))["items"]
    assert items
    for it in items:
        np.testing.assert_array_equal(tkp.featurize_question(it["question"]),
                                      jkp.featurize_question(it["question"]))


def _random_tree(rng: np.random.Generator, depth: int = 0):
    kinds = ["int", "float", "str", "array", "none", "bool", "bytes"]
    if depth < 3:
        kinds += ["dict"] * 3 + ["list"]
    kind = kinds[rng.integers(len(kinds))]
    if kind == "dict":
        return {f"k{i}_{rng.integers(1000)}": _random_tree(rng, depth + 1)
                for i in range(int(rng.integers(0, 20)))}
    if kind == "list":
        return [_random_tree(rng, depth + 1) for _ in range(int(rng.integers(0, 18)))]
    if kind == "int":
        return int(rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1,
                               -1, -32, -33, -128, -129, -32769, -2 ** 31 - 1, -2 ** 63]))
    if kind == "float":
        return float(rng.standard_normal())
    if kind == "str":
        return "é" * int(rng.integers(0, 3)) + "x" * int(rng.choice([0, 5, 31, 32, 300, 70000]))
    if kind == "bytes":
        return bytes(rng.integers(0, 256, int(rng.choice([0, 3, 300, 70000]))).astype(np.uint8))
    if kind == "none":
        return None
    if kind == "bool":
        return bool(rng.integers(2))
    dtype = rng.choice(["float32", "float64", "int32", "int64", "uint8", "float16", "bool"])
    shape = tuple(int(s) for s in rng.integers(0, 5, int(rng.integers(0, 4))))
    return np.asarray(rng.standard_normal(shape) * 100).astype(dtype)   # 0-d stays an array


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


@pytest.mark.parametrize("seed", range(6))
def test_flax_msgpack_reader_matches_flax(seed):
    rng = np.random.default_rng(seed)
    tree = {"params": _random_tree(rng), "n": 3, "nested": {"deep": _random_tree(rng)}}
    data = serialization.msgpack_serialize(tree)
    _same_tree(serialization.msgpack_restore(data), flax_msgpack.restore(data))


def test_flax_msgpack_reader_reads_the_v6_policy():
    data = open(KNOB_V6, "rb").read()
    _same_tree(serialization.msgpack_restore(data), flax_msgpack.restore(data))
    assert flax_msgpack.is_msgpack_map(data[:1])
    with pytest.raises(ValueError):
        flax_msgpack.restore(data + b"\x00")
    with pytest.raises(ValueError):
        flax_msgpack.restore(data[:-1])
    with pytest.raises(ValueError, match="extension type 3"):   # a numpy scalar
        flax_msgpack.restore(serialization.msgpack_serialize({"count": np.int32(3)}))


def test_v6_policy_matches_jax_and_its_report():
    """The JAX package's v6 checkpoint read by the port: the same config for
    every v6 question (train and dev), and ``evaluate_policy`` equal to the
    JAX package's and to ``reports/knob_policy_v6_r5.json``."""
    jpred = jkp.load_knob_policy(KNOB_V6)
    tpred = tkp.load_knob_policy(KNOB_V6, device="cpu")
    qs = [it["question"] for m in KNOB_MATRICES[2:] for it in
          json.load(open(REPORTS / m))["items"]]
    assert len(qs) == 240
    assert [tpred(q) for q in qs] == [jpred(q) for q in qs]
    dev = str(REPORTS / "knob_rewards_v6_dev_r5.json")
    got = tkp.evaluate_policy(dev, KNOB_V6, device="cpu")
    assert got == jkp.evaluate_policy(dev, KNOB_V6)
    assert got == json.load(open(REPORTS / "knob_policy_v6_r5.json"))["dev_eval"]


def test_knob_policy_step_matches_jax():
    """One step of ``train_knob_policy`` from flax's initial parameters, with
    the actions JAX's key draws: the port's step through
    ``knob_policy_step``, JAX's through ``train_knob_policy(steps=1)``."""
    seed, lr = 7, 0.05
    matrix = str(REPORTS / "knob_rewards_train_r5.json")
    items = json.load(open(matrix))["items"]
    x = np.stack([jkp.featurize_question(r["question"]) for r in items])
    rewards = np.asarray([[c["f1"] / 100.0 for c in r["configs"]] for r in items], np.float32)
    model = jnets.ActorCritic(n_actions=jkp.N_CONFIGS, hidden=32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, jkp.N_FEATURES)))
    logits, _ = model.apply(params, jnp.asarray(x))
    _, k1 = jax.random.split(jax.random.PRNGKey(seed))
    acts = np.array(jax.random.categorical(k1, logits))

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "kp.msgpack")
        jkp.train_knob_policy(matrix, out, seed=seed, steps=1, lr=lr)
        ref = flax_msgpack.restore(open(out, "rb").read())["params"]
    tm = tnets.ActorCritic(jkp.N_FEATURES, jkp.N_CONFIGS, hidden=32, device="cpu")
    tm.load_state_dict(convert.policy_params_from_numpy(_np_tree(params["params"])))
    cfg = tppo.PPOConfig(lr=lr, entropy_coef=0.02, epochs=1)
    got_acts, mean_r = tkp.knob_policy_step(tm, Adam(tm.parameters(), lr), torch.from_numpy(x),
                                            torch.from_numpy(rewards), cfg,
                                            actions=torch.from_numpy(acts))
    np.testing.assert_array_equal(got_acts.numpy(), acts)
    assert abs(float(mean_r) - float(rewards[np.arange(len(items)), acts].mean())) <= 1e-6
    assert_params(tm.state_dict(), ref)


def test_knob_policy_learns_reward_matrix(tmp_path):
    """``tests/test_knobs.py``'s matrix: who-questions reward config 1,
    year-questions config 2. The port's policy beats the always-default rule
    by 20 F1, and its checkpoint (``torch.save``) loads by its leading
    bytes."""
    names = ["Alva Rein", "Bodin Kells", "Corin Vale", "Doria Lenk"]
    items = []
    for i in range(64):
        if i % 2 == 0:
            q, best = f"Who worked beside {names[i % 4]}?", 1
        else:
            q, best = f"In what year did {names[i % 4]} move away?", 2
        f1s = [30.0] * 6
        f1s[best] = 90.0
        items.append({"id": f"it{i}", "qtype": "t", "question": q,
                      "configs": [{"config": str(c), "f1": f1s[c], "em": 0.0,
                                   "n_retrieved": 5, "retrieved_hash": "x"}
                                  for c in range(6)]})
    matrix = tmp_path / "matrix.json"
    matrix.write_text(json.dumps({"items": items}))
    ckpt = str(tmp_path / "kp.pt")
    stats = tkp.train_knob_policy(str(matrix), ckpt, steps=300, device="cpu")
    assert stats["train_policy_f1"] > stats["train_default_f1"] + 20
    assert not flax_msgpack.is_msgpack_map(open(ckpt, "rb").read(1))
    ev = tkp.evaluate_policy(str(matrix), ckpt, n_boot=200, device="cpu")
    assert ev["ppo_minus_rule"] > 20
    assert ev["ci95"][0] > 0
    pred = tkp.load_knob_policy(ckpt, device="cpu")
    assert pred("Who worked beside Alva Rein?") == tkp.CONFIG_KNOBS[1]
    assert pred("In what year did Corin Vale move away?") == tkp.CONFIG_KNOBS[2]


def test_knob_constants_match_jax():
    assert tkp.CONFIG_KNOBS == jkp.CONFIG_KNOBS
    assert (tkp.N_CONFIGS, tkp.N_FEATURES) == (jkp.N_CONFIGS, jkp.N_FEATURES)
