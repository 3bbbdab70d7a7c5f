"""The port stands alone: it imports nothing of JAX or the JAX package, and
its entry points refuse to slide to the CPU when no card is present."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ahrag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "pydantic", "safetensors",
           "transformers", "ahrag_tpu", "bench")
# the agent's device path: each must be found and imported by the guard below
AGENT_MODULES = ("ahrag_tpu_torch.agent.featurizer", "ahrag_tpu_torch.agent.reward",
                 "ahrag_tpu_torch.agent.vec_env", "ahrag_tpu_torch.agent.optim",
                 "ahrag_tpu_torch.agent.ppo", "ahrag_tpu_torch.agent.bc",
                 "ahrag_tpu_torch.agent.rl_agent", "ahrag_tpu_torch.models.policy.nets",
                 "ahrag_tpu_torch.graph.multi")
# the answer path: each must be found and imported by the guard below
ANSWER_MODULES = ("ahrag_tpu_torch.utils.logging", "ahrag_tpu_torch.utils.tokens",
                  "ahrag_tpu_torch.utils.llm", "ahrag_tpu_torch.utils.parse",
                  "ahrag_tpu_torch.answer", "ahrag_tpu_torch.answer.qa",
                  "ahrag_tpu_torch.answer.extractive", "ahrag_tpu_torch.answer.context",
                  "ahrag_tpu_torch.answer.generator", "ahrag_tpu_torch.agent.environment",
                  "ahrag_tpu_torch.agent.agent", "ahrag_tpu_torch.agent.inference",
                  "ahrag_tpu_torch.baselines", "ahrag_tpu_torch.baselines.naive",
                  "ahrag_tpu_torch.cli.answer", "ahrag_tpu_torch.cli.agent",
                  "ahrag_tpu_torch.cli.env")
# the build pipeline and the benchmark driver: each must be found and imported
BUILD_MODULES = ("ahrag_tpu_torch.schema", "ahrag_tpu_torch.extract",
                 "ahrag_tpu_torch.extract.chunking", "ahrag_tpu_torch.extract.extractor",
                 "ahrag_tpu_torch.ops.kmeans", "ahrag_tpu_torch.aggregate",
                 "ahrag_tpu_torch.aggregate.community", "ahrag_tpu_torch.aggregate.aggregator",
                 "ahrag_tpu_torch.cli.demo", "ahrag_tpu_torch.eval",
                 "ahrag_tpu_torch.eval.retrieval", "ahrag_tpu_torch.eval.judge",
                 "ahrag_tpu_torch.eval.answer_eval", "ahrag_tpu_torch.cli.benchmark",
                 "ahrag_tpu_torch.cli.eval_gate", "ahrag_tpu_torch.agent.fleet",
                 "ahrag_tpu_torch.utils.jax_random")
# the host training path, the synthetic worlds and the clustering eval
RL_HOST_MODULES = ("ahrag_tpu_torch.agent.gym", "ahrag_tpu_torch.agent.knob_policy",
                   "ahrag_tpu_torch.utils.flax_msgpack", "ahrag_tpu_torch.cli.train_ppo",
                   "ahrag_tpu_torch.cli.train_bc", "ahrag_tpu_torch.cli.train_rl",
                   "ahrag_tpu_torch.cli.collect_trajectories",
                   "ahrag_tpu_torch.cli.eval_rl_policy", "ahrag_tpu_torch.cli.build_rl_snapshot",
                   "ahrag_tpu_torch.cli.rl_transfer", "ahrag_tpu_torch.eval.synth",
                   "ahrag_tpu_torch.eval.clustering", "ahrag_tpu_torch.cli.cluster_eval")
# the learned models: the span reader and the contrastive and MiniLM encoders
LEARNED_MODULES = ("ahrag_tpu_torch.models.flax_layers", "ahrag_tpu_torch.models.reader",
                   "ahrag_tpu_torch.models.reader.features", "ahrag_tpu_torch.models.reader.model",
                   "ahrag_tpu_torch.models.reader.data", "ahrag_tpu_torch.models.reader.train",
                   "ahrag_tpu_torch.answer.reader", "ahrag_tpu_torch.models.encoder.base",
                   "ahrag_tpu_torch.models.encoder.contrastive",
                   "ahrag_tpu_torch.models.encoder.minilm")
# multi-device (parallel/), the entry points (entry.py) and the top-k ladder
PARALLEL_MODULES = ("ahrag_tpu_torch.parallel", "ahrag_tpu_torch.parallel.mesh",
                    "ahrag_tpu_torch.parallel.distributed", "ahrag_tpu_torch.parallel.sharded",
                    "ahrag_tpu_torch.parallel.programs", "ahrag_tpu_torch.entry",
                    "ahrag_tpu_torch.cli.topk_bench")

_GUARD = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None          # any import of these now raises
import torch
assert not torch.cuda.is_available(), "this check runs without a card"
import ahrag_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ahrag_tpu_torch.__path__, "ahrag_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
missing = set({agent!r}) - set(mods)
assert not missing, missing
import chip_smoke
import json, os, tempfile
from ahrag_tpu_torch.agent.environment import GraphEnvironment
from ahrag_tpu_torch.cli import agent as cli_agent, answer as cli_answer, env as cli_env
os.chdir(tempfile.mkdtemp())          # anything an entry point writes lands here
with open("ev.json", "w") as f:
    json.dump({{"summaries": [], "entities": []}}, f)
import numpy as np
from ahrag_tpu_torch.graph.tensors import build_graph_tensors
from ahrag_tpu_torch.graph.search import SearchWeights
from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder
from ahrag_tpu_torch.bench_data import build_bench_arrays, bench_tensors
from ahrag_tpu_torch.graph import HierarchicalGraph
from ahrag_tpu_torch.serve import RetrievalService
from ahrag_tpu_torch.agent.ppo import PPOLearner
from ahrag_tpu_torch.models.policy.nets import ActorCritic, MLPPolicy
from ahrag_tpu_torch.aggregate import SemanticAggregator
from ahrag_tpu_torch.agent.fleet import build_question_fleet
from ahrag_tpu_torch.cli import benchmark as cli_benchmark, demo as cli_demo
from ahrag_tpu_torch.cli import eval_gate as cli_gate
from ahrag_tpu_torch.ops.kmeans import spherical_kmeans
from ahrag_tpu_torch.agent.gym import AHRAGGymEnv
from ahrag_tpu_torch.agent.ppo import ppo_train
from ahrag_tpu_torch.agent.bc import train_bc
from ahrag_tpu_torch.agent.knob_policy import load_knob_policy, train_knob_policy
from ahrag_tpu_torch.cli import cluster_eval as cli_cluster, collect_trajectories as cli_collect
from ahrag_tpu_torch.cli import eval_rl_policy as cli_eval_rl, rl_transfer as cli_transfer
from ahrag_tpu_torch.cli import train_bc as cli_bc, train_ppo as cli_ppo
from ahrag_tpu_torch.answer.generator import AnswerGenerator
from ahrag_tpu_torch.answer.reader import ReaderAnswerer, get_reader
from ahrag_tpu_torch.models.reader.model import SpanReader
from ahrag_tpu_torch.models.reader import train as reader_train
from ahrag_tpu_torch.models.encoder import contrastive, create_encoder
from ahrag_tpu_torch.models.encoder.minilm import MiniLMEncoder
from ahrag_tpu_torch import entry
from ahrag_tpu_torch.cli import topk_bench
from ahrag_tpu_torch import native
assert native.available() and native.max_degree(np.array([0, 1, 0]), 2) == 2
assert native.ell_from_edges(np.array([1]), np.array([0]), 2, 2, 8)[1, 0] == 0
assert native.exact_topk(np.eye(2), np.eye(2), 1)[1].tolist() == [[0], [1]]
ckpt = os.path.join({root!r}, "checkpoints", "reader.msgpack")
enc_ckpt = os.path.join({root!r}, "checkpoints", "encoder.msgpack")
ctx = {{"context_text": "[DETAIL:p0] Tim Burton directed Ed Wood.", "used_nodes": []}}
calls = [lambda: SpanReader(), lambda: SpanReader.from_checkpoint(ckpt),
         lambda: ReaderAnswerer(ckpt), lambda: get_reader(ckpt),
         lambda: AnswerGenerator().generate("Who directed Ed Wood?", ctx,
                                            {{"reader_ckpt": ckpt}}),
         lambda: reader_train.train(n_train=4, n_val=2, steps=1, out="reader_out"),
         lambda: reader_train.main(["--n-train", "4", "--steps", "1", "--out", "r_out"]),
         lambda: contrastive.SentEncoder(), lambda: contrastive.ContrastiveEncoder(enc_ckpt),
         lambda: contrastive.get_contrastive_encoder(enc_ckpt),
         lambda: contrastive.train(n_pairs=8, steps=1, batch=4, out="enc_out"),
         lambda: contrastive.main(["--pairs", "8", "--steps", "1", "--out", "e_out"]),
         lambda: entry.entry(), lambda: entry.dryrun_multichip(4),
         lambda: entry.main([]), lambda: topk_bench.run_ladder(4096, 2, 8, 1),
         lambda: topk_bench.main(["--n", "4096"]),
         lambda: MiniLMEncoder(), lambda: create_encoder(name="learned"),
         lambda: create_encoder(name="minilm"),
         lambda: HierarchicalGraph(encoder_name="learned").build_vector_index(),
lambda: AHRAGGymEnv(graph_dir="graph_that_is_not_there"),
         lambda: ppo_train(lambda: AHRAGGymEnv(graph_dir="graph_that_is_not_there"), ["q"]),
         lambda: train_bc("ev.json", "bc_out"),
         lambda: load_knob_policy("ev.json"), lambda: train_knob_policy("ev.json", "kp_out"),
         lambda: cli_cluster.run(50, 2, 0.05, 3),
         lambda: cli_cluster.main(["--n", "50", "--topics", "2"]),
         lambda: cli_collect.main(["--data", "ev.json", "--graph", "graph_that_is_not_there"]),
         lambda: cli_collect.main(["--data", "ev.json", "--graph", "graph_that_is_not_there",
                                   "--device"]),
         lambda: cli_eval_rl.main(["--data", "ev.json", "--graph", "graph_that_is_not_there"]),
         lambda: cli_transfer.main(["--data", "ev.json", "--graph", "graph_that_is_not_there"]),
         lambda: cli_bc.main(["--traj", "ev.json"]),
         lambda: cli_ppo.main(["--data", "ev.json", "--graph", "graph_that_is_not_there"]),
         lambda: cli_ppo.main(["--data", "ev.json", "--graph", "graph_that_is_not_there",
                               "--device"]),
lambda: cli_demo.run_pipeline("corpus_that_is_not_there.txt"),
         lambda: SemanticAggregator(),
         lambda: spherical_kmeans(np.zeros((4, 2), np.float32), 2),
         lambda: cli_benchmark.run_benchmark("local", data_path="ev.json"),
         lambda: build_question_fleet([]),
         lambda: cli_demo.main(["corpus_that_is_not_there.txt", "--no-repl"]),
         lambda: cli_benchmark.main(["--dataset", "local", "--data", "ev.json"]),
         lambda: cli_gate.main(["--dataset", "local", "--data", "ev.json"]),
         lambda: PPOLearner(84, 6), lambda: ActorCritic(84), lambda: MLPPolicy(84),
         lambda: SearchWeights.create(),
         lambda: HashedNGramEncoder(dim=8, buckets=64),
         lambda: bench_tensors(build_bench_arrays(64, 8, d=8), "float32"),
         lambda: HierarchicalGraph(encoder_name="hashed").tensors(),
         lambda: HierarchicalGraph.load("graph_that_is_not_there"),
         lambda: RetrievalService(graph_dir="graph_that_is_not_there"),
         lambda: GraphEnvironment(graph_dir="graph_that_is_not_there"),
         lambda: cli_env.main(["q", "--graph", "graph_that_is_not_there"]),
         lambda: cli_agent.main(["q", "--graph", "graph_that_is_not_there"]),
         lambda: cli_answer.main(["q", "--evidence", "ev.json",
                                  "--graph", "graph_that_is_not_there"])]
for fn in calls:
    try:
        fn()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("an entry point ran without a card and without device='cpu'")
assert os.listdir(".") == ["ev.json"], os.listdir(".")   # refused before writing
print("imported", len(mods), "modules")
"""


def _run(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax_and_refuses_cpu_fallback():
    proc = _run(_GUARD.format(blocked=BLOCKED,
                              agent=AGENT_MODULES + ANSWER_MODULES + BUILD_MODULES
                              + RL_HOST_MODULES + LEARNED_MODULES + PARALLEL_MODULES,
                              root=str(ROOT)), ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path.name} imports {name}"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_NEW_ENTRY_POINTS = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
from ahrag_tpu_torch.models.encoder import create_encoder
from ahrag_tpu_torch.ops import dense_topk, dense_topk_fused
try:
    create_encoder()
except RuntimeError as e:
    assert "CUDA" in str(e), e
else:
    raise AssertionError("create_encoder ran without a card and without device='cpu'")
q, e = torch.zeros(2, 8), torch.zeros(1024, 8)
assert dense_topk(q, e, 1024, 3)[1].shape == (2, 3)     # CPU tensors: the plain path
print("ok")
"""


def test_new_entry_points_refuse_cpu_fallback():
    proc = _run(_NEW_ENTRY_POINTS.format(blocked=BLOCKED), ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok" in proc.stdout


# Where the port may not hold a ``try`` at all: the kernels, the native
# featurizer, the models, every module of the search path, the agent and
# answer modules, and the build pipeline, evaluation and benchmark driver.
NO_TRY = ("ahrag_tpu_torch/ops/", "ahrag_tpu_torch/native/", "ahrag_tpu_torch/models/",
          "ahrag_tpu_torch/device.py", "ahrag_tpu_torch/graph/search.py",
          "ahrag_tpu_torch/graph/tensors.py", "ahrag_tpu_torch/graph/beam.py",
          "ahrag_tpu_torch/bench_data.py", "ahrag_tpu_torch/convert.py", "chip_smoke.py",
          "ahrag_tpu_torch/agent/featurizer.py", "ahrag_tpu_torch/agent/reward.py",
          "ahrag_tpu_torch/agent/vec_env.py", "ahrag_tpu_torch/agent/optim.py",
          "ahrag_tpu_torch/agent/ppo.py", "ahrag_tpu_torch/agent/rl_agent.py",
          "ahrag_tpu_torch/agent/bc.py", "ahrag_tpu_torch/graph/multi.py",
          "ahrag_tpu_torch/graph/host.py", "ahrag_tpu_torch/utils/config.py",
          "ahrag_tpu_torch/utils/logging.py", "ahrag_tpu_torch/utils/tokens.py",
          "ahrag_tpu_torch/answer/", "ahrag_tpu_torch/agent/environment.py",
          "ahrag_tpu_torch/agent/agent.py", "ahrag_tpu_torch/agent/inference.py",
          "ahrag_tpu_torch/baselines/", "ahrag_tpu_torch/cli/answer.py",
          "ahrag_tpu_torch/cli/agent.py", "ahrag_tpu_torch/cli/env.py",
          "ahrag_tpu_torch/schema.py", "ahrag_tpu_torch/extract/",
          "ahrag_tpu_torch/aggregate/", "ahrag_tpu_torch/eval/",
          "ahrag_tpu_torch/cli/demo.py", "ahrag_tpu_torch/cli/benchmark.py",
          "ahrag_tpu_torch/cli/eval_gate.py", "ahrag_tpu_torch/agent/fleet.py",
          "ahrag_tpu_torch/utils/jax_random.py", "ahrag_tpu_torch/agent/gym.py",
          "ahrag_tpu_torch/agent/knob_policy.py", "ahrag_tpu_torch/utils/flax_msgpack.py",
          "ahrag_tpu_torch/cli/train_ppo.py", "ahrag_tpu_torch/cli/train_bc.py",
          "ahrag_tpu_torch/cli/train_rl.py", "ahrag_tpu_torch/cli/collect_trajectories.py",
          "ahrag_tpu_torch/cli/eval_rl_policy.py", "ahrag_tpu_torch/cli/build_rl_snapshot.py",
          "ahrag_tpu_torch/cli/rl_transfer.py", "ahrag_tpu_torch/cli/cluster_eval.py",
          "ahrag_tpu_torch/parallel/", "ahrag_tpu_torch/entry.py",
          "ahrag_tpu_torch/cli/topk_bench.py")
PARSE_CALLS = {"float", "int", "json.loads", "json.load"}
HAND_OFF_SCOPES = {"MicroBatcher", "serve_http"}
# the LLM client's network retry: the one scope where catching any error is
# the function's purpose, and what its handler may call
RETRY_SCOPE = ["LLMClientManager", "_complete"]
RETRY_CALLS = {"_is_rate_limit_error", "max", "float", "random.uniform", "time.sleep"}


def _dotted(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    return ""


def _is_parse_guard(t: ast.Try) -> bool:
    """(a) the body is one ``float``/``int``/``json.loads``/``json.load`` call
    (returned or assigned), every handler names (TypeError, ValueError) and
    yields a constant."""
    if len(t.body) != 1 or not isinstance(t.body[0], (ast.Return, ast.Assign)):
        return False
    call = t.body[0].value
    if not (isinstance(call, ast.Call) and _dotted(call.func) in PARSE_CALLS):
        return False
    for h in t.handlers:
        names = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        if sorted(_dotted(n) for n in names) != ["TypeError", "ValueError"]:
            return False
        if not (len(h.body) == 1 and isinstance(h.body[0], (ast.Return, ast.Assign))
                and isinstance(h.body[0].value, ast.Constant)):
            return False
    return True


def _is_hand_off(t: ast.Try, scopes) -> bool:
    """(b) inside ``MicroBatcher`` or ``serve_http``: each handler only
    publishes the exception to the waiting submitters (``self._publish``) or
    writes an HTTP error response (``self._json`` with a code >= 400), then
    continues, returns or passes."""
    if not HAND_OFF_SCOPES & set(scopes):
        return False
    for h in t.handlers:
        for st in h.body:
            if isinstance(st, (ast.Continue, ast.Pass)) or (
                    isinstance(st, ast.Return) and st.value is None):
                continue
            if not (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)):
                return False
            name = _dotted(st.value.func)
            if name == "self._publish":
                continue
            code = st.value.args[0] if st.value.args else None
            if not (name == "self._json" and isinstance(code, ast.Constant)
                    and isinstance(code.value, int) and code.value >= 400):
                return False
    return True


def _is_network_retry(t: ast.Try, scopes) -> bool:
    """(c) inside ``LLMClientManager._complete``: the body is one assignment
    from ``client.chat.completions.create``, and each handler only records
    the error, computes a wait and sleeps, then retries or stops. No handler
    returns, so a failure reaches the caller as the error itself."""
    body = t.body[0] if len(t.body) == 1 else None
    if not (scopes[-2:] == RETRY_SCOPE and isinstance(body, ast.Assign)
            and isinstance(body.value, ast.Call)
            and _dotted(body.value.func) == "client.chat.completions.create"):
        return False
    for h in t.handlers:
        for sub in ast.walk(h):
            if isinstance(sub, ast.Return):
                return False
            if isinstance(sub, ast.Call) and _dotted(sub.func) not in RETRY_CALLS:
                return False
    return True


def try_faults(source: str, no_try: bool = False) -> list:
    """Every ``try`` of ``source`` that breaks the port's rule, as strings."""
    faults = []

    def visit(node, scopes):
        if isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            where = f"line {node.lineno} in {'.'.join(scopes) or '<module>'}"
            if no_try:
                faults.append(f"{where}: no try is allowed in this file")
            if node.finalbody:
                faults.append(f"{where}: finally")
            for h in node.handlers:
                if h.type is None:
                    faults.append(f"{where}: bare except")
                for sub in ast.walk(h):
                    name = _dotted(sub.func) if isinstance(sub, ast.Call) else ""
                    if (name.endswith("_ref") or name.split(".")[-1] in ("cpu", "to")
                            or (isinstance(sub, ast.Constant) and sub.value == "cpu")):
                        faults.append(f"{where}: the handler falls back ({ast.unparse(sub)})")
            if not (_is_parse_guard(node) or _is_hand_off(node, scopes)
                    or _is_network_retry(node, scopes)):
                faults.append(f"{where}: neither a parse guard, a hand-off nor the "
                              "network retry")
        inner = scopes + [node.name] if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) else scopes
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(ast.parse(source), [])
    return faults


def test_no_try_in_the_port():
    """No kernel falls back to its plain version, and no native call to
    Python, on failure: no ``try`` at all in the kernels, the native code, the
    models, the search path, the agent and answer modules and the build
    pipeline, evaluation and benchmark driver; elsewhere only a
    parse guard (``float``, ``int`` or ``json`` parsing that yields a constant
    on (TypeError, ValueError)), a hand-off of a batch's exception to its
    submitters or to an HTTP error response, or the LLM client's network
    retry. No bare ``except``, no ``finally``, and no handler
    that calls a ``*_ref`` function, names "cpu" or moves a tensor."""
    for path in PORT_FILES:
        rel = str(path.relative_to(ROOT))
        faults = try_faults(path.read_text(), no_try=rel.startswith(NO_TRY))
        assert not faults, f"{rel}: {faults}"


PLANTED = {
    "kernel falls back to its plain version": """
def dense_binmax(q, emb, n_valid, mask):
    try:
        return launch(q, emb)
    except RuntimeError:
        return dense_binmax_ref(q, emb, n_valid, mask)
""",
    "a hand-off scope that falls back": """
class MicroBatcher:
    def _run(self, batch):
        try:
            out = self._stages[0](batch)
        except Exception as exc:
            out = dense_binmax_ref(batch)
""",
    "a parse guard that moves to the CPU": """
def parse(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return x.to("cpu")
""",
    "bare except": """
def parse(x):
    try:
        return int(x)
    except:
        return None
""",
    "the LLM retry answers from its handler": """
class LLMClientManager:
    def _complete(self, client):
        for attempt in range(3):
            try:
                resp = client.chat.completions.create(model="m")
            except Exception as exc:
                return "canned answer", None
""",
    "the LLM retry falls back to a plain version": """
class LLMClientManager:
    def _complete(self, client, q, emb):
        try:
            resp = client.chat.completions.create(model="m")
        except Exception as exc:
            last = dense_binmax_ref(q, emb)
""",
    "the LLM retry moves to the CPU": """
class LLMClientManager:
    def _complete(self, client, x):
        try:
            resp = client.chat.completions.create(model="m")
        except Exception as exc:
            x = x.to("cpu")
            time.sleep(1.0)
""",
    "a retry shape outside the LLM client": """
class RetrievalService:
    def _complete(self, client):
        try:
            resp = client.chat.completions.create(model="m")
        except Exception as exc:
            time.sleep(1.0)
""",
    "a finally that removes the question's corpus file": """
def build_question_graph(context, workdir, encoder_name=None):
    path = write_corpus(context, workdir)
    try:
        hg = run_pipeline(path, encoder_name=encoder_name)
    finally:
        os.unlink(path)
    return hg
""",
    "finally": """
class MicroBatcher:
    def _run(self):
        try:
            self.step()
        except Exception as exc:
            self._publish(0, 1, ("err", exc))
        finally:
            self.cleanup()
""",
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_no_try_rule_catches_a_planted_fallback(name):
    assert try_faults(PLANTED[name]), name


def test_no_try_rule_takes_the_allowed_shapes():
    ok = """
def _float_or_none(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None

class MicroBatcher:
    def _run(self, batch, gen):
        while True:
            try:
                token = self._stages[0](batch)
            except Exception as exc:
                self._publish(gen, len(batch), ("err", exc))
                continue

class LLMClientManager:
    def _complete(self, client, attempts, cfg):
        last_error = None
        for attempt in range(1, attempts + 1):
            try:
                resp = client.chat.completions.create(model="m")
            except Exception as exc:
                last_error = exc
                if attempt >= attempts:
                    break
                wait = cfg["rate_limit_wait"] if _is_rate_limit_error(exc) else 1.0
                wait = max(0.0, float(wait)) * attempt + random.uniform(0, 0.1)
                time.sleep(wait)
                continue
            return resp, None
        return None, last_error
"""
    assert try_faults(ok) == []
    assert try_faults(ok, no_try=True)


def test_signatures_match_the_cuda_launchers():
    """``_build._SIGNATURES`` names every ``extern "C"`` launcher of
    ``csrc/*.cu`` with its argument count, and nothing else."""
    import re
    from ahrag_tpu_torch.ops import _build
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert found, "no extern \"C\" launcher found"
    assert {n: len(a) for n, a in _build._SIGNATURES.items()} == found


# the native runtime's bindings: none may hold a ``try`` or compute without
# the library
NATIVE_BINDINGS = ("available", "ell_from_edges", "max_degree", "exact_topk",
                   "token_estimate", "hash_features_coo", "hash_features_counts")


@pytest.mark.parametrize("name", NATIVE_BINDINGS)
def test_native_binding_falls_under_the_no_try_rule(name):
    """Each binding lives in a file under ``NO_TRY``, holds no ``try`` and
    reaches the library through ``load_library`` on every path: no branch
    of it returns before the library is loaded, except ``available``'s
    answer that there is no compiler."""
    path = ROOT / "ahrag_tpu_torch" / "native" / "__init__.py"
    assert str(path.relative_to(ROOT)).startswith(NO_TRY)
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn)), name
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and _dotted(n.func) == "load_library"]
    assert calls, f"{name} never loads the library"
    first_load = min(c.lineno for c in calls)
    early = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and n.lineno < first_load]
    assert len(early) == (1 if name == "available" else 0), name
