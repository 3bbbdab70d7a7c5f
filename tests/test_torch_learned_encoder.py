"""The port's learned encoders against the JAX package's, on the CPU: the
contrastive encoder's tokenization, pair data, hybrid vectors and training
step; MiniLM's forward and its HuggingFace weight mapping; ``create_encoder``;
a learned-encoder graph saved and loaded; and the single-stage service over a
learned graph large enough (n_pad 5,120) that one-query searches run the plain
``dense_binmax``.

Inputs: the sample corpus's lines (``chip_smoke.corpus_lines``), the shipped
``checkpoints/encoder.msgpack``, seeded draws and a tiny safetensors file the
test writes with numpy.

Tolerances: ids, pairs and service ids equal; vectors within 1e-5 (measured
3e-7: float32 products in another order); InfoNCE losses within 1e-5
relatively, gradients within 1e-6 and the port's adam fed JAX's gradients
within 1e-6 of optax's parameters (a full step is not compared leaf by leaf:
the attention's key biases, to which the loss is invariant, get gradients
that are rounding noise, and Adam scales noise to a full step).
"""
import json
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ahrag_tpu.graph.host import HierarchicalGraph as JHG
from ahrag_tpu.models.encoder import contrastive as jc
from ahrag_tpu.models.encoder import create_encoder as jcreate
from ahrag_tpu.models.encoder.minilm import MiniLMConfig as JMC
from ahrag_tpu.models.encoder.minilm import MiniLMEncoder as JME
from ahrag_tpu.serve import RetrievalService as JRS
from ahrag_tpu_torch.agent.optim import Adam
from ahrag_tpu_torch.convert import flax_params_from_numpy
from ahrag_tpu_torch.graph.host import HierarchicalGraph as THG
from ahrag_tpu_torch.models.encoder import contrastive as tc
from ahrag_tpu_torch.models.encoder import create_encoder
from ahrag_tpu_torch.models.encoder.base import Encoder
from ahrag_tpu_torch.models.encoder.minilm import MiniLMConfig as TMC
from ahrag_tpu_torch.models.encoder.minilm import MiniLMEncoder as TME
from ahrag_tpu_torch.models.encoder.minilm import read_safetensors
from ahrag_tpu_torch.ops import binmax, topk
from ahrag_tpu_torch.serve import RetrievalService as TRS
from chip_smoke import corpus_graph, corpus_lines, sample_questions

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENC_CKPT = str(ROOT / "checkpoints" / "encoder.msgpack")
CFG = {"encoder": {"learned_weights": ENC_CKPT}}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def texts():
    return corpus_lines()[:64]


@pytest.fixture(scope="module")
def encoders():
    return jc.ContrastiveEncoder(ENC_CKPT), tc.ContrastiveEncoder(ENC_CKPT, device="cpu")


def test_tokenization_and_pairs_equal(texts):
    for a, b in zip(jc.encode_batch_ids(texts), tc.encode_batch_ids(texts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jc.make_pairs(300, seed=11) == tc.make_pairs(300, seed=11)
    assert jc.build_clusters() == tc.build_clusters()
    assert jc._ids("Rosa Novak's early years") == tc._ids("Rosa Novak's early years")


@pytest.mark.parametrize("fitted", [False, True], ids=["gaussian", "lsa"])
def test_contrastive_encode_matches_jax(encoders, texts, fitted):
    je, te = encoders
    assert te.dim == je.dim == 768 and te.name == je.name == "learned"
    kw = {}
    if fitted:
        df = je.document_frequencies(texts)
        assert np.array_equal(df, te.document_frequencies(texts))
        idf = (np.log((1.0 + len(texts)) / (1.0 + df)) + 1.0).astype(np.float32)
        basis = je.fit_projection(texts, idf=idf)
        np.testing.assert_allclose(te.fit_projection(texts, idf=idf), basis, rtol=0, atol=1e-5)
        kw = {"idf": idf, "basis": basis}
    ref = je.encode(texts, **kw)
    np.testing.assert_allclose(te.encode(texts, **kw), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(te.encode_device(texts, **kw).numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(te.encode(texts, dtype=torch.float64, **kw), ref,
                               rtol=0, atol=1e-5)
    assert te.encode([]).shape == (0, 768)


def test_info_nce_step_matches_jax():
    """Two adam steps of the contrastive trainer (batch 16 of 64 pairs, a
    narrow encoder) from flax's initial parameters and the same key."""
    n_pairs, batch, temp, lr, seed = 64, 16, 0.07, 3e-3, 3
    va, vb = jc.make_pairs(n_pairs, seed=seed)
    arrays = jc.encode_batch_ids(va) + jc.encode_batch_ids(vb)
    model = jc._make_model(32, 1, 24)
    z = jnp.zeros((1, jc.SEQ), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), z, z, jnp.zeros((1, jc.SEQ), bool))
    tx = optax.adam(lr)
    opt_state = tx.init(params)
    data = tuple(jnp.asarray(x) for x in arrays)

    @jax.jit
    def grads_at(params, idx):
        def loss_fn(p):
            za = model.apply(p, data[0][idx], data[1][idx], data[2][idx])
            zb = model.apply(p, data[3][idx], data[4][idx], data[5][idx])
            logits = za @ zb.T / temp
            labels = jnp.arange(batch)
            l1 = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
            l2 = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean()
            return (l1 + l2) / 2
        return jax.value_and_grad(loss_fn)(params)

    port = tc.SentEncoder(32, 1, 24, device="cpu")
    port.load_state_dict(flax_params_from_numpy(to_numpy(params)))
    shadow = tc.SentEncoder(32, 1, 24, device="cpu")
    shadow.load_state_dict(flax_params_from_numpy(to_numpy(params)))
    opt, shadow_opt = Adam(port.parameters(), lr), Adam(shadow.parameters(), lr)
    tdata = [torch.from_numpy(x) for x in arrays]
    jkey, tkey = jax.random.PRNGKey(seed + 1), tc.jax_random.prng_key(seed + 1)
    for step in range(2):
        jkey, k1 = jax.random.split(jkey)
        idx = jax.random.randint(k1, (batch,), 0, n_pairs)
        loss, grads = grads_at(params, idx)
        g = flax_params_from_numpy(to_numpy(grads))
        if step == 0:
            port.zero_grad()
            ti = torch.from_numpy(np.asarray(idx).astype(np.int64))
            tl, _ = tc.info_nce(port, [x[ti] for x in tdata[:3]], [x[ti] for x in tdata[3:]],
                                temp)
            tl.backward()
            for name, p in port.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), g[name].numpy(), rtol=0, atol=1e-6)
        tkey, tl, _ = tc.train_step(port, opt, tdata, tkey, batch, temp)
        assert abs(float(tl) - float(loss)) <= 1e-5 * abs(float(loss))
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        for name, p in shadow.named_parameters():
            p.grad = g[name].clone()
        shadow_opt.step()
        ref = flax_params_from_numpy(to_numpy(params))
        for name, v in shadow.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=0, atol=1e-6)


def test_contrastive_trainer_writes_what_the_encoder_reads(tmp_path, texts):
    meta = tc.train(n_pairs=64, steps=2, batch=8, d_model=16, n_layers=1, out_dim=8,
                    seed=3, out=str(tmp_path / "enc"), device="cpu")
    assert meta["backend"] == "cpu" and meta["n_params"] > 0
    enc = tc.ContrastiveEncoder(str(tmp_path / "enc.pt"), device="cpu")
    out = enc.encode(texts[:4])
    assert out.shape == (4, 8 + 384)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=0, atol=1e-5)


def test_minilm_matches_flax_at_the_default_width(texts):
    je = JME(seed=0)
    te = TME(device="cpu")
    te.model.load_state_dict(flax_params_from_numpy(to_numpy(je.params)))
    assert sum(p.numel() for p in te.model.parameters()) == \
        sum(x.size for x in jax.tree_util.tree_leaves(je.params))
    ids, mask = te._tokenize(texts)
    jids, jmask = je._tokenize(texts)
    assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
    np.testing.assert_allclose(te.encode(texts), je.encode(texts), rtol=0, atol=1e-5)
    assert (te.name, te.dim) == (je.name, je.dim) == ("minilm-flax-l6-h384", 384)
    with pytest.raises(ValueError, match="transformers"):
        TME(tokenizer_path="tok", device="cpu")


def _write_safetensors(path, tensors):
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name], np.float32)
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        blobs.append(a.tobytes())
    header["__metadata__"] = {"format": "pt"}
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def _tiny_bert(prefix: str):
    rng = np.random.default_rng(4)
    h, inter = 8, 16
    sd = {"embeddings.word_embeddings.weight": (64, h),
          "embeddings.position_embeddings.weight": (16, h),
          "embeddings.token_type_embeddings.weight": (2, h),
          "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,)}
    for i in range(2):
        lp = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[lp + name + ".weight"], sd[lp + name + ".bias"] = (h, h), (h,)
        sd[lp + "intermediate.dense.weight"] = (inter, h)
        sd[lp + "intermediate.dense.bias"] = (inter,)
        sd[lp + "output.dense.weight"], sd[lp + "output.dense.bias"] = (h, inter), (h,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[lp + ln + ".weight"], sd[lp + ln + ".bias"] = (h,), (h,)
    return {prefix + k: rng.standard_normal(s).astype(np.float32) * 0.5 for k, s in sd.items()}


@pytest.mark.parametrize("prefix", ["", "bert."], ids=["plain", "bert_prefix"])
def test_load_hf_weights_matches_jax(tmp_path, prefix):
    pytest.importorskip("safetensors")
    tensors = _tiny_bert(prefix)
    path = str(tmp_path / "model.safetensors")
    _write_safetensors(path, tensors)
    read = read_safetensors(path)
    assert read.keys() == tensors.keys()
    assert all(np.array_equal(read[k].numpy(), tensors[k]) for k in tensors)
    kw = dict(vocab_size=64, hidden=8, layers=2, heads=2, intermediate=16,
              max_positions=16, type_vocab=2, max_len=8)
    je, te = JME(JMC(**kw), seed=1), TME(TMC(**kw), seed=1, device="cpu")
    rng = np.random.default_rng(3)     # ids inside the tiny vocabulary, one row padded
    ids = rng.integers(1, 64, size=(3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[1, 5:], ids[1, 5:] = 0, 0

    def port_forward():
        with torch.no_grad():
            return te.model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    before = port_forward()
    je.load_hf_weights(path)
    te.load_hf_weights(path)
    after = port_forward()
    assert not np.allclose(before, after)
    ref = np.asarray(je.model.apply({"params": je.params}, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(after, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["hashed", "learned", "minilm"])
def test_create_encoder_builds_each_name_as_jax(name):
    enc = create_encoder(CFG, name=name, device="cpu")
    ref = jcreate(CFG, name=name)
    assert isinstance(enc, Encoder)
    assert (enc.name, enc.dim) == (ref.name, ref.dim)
    assert create_encoder(CFG, name=name, device="cpu") is enc
    assert enc.encode(["a film by Tim Burton"]).shape == (1, ref.dim)


def test_learned_graph_saved_and_loaded_back(tmp_path):
    lines = corpus_lines()[:40]
    th = corpus_graph_of(THG(encoder_name="learned", device="cpu"), lines)
    th.build_vector_index(layers=(0, 1, 2))
    assert th.vector_index["model"] == "learned" and th._lsa is not None
    th.save(str(tmp_path / "port"))
    back = THG.load(str(tmp_path / "port"), device="cpu")
    assert back._encoder().name == "learned" and back.tensors().dim == 768
    assert torch.equal(back.tensors().emb, th.tensors().emb)
    qs = sample_questions(4)
    assert [r["node_id"] for q in qs for r in back.search(q)] == \
        [r["node_id"] for q in qs for r in th.search(q)]
    jh = corpus_graph_of(JHG(encoder_name="learned"), lines)
    jh.build_vector_index(layers=(0, 1, 2))
    jh.save(str(tmp_path / "jax"))
    from_jax = THG.load(str(tmp_path / "jax"), device="cpu")
    assert [r["node_id"] for q in qs for r in from_jax.search(q)] == \
        [r["node_id"] for q in qs for r in jh.search(q)]


def corpus_graph_of(hg, lines):
    ents = [hg.add_entity(f"entity {i}", ln) for i, ln in enumerate(lines)]
    s = hg.add_summary(0, "Topic 0", " ".join(lines[:2]))
    for e in ents:
        hg.add_belongs_to(e, s)
    return hg


@pytest.fixture(scope="module")
def learned_services(tmp_path_factory):
    """The sample corpus as a learned-encoder graph (4,122 nodes, n_pad
    5,120, D 768), built and saved by the JAX package, loaded by the port."""
    jh = corpus_graph(JHG(encoder_name="learned"))
    jh.build_vector_index(layers=(0, 1, 2))
    d = tmp_path_factory.mktemp("learned")
    jh.save(str(d))
    th = THG.load(str(d), device="cpu")
    js, ts = JRS(hg=jh), TRS(hg=th, device="cpu")
    yield js, ts
    js.close()
    ts.close()


def test_single_stage_service_matches_jax(learned_services):
    js, ts = learned_services
    assert ts.gt.n_pad == 5120 and ts.gt.dim == 768 and not ts._hashed
    qs = sample_questions(16)
    got, ref = ts.search_many(qs), js.search_many(qs)
    assert [[r["node_id"] for r in row] for row in got] == \
        [[r["node_id"] for r in row] for row in ref]
    for row, jrow in zip(got, ref):
        for a, b in zip(row, jrow):
            assert abs(a["score"] - b["score"]) <= 1e-4 and a["node_type"] == b["node_type"]
    for q, jrow in zip(qs[:4], ref[:4]):
        assert [r["node_id"] for r in ts.search(q)] == [r["node_id"] for r in jrow]
    assert "search_batch_warmup" in ts.timers.snapshot()


def test_card_seed_path_at_the_learned_shape(learned_services, monkeypatch):
    """The seed stage the card runs for these searches (the bin-max path at
    tile_n 1024, D 768 float32, B 1 and 16, which launches ``dense_binmax``)
    through its plain versions on the CPU: the same seeds as the CPU's
    flat exact top-k."""
    _, ts = learned_services
    gt = ts.gt
    calls = []
    plain = binmax.dense_binmax_ref
    monkeypatch.setattr(binmax, "dense_binmax_ref",
                        lambda *a, **kw: calls.append(a[0].shape) or plain(*a, **kw))
    q = ts.hg.encode_query_device(sample_questions(16))
    mask = gt.indexed & gt.valid
    for b in (1, 16):
        vals, idx, _ = topk.binned_refined_topk(q[:b], gt.emb, mask, 5, margin=12, tile_n=1024,
                                                select="hier")
        ref_vals, ref_idx = topk.refined_masked_topk(q[:b], gt.emb, mask, 5, margin=12)
        assert torch.equal(idx, ref_idx)
        np.testing.assert_allclose(vals.numpy(), ref_vals.numpy(), rtol=0, atol=1e-6)
    assert {(1, 768), (16, 768)} <= {tuple(s) for s in calls}   # beside binmax_eps's own
