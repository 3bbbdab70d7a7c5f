"""The port's span reader against the JAX package's, on the CPU: features,
training data, the model at the checkpoint's full width, the ensemble
answerer, the answer generator with a reader, and training steps.

Inputs are the repo's frozen v5 items (``samples/synth_v5_test.jsonl``, read
as ``tools/calibrate_reader.py`` reads them), the shipped checkpoints
(``checkpoints/reader.msgpack``, ``reader_b.msgpack``) and seeded draws.

Tolerances: features, training arrays, gold spans and identity-dropout draws
equal; a narrow random reader's logits within 1e-5; the full-width reader's
logits on evidence positions within 5e-5, because at logits of up to 26
JAX's own float32 forward lies 1.1e-5 from the float64 forward of the same
weights (the port's 7.4e-6), so two float32 summation orders may differ by
their sum; answers equal and confidences within 1e-5; training losses
within 1e-5 relatively and gradients within 1e-6 of JAX's; the optimizer,
given JAX's gradients, within 1e-6 of optax's parameters.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ahrag_tpu.answer import generator as jgen
from ahrag_tpu.answer import reader as jreader
from ahrag_tpu.answer.extractive import _clean_sentences
from ahrag_tpu.models.reader import data as jdata
from ahrag_tpu.models.reader import features as jf
from ahrag_tpu.models.reader.model import SpanReader as JReader
from ahrag_tpu.models.reader.train import _loss_fn as jloss
from ahrag_tpu_torch.answer import generator as tgen
from ahrag_tpu_torch.answer import reader as treader
from ahrag_tpu_torch.convert import flax_params_from_numpy
from ahrag_tpu_torch.models.reader import data as tdata
from ahrag_tpu_torch.models.reader import features as tf
from ahrag_tpu_torch.models.reader import train as ttrain
from ahrag_tpu_torch.models.reader.model import SpanReader
from ahrag_tpu_torch.utils import flax_msgpack

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "checkpoints" / "reader.msgpack")
ENSEMBLE = f"{CKPT};{ROOT / 'checkpoints' / 'reader_b.msgpack'}"
V5_TEST = ROOT / "samples" / "synth_v5_test.jsonl"


def v5_items(n: int):
    return [json.loads(ln) for ln in V5_TEST.read_text().splitlines() if ln.strip()][:n]


def context_text(item) -> str:
    return "\n".join(f"[DETAIL:p{i}] " + " ".join(para)
                     for i, para in enumerate(item["context"]["sentences"]))


def flax_reader(d_model, n_layers, d_ff, n_heads, seed=0):
    model = JReader(d_model=d_model, n_layers=n_layers, d_ff=d_ff, n_heads=n_heads)
    z = jnp.zeros((1, jf.SEQ_LEN), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), z, z,
                        jnp.zeros((1, jf.SEQ_LEN, jf.N_SCALARS)), z,
                        z.astype(bool), z.astype(bool))
    return model, params


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def v5_batch():
    """32 v5 TEST items featurized by the JAX package."""
    return jf.stack([jf.featurize(it["question"], _clean_sentences(context_text(it)))[0]
                     for it in v5_items(32)])


@pytest.fixture(scope="module")
def readers():
    return (jreader.ReaderAnswerer(ENSEMBLE, min_conf=0.0),
            treader.ReaderAnswerer(ENSEMBLE, min_conf=0.0, device="cpu"))


def test_featurize_equals_jax_on_v5_items():
    for it in v5_items(32):
        sents = _clean_sentences(context_text(it))
        jb, jev = jf.featurize(it["question"], sents)
        tb, tev = tf.featurize(it["question"], sents)
        for f in jf.FeatureBatch._fields:
            a, b = getattr(jb, f), getattr(tb, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert tuple(jev) == tuple(tev)
        s = np.random.default_rng(3).standard_normal(jf.E_LEN).astype(np.float32)
        e = np.random.default_rng(4).standard_normal(jf.E_LEN).astype(np.float32)
        assert jf.best_span(s, e, jev) == tf.best_span(s, e, tev)
        i, j, _ = tf.best_span(s, e, tev)
        assert jf.decode_span(jev, i, j) == tf.decode_span(tev, i, j)
    assert (tf.Q_LEN, tf.E_LEN, tf.SEQ_LEN, tf.N_SCALARS, tf.WORD_VOCAB, tf.STEM_VOCAB) == \
        (32, 320, 352, 20, 32768, 16384)


def test_build_training_arrays_byte_equal():
    jfb, (js, je) = jdata.build_training_arrays(64, seed=7)
    tfb, (ts, te) = tdata.build_training_arrays(64, seed=7)
    for f in jf.FeatureBatch._fields:
        assert getattr(jfb, f).tobytes() == getattr(tfb, f).tobytes(), f
    assert js.tobytes() == ts.tobytes() and je.tobytes() == te.tobytes()


def test_narrow_random_reader_logits_match_flax(v5_batch):
    model, params = flax_reader(32, 1, 64, 2, seed=5)
    ts = SpanReader(d_model=32, n_layers=1, d_ff=64, n_heads=2, device="cpu")
    ts.load_state_dict(flax_params_from_numpy(to_numpy(params)))
    js, je = jax.jit(model.apply)(params, *[jnp.asarray(x) for x in v5_batch])
    with torch.no_grad():
        ps, pe = ts(*[torch.from_numpy(x) for x in v5_batch])
    for a, b in ((js, ps), (je, pe)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


def test_full_width_checkpoint_logits_match_flax(v5_batch):
    """``checkpoints/reader.msgpack`` at its curve file's width (d 256, 8
    heads, 3 layers, d_ff 512, 14,261,762 parameters), read by the port's
    msgpack reader and by flax."""
    meta = json.loads((ROOT / "checkpoints" / "reader_curve.json").read_text())
    model, params = flax_reader(meta["d_model"], meta["n_layers"], meta["d_ff"],
                                meta["n_heads"])
    params = serialization.from_bytes(params, pathlib.Path(CKPT).read_bytes())
    ts = SpanReader.from_checkpoint(CKPT, device="cpu")
    assert sum(p.numel() for p in ts.parameters()) == meta["n_params"] == 14261762
    ref = flax_params_from_numpy(to_numpy(params))
    assert ref.keys() == ts.state_dict().keys()
    for k, v in ts.state_dict().items():
        assert torch.equal(v, ref[k]), k
    js, je = jax.jit(model.apply)(params, *[jnp.asarray(x) for x in v5_batch])
    with torch.no_grad():
        ps, pe = ts(*[torch.from_numpy(x) for x in v5_batch])
    ev = v5_batch.ev_mask
    for a, b in ((js, ps), (je, pe)):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b[ev], a[ev], rtol=0, atol=5e-5)
        assert np.array_equal(b[~ev], a[~ev])          # finfo(float32).min outside


def test_reader_answerer_matches_jax_ensemble(readers):
    jr, tr = readers
    for it in v5_items(16):
        sents = _clean_sentences(context_text(it))
        (ja, jc), (ta, tc) = jr.answer(it["question"], sents), tr.answer(it["question"], sents)
        assert ta == ja and abs(tc - jc) <= 1e-5, (it["question"], ja, ta)
        assert tr.hi_conf_for(ta or "") == jr.hi_conf_for(ja or "")
    assert tr.hi_conf_by_shape == jr.hi_conf_by_shape and tr.hi_conf == jr.hi_conf
    assert treader.select_evidence("Who wrote X?", ["A b.", "", "C d."], 4) == \
        jreader.select_evidence("Who wrote X?", ["A b.", "", "C d."], 4)
    for q in ("In what year did X win?", "Who mentored Y?", "Which city is Z in?"):
        assert treader.expected_shape(q) == jreader.expected_shape(q)
    for a in ("1987", "Rosa Novak", "painter", "12", ""):
        assert treader.answer_shape(a) == jreader.answer_shape(a)


@pytest.mark.parametrize("mode", [{"reader_only": True}, {}], ids=["reader_only", "arbitrated"])
def test_generator_with_reader_matches_jax(mode):
    cfg = {"reader_ckpt": ENSEMBLE, "reader_min_conf": 0.25, **mode}
    for it in v5_items(16):
        ctx = {"context_text": context_text(it), "used_nodes": ["n:0", "n:1"]}
        assert tgen.AnswerGenerator(device="cpu").generate(it["question"], ctx, cfg) == \
            jgen.AnswerGenerator().generate(it["question"], ctx, cfg)


def test_get_reader_caches_and_refuses_missing_checkpoint(tmp_path):
    assert treader.get_reader("", device="cpu") is None
    assert treader.get_reader(ENSEMBLE, 0.3, device="cpu") is \
        treader.get_reader(ENSEMBLE, 0.3, device="cpu")
    with pytest.raises(FileNotFoundError):
        treader.get_reader(str(tmp_path / "missing.msgpack"), device="cpu")
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\x81\xa6params\xc0")
    with pytest.raises((TypeError, ValueError, AttributeError, RuntimeError)):
        treader.get_reader(str(bad), device="cpu")


def test_reader_cache_keeps_the_two_used_last(tmp_path):
    """``_cached_reader`` holds two readers, as the JAX package's
    ``lru_cache(maxsize=2)`` does: a third checkpoint evicts the first. The
    bare ``locked_cache`` users stay unbounded."""
    from ahrag_tpu_torch import native
    from ahrag_tpu_torch.ops import _build, topk
    paths = []
    for i in range(3):
        model = SpanReader(d_model=16, n_heads=2, n_layers=1, d_ff=32, seed=i, device="cpu")
        torch.save({"params": model.state_dict()}, tmp_path / f"r{i}.pt")
        (tmp_path / f"r{i}_curve.json").write_text(json.dumps(
            {"d_model": 16, "n_layers": 1, "d_ff": 32, "n_heads": 2}))
        paths.append(str(tmp_path / f"r{i}.pt"))
    treader._cached_reader.cache_clear()
    assert treader._cached_reader.cache_info().maxsize == 2
    first, second, third = (treader.get_reader(p, device="cpu") for p in paths)
    assert len({id(first), id(second), id(third)}) == 3
    assert treader._cached_reader.cache_info().currsize == 2
    assert treader.get_reader(paths[2], device="cpu") is third
    assert treader.get_reader(paths[1], device="cpu") is second
    again = treader.get_reader(paths[0], device="cpu")
    assert again is not first and again._model.config.d_model == 16
    assert treader._cached_reader.cache_info().currsize == 2
    treader._cached_reader.cache_clear()
    for bare in (native.load_library, _build.load_library, topk.matmul_eps, topk.binmax_eps):
        assert bare.cache_info().maxsize is None, bare.__name__


def _jax_step(model, params, tx, opt_state, data, starts, ends, take, key):
    """The body of the JAX trainer's scanned step, as written there (its
    gradient jitted, as the trainer jits the whole step)."""
    key, k1, k2, k3, k4 = jax.random.split(key, 5)
    mb = {f: data[f][take] for f in ttrain.FIELDS}
    shape = mb["word_ids"].shape
    mb["word_ids"] = jnp.where(jax.random.bernoulli(k1, 0.3, shape),
                               jax.random.randint(k2, shape, 0, jf.WORD_VOCAB), mb["word_ids"])
    mb["stem_ids"] = jnp.where(jax.random.bernoulli(k3, 0.15, shape),
                               jax.random.randint(k4, shape, 0, jf.STEM_VOCAB), mb["stem_ids"])
    grad_fn = jax.jit(lambda p, b, s, e: jax.value_and_grad(jloss, has_aux=True)(
        p, model, b, s, e))
    (loss, acc), grads = grad_fn(params, mb, starts[take], ends[take])
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, key, float(loss), grads, mb


def test_train_steps_match_jax():
    """Three steps of the trainer (warmup 1 of 3, so the schedule moves) from
    flax's initial parameters and the same index rows: the dropout draws
    equal, losses equal within 1e-5 relatively, first-step gradients within
    1e-6, and the port's adamw fed JAX's gradients within 1e-6 of optax's
    parameters after every step."""
    fb, (gs, ge) = jdata.build_training_arrays(64, seed=7)
    steps, batch, lr, seed = 3, 8, 3e-3, 7
    model, init = flax_reader(32, 1, 64, 2, seed=seed)
    warmup = min(200, max(1, steps // 4))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.05),
                     weight_decay=1e-4)
    data = {f: jnp.asarray(getattr(fb, f)) for f in ttrain.FIELDS}
    idx = ttrain.minibatch_index(seed, 64, batch, steps)
    rng = np.random.default_rng(seed)
    assert np.array_equal(idx, np.stack([rng.permutation(64)[:batch] for _ in range(steps)]))

    port = SpanReader(d_model=32, n_layers=1, d_ff=64, n_heads=2, device="cpu")
    port.load_state_dict(flax_params_from_numpy(to_numpy(init)))
    shadow = SpanReader(d_model=32, n_layers=1, d_ff=64, n_heads=2, device="cpu")
    shadow.load_state_dict(flax_params_from_numpy(to_numpy(init)))
    opt = ttrain.make_optimizer(port, lr, steps)
    shadow_opt = ttrain.make_optimizer(shadow, lr, steps)
    tdata_ = ttrain.to_device(fb, slice(0, 64), "cpu")
    starts, ends = torch.from_numpy(gs), torch.from_numpy(ge)

    params, opt_state = init, tx.init(init)
    jkey, tkey = jax.random.PRNGKey(seed * 100003), ttrain.jax_random.prng_key(seed * 100003)
    for n, take in enumerate(idx):
        _, wm, wr, sm, sr = ttrain.identity_dropout(tkey, (batch, jf.SEQ_LEN))
        params, opt_state, jkey, jl, grads, mb = _jax_step(
            model, params, tx, opt_state, data, jnp.asarray(gs), jnp.asarray(ge), take, jkey)
        base = fb.word_ids[take]
        assert np.array_equal(np.asarray(mb["word_ids"]), np.where(wm, wr, base))
        assert np.array_equal(np.asarray(mb["stem_ids"]), np.where(sm, sr, fb.stem_ids[take]))
        if n == 0:   # gradients at flax's initial parameters
            port.zero_grad()
            t_mb = {f: tdata_[f][torch.from_numpy(take.astype(np.int64))] for f in ttrain.FIELDS}
            t_mb["word_ids"] = torch.from_numpy(np.array(mb["word_ids"]))
            t_mb["stem_ids"] = torch.from_numpy(np.array(mb["stem_ids"]))
            loss, _ = ttrain.loss_fn(port, t_mb, starts[take], ends[take])
            loss.backward()
            g = flax_params_from_numpy(to_numpy(grads))
            for name, p in port.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), g[name].numpy(), rtol=0, atol=1e-6)
        tkey, tl, _ = ttrain.train_step(port, opt, tdata_, starts, ends, take, tkey)
        assert abs(float(tl) - jl) <= 1e-5 * abs(jl), (n, float(tl), jl)
        g = flax_params_from_numpy(to_numpy(grads))
        for name, p in shadow.named_parameters():
            p.grad = g[name].clone()
        shadow_opt.step()
        ref = flax_params_from_numpy(to_numpy(params))
        for name, v in shadow.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"step {n}: {name}")


def test_trainer_writes_a_checkpoint_the_answerer_reads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    meta = ttrain.train(n_train=32, n_val=8, batch=4, steps=2, scan_len=1, seed=3,
                        out="ckpt/reader_port", d_model=16, n_layers=1, n_heads=2,
                        device="cpu")
    assert [c["step"] for c in meta["curve"]] == [1, 2] and meta["backend"] == "cpu"
    assert json.loads((tmp_path / "ckpt" / "reader_port_curve.json").read_text())["d_ff"] == 32
    loaded = SpanReader.from_checkpoint("ckpt/reader_port.pt", device="cpu")
    assert loaded.config.d_model == 16 and loaded.config.d_ff == 32
    ans = treader.ReaderAnswerer("ckpt/reader_port.pt", min_conf=0.0, device="cpu")
    it = v5_items(1)[0]
    text, conf = ans.answer(it["question"], _clean_sentences(context_text(it)))
    assert text is None or isinstance(text, str)
    assert 0.0 <= conf <= 1.0


def test_msgpack_reader_matches_flax_on_the_checkpoint():
    tree = flax_msgpack.restore(pathlib.Path(CKPT).read_bytes())
    ref = serialization.msgpack_restore(pathlib.Path(CKPT).read_bytes())
    a, b = flax_params_from_numpy(tree), flax_params_from_numpy(ref)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
