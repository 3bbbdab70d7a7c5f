"""Paraphrase-contrastive sentence encoder (port of
``ahrag_tpu/models/encoder/contrastive.py``).

A small transformer encoder (``SentEncoder``: hashed word and stem
embeddings, pre-LN blocks with 4-head self-attention and a 2d tanh-gelu
feed-forward, LayerNorm epsilon 1e-6, masked mean pooling, a dense
projection, L2 normalisation) trained contrastively so that different
surface realizations of one fact embed nearby. Its training pairs
(``make_pairs``) render one fact frame twice with relation surfaces drawn
from general-vocabulary paraphrase clusters over fresh pseudo entities; the
pair data, the tokenization and the clusters are the JAX package's code,
unchanged.

``ContrastiveEncoder`` is the hybrid embedding the JAX package serves:
``[sqrt(1-w) * paraphrase vector, sqrt(w) * lexical hashed vector]``, so
cosine = w * cos_lex + (1-w) * cos_para (w = 0.5, dim 384 + 384 = 768). The
lexical half is the port's ``HashedNGramEncoder``, with its corpus IDF and
LSA fit. Parameters keep flax's names and shapes
(``models/flax_layers.py``): the JAX checkpoint
(``checkpoints/encoder.msgpack``, architecture in ``encoder_meta.json``)
loads by name, and so does the port's ``torch.save`` file. A fresh model is
drawn from a ``torch.Generator`` (flax's laws, not flax's stream); training
draws its batch indices from JAX's threefry stream (``utils/jax_random.py``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import random
import re
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ahrag_tpu_torch.agent.optim import Adam
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.eval.synth import COUNTRIES, V6_ATTR_VARIANTS
from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder, _fnv1a
from ahrag_tpu_torch.models.flax_layers import (Dense, Embed, LayerNorm,
                                                 MultiHeadAttention, load_params)
from ahrag_tpu_torch.utils import jax_random
from ahrag_tpu_torch.utils.once import locked_cache

DEFAULT_CKPT = "checkpoints/encoder.msgpack"

SEQ = 48
WORD_VOCAB = 32768
STEM_VOCAB = 16384

_TOKEN_RE = re.compile(r"[A-Za-z0-9][\w']*")


def _ids(text: str) -> Tuple[List[int], List[int]]:
    toks = _TOKEN_RE.findall(text.lower())[:SEQ]
    return ([_fnv1a(t.encode()) % WORD_VOCAB for t in toks],
            [_fnv1a(("st:" + t[:4]).encode()) % STEM_VOCAB for t in toks])


def encode_batch_ids(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    w = np.zeros((len(texts), SEQ), np.int32)
    s = np.zeros((len(texts), SEQ), np.int32)
    m = np.zeros((len(texts), SEQ), bool)
    for i, t in enumerate(texts):
        wi, si = _ids(t)
        w[i, :len(wi)] = wi
        s[i, :len(si)] = si
        m[i, :len(wi)] = True
    return w, s, m


# --------------------------------------------------------------- pair data

# generic relation-verb clusters (general English; fact-domain verbs the
# synth grammar and real prose both use). Each inner list is one meaning.
_REL_CLUSTERS = [
    ["directed", "helmed", "oversaw the making of", "was the director of"],
    ["stars", "features", "headlines", "has the leading role in"],
    ["founded", "established", "set up", "brought about", "begun by"],
    ["headquartered in", "based in", "seated in", "has its offices in"],
    ["born in", "came into the world in", "entered the world at",
     "native of"],
    ["works as", "practices as", "earns a living as", "took up the craft of"],
    ["married", "wed", "exchanged vows with", "partner in marriage"],
    ["won", "received", "was honored with", "took home", "accepted"],
    ["mentored", "trained", "guided", "showed the ropes to"],
    ["plays", "performs on", "is often heard on"],
    ["wrote", "authored", "penned", "composed"],
    ["leads", "heads", "runs", "is in charge of"],
    ["released in", "came out in", "reached theaters in",
     "premiered in"],
    ["succeeded", "took over from", "replaced", "picked up the reins from"],
    ["city", "town", "municipality"],
    ["film", "picture", "movie"],
    ["organization", "group", "body", "outfit"],
    ["year", "when"],
]

_PSEUDO_SYL_A = ["bran", "chel", "dorv", "fenn", "gath", "holm", "jarn",
                 "kess", "lorn", "mav", "nord", "pell", "quib", "rost",
                 "sald", "tarn", "ulv", "vess", "wint", "yorv"]
_PSEUDO_SYL_B = ["ack", "eld", "ion", "ova", "une", "ath", "ier", "osk",
                 "ell", "ard"]


def _pseudo(rng: random.Random, cap: bool = True) -> str:
    w = rng.choice(_PSEUDO_SYL_A) + rng.choice(_PSEUDO_SYL_B)
    return w.capitalize() if cap else w


def _name(rng: random.Random) -> str:
    return f"{_pseudo(rng)} {_pseudo(rng)}"


def build_clusters() -> List[List[str]]:
    clusters = [list(c) for c in _REL_CLUSTERS]
    clusters += [[k, v] for k, v in V6_ATTR_VARIANTS.items()]
    clusters += [[c, adj] for c, adj in COUNTRIES]
    return clusters


_TEMPLATES = [
    "{a} {r} {b}.",
    "{b} was {r} {a}.",
    "It was {a} who {r} {b}.",
    "{a}, known widely, {r} {b}.",
    "Records state that {a} {r} {b}.",
    "Who {r} {b}?",
    "Which figure {r} {b}?",
    "{a} is remembered for one thing: {a} {r} {b}.",
]


def make_pairs(n_pairs: int, seed: int = 7) -> Tuple[List[str], List[str]]:
    """n_pairs (viewA, viewB) positives over fresh pseudo entities.

    Both views realize the SAME fact frame; the relation/attribute surface
    is drawn independently per view from one cluster, so the only stable
    cross-view signals are the entity tokens and the cluster identity —
    which is precisely what retrieval needs to survive a vocabulary shift.
    30% of pairs drop the name from view B (descriptor regime: attribute
    words alone must reach the right paragraph).
    """
    rng = random.Random(seed)
    clusters = build_clusters()
    va, vb = [], []
    for _ in range(n_pairs):
        cl = rng.choice(clusters)
        r1, r2 = rng.choice(cl), rng.choice(cl)
        a = _name(rng)
        b = rng.choice([_name(rng), _pseudo(rng),
                        str(1900 + rng.randrange(120))])
        extra = rng.choice(["", f" in {1900 + rng.randrange(120)}",
                            f" near {_pseudo(rng)}"])
        ta = rng.choice(_TEMPLATES[:5])
        sa = ta.format(a=a, r=r1, b=b) + extra
        if rng.random() < 0.3:
            tb = rng.choice(_TEMPLATES[5:7])
            sb = tb.format(r=r2, b=b)
        else:
            tb = rng.choice(_TEMPLATES)
            sb = tb.format(a=a, r=r2, b=b)
        va.append(sa)
        vb.append(sb)
    return va, vb


# ------------------------------------------------------------------ model

class _Block(nn.Module):
    def __init__(self, d: int, gen: torch.Generator) -> None:
        super().__init__()
        self.SelfAttention_0 = MultiHeadAttention(d, 4, gen)
        self.LayerNorm_0 = LayerNorm(d)
        self.Dense_0 = Dense(d, 2 * d, gen)
        self.Dense_1 = Dense(2 * d, d, gen)
        self.LayerNorm_1 = LayerNorm(d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x), mask)
        h = self.Dense_0(self.LayerNorm_1(x))
        return x + self.Dense_1(torch.nn.functional.gelu(h, approximate="tanh"))


class SentEncoder(nn.Module):
    def __init__(self, d_model: int = 192, n_layers: int = 2, out_dim: int = 384,
                 seed: int = 0, device=None) -> None:
        """The sentence encoder on ``device`` (``cuda`` unless the caller
        names another), drawn from a CPU ``torch.Generator`` seeded by
        ``seed`` and then moved."""
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.n_layers = n_layers
        self.Embed_0 = Embed(WORD_VOCAB, d_model, gen)
        self.Embed_1 = Embed(STEM_VOCAB, d_model, gen)
        for i in range(n_layers):
            setattr(self, f"Block_{i}", _Block(d_model, gen))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, out_dim, gen)
        self.to(resolve_device(device))

    def forward(self, word_ids: torch.Tensor, stem_ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """[B, SEQ] ids and mask -> [B, out_dim] unit vectors."""
        x = self.Embed_0(word_ids.long()) + self.Embed_1(stem_ids.long())
        for i in range(self.n_layers):
            x = getattr(self, f"Block_{i}")(x, mask)
        x = self.LayerNorm_0(x)
        mf = mask[..., None].to(x.dtype)
        pooled = (x * mf).sum(1) / torch.clamp(mf.sum(1), min=1.0)
        z = self.Dense_0(pooled)
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def info_nce(model: SentEncoder, a, b, temp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric in-batch InfoNCE of two views ``a`` and ``b`` (each ``(word
    ids, stem ids, mask)``): (loss, in-batch accuracy)."""
    za, zb = model(*a), model(*b)
    logits = za @ zb.T / temp
    labels = torch.arange(logits.shape[0], device=logits.device)
    l1 = torch.nn.functional.cross_entropy(logits, labels)
    l2 = torch.nn.functional.cross_entropy(logits.T, labels)
    acc = (logits.argmax(1) == labels).float().mean()
    return (l1 + l2) / 2, acc


def train_step(model: SentEncoder, opt: Adam, data: Sequence[torch.Tensor], key,
               batch: int, temp: float):
    """One adam step on a batch of pairs drawn as ``jax.random.randint(k1,
    (batch,), 0, n_pairs)`` after ``key, k1 = split(key)``; ``data`` is the
    six [n_pairs, SEQ] tensors (word, stem, mask of view A, then of view B).
    Returns ``(next key, loss, acc)`` as device scalars."""
    key, k1 = jax_random.split(key)
    idx = torch.from_numpy(jax_random.randints(k1, (batch,), 0, int(data[0].shape[0]))
                           .astype(np.int64)).to(data[0].device)
    opt.zero_grad()
    loss, acc = info_nce(model, [x[idx] for x in data[:3]], [x[idx] for x in data[3:]],
                         temp)
    loss.backward()
    opt.step()
    return key, loss.detach(), acc


def pair_tensors(n_pairs: int, seed: int, device) -> List[torch.Tensor]:
    """``make_pairs`` tokenized and on ``device``: [wa, sa, ma, wb, sb, mb]."""
    va, vb = make_pairs(n_pairs, seed=seed)
    return [torch.from_numpy(x).to(device)
            for x in encode_batch_ids(va) + encode_batch_ids(vb)]


def train(n_pairs: int = 98304, steps: int = 3000, batch: int = 512,
          d_model: int = 192, n_layers: int = 2, out_dim: int = 384,
          lr: float = 3e-4, temp: float = 0.07, seed: int = 7,
          out: str = "checkpoints/encoder", device=None) -> dict:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = pair_tensors(n_pairs, seed, dev)
    print(f"[encoder] {n_pairs} pairs featurized in "
          f"{time.perf_counter()-t0:.1f}s", flush=True)
    model = SentEncoder(d_model, n_layers, out_dim, seed=seed, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[encoder] {n_params/1e6:.2f}M params", flush=True)
    opt = Adam(model.parameters(), lr)
    key = jax_random.prng_key(seed + 1)
    t0 = time.perf_counter()
    curve = []
    for i in range(steps):
        key, loss, acc = train_step(model, opt, data, key, batch, temp)
        if (i + 1) % 250 == 0:
            l, a = float(loss), float(acc)
            curve.append({"step": i + 1, "loss": round(l, 4),
                          "inbatch_acc": round(a, 4)})
            print(f"[encoder] step {i+1}/{steps} loss {l:.4f} "
                  f"in-batch acc {a:.3f}", flush=True)
    wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               out + ".pt")
    meta = {"d_model": d_model, "n_layers": n_layers, "out_dim": out_dim,
            "n_params": n_params, "steps": steps, "batch": batch,
            "n_pairs": n_pairs, "temp": temp, "lr": lr, "seed": seed,
            "train_wall_s": round(wall, 1), "curve": curve,
            "backend": dev.type}
    with open(out + "_meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[encoder] done in {wall:.1f}s -> {out}.pt", flush=True)
    return meta


# -------------------------------------------------------------- inference

class ContrastiveEncoder:
    """Encoder-protocol implementation over a trained checkpoint: the
    paraphrase vector of ``SentEncoder`` beside the lexical hashed n-gram
    vector, each scaled so that cosine(z, z') = lex_weight * cos_lex +
    (1 - lex_weight) * cos_para. The lexical half delegates to
    ``HashedNGramEncoder`` (its per-corpus IDF and LSA fit through
    ``document_frequencies`` and ``fit_projection``)."""

    name = "learned"

    def __init__(self, ckpt_path: str = DEFAULT_CKPT, lex_weight: float = 0.5,
                 device=None) -> None:
        """Read ``ckpt_path`` (the JAX package's flax msgpack or the port's
        ``torch.save`` file) and ``<stem>_meta.json`` beside it (d_model 192,
        n_layers 2, out_dim 384 where the file or a key is missing) onto
        ``device`` (``cuda`` unless the caller names another)."""
        self.device = resolve_device(device)
        meta_path = re.sub(r"\.(msgpack|pt)$", "", ckpt_path) + "_meta.json"
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        self._para_dim = int(meta.get("out_dim", 384))
        self._model = SentEncoder(int(meta.get("d_model", 192)),
                                  int(meta.get("n_layers", 2)), self._para_dim,
                                  device=self.device)
        with open(ckpt_path, "rb") as f:
            self._model.load_state_dict(load_params(f.read()))
        self._model.eval()
        self._model64: Optional[SentEncoder] = None
        self._lex = HashedNGramEncoder(device=self.device)
        self._w_lex = float(np.sqrt(lex_weight))
        self._w_para = float(np.sqrt(1.0 - lex_weight))
        self.dim = self._para_dim + self._lex.dim

    # lexical-subspace hooks, delegated so the hybrid inherits the hashed
    # encoder's corpus-adaptive surface (IDF weights and the LSA fit)
    def fit_projection(self, texts: List[str], **kw):
        return self._lex.fit_projection(texts, **kw)

    def document_frequencies(self, texts: List[str], **kw) -> np.ndarray:
        return self._lex.document_frequencies(texts, **kw)

    @torch.no_grad()
    def _para_device(self, texts: List[str], chunk: int = 1024,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Paraphrase vectors [n, para_dim] float32 on the device; ``dtype``
        float64 runs a float64 copy of the model, so that the card and the
        CPU round the same values (the build's entity embeddings)."""
        model = self._model
        if dtype == torch.float64:
            if self._model64 is None:
                self._model64 = copy.deepcopy(self._model).double()
            model = self._model64
        outs = []
        for s in range(0, len(texts), chunk):
            w, st, m = encode_batch_ids(texts[s:s + chunk])
            outs.append(model(*(torch.from_numpy(x).to(self.device)
                                for x in (w, st, m))).float())
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def encode_device(self, texts: List[str], chunk: int = 1024, idf=None,
                      assoc=None, basis=None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[n, dim] float32 on the device: ``[sqrt(1-w) * para, sqrt(w) *
        lex]``, the lexical half weighted by ``idf``, expanded by ``assoc``
        and projected through ``basis`` as the hashed encoder does."""
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        za = self._para_device(texts, chunk, dtype) * self._w_para
        zl = self._lex.encode_device(texts, idf=idf, assoc=assoc, basis=basis,
                                     dtype=dtype) * self._w_lex
        return torch.cat([za, zl], dim=-1)

    def encode(self, texts: List[str], idf=None, assoc=None, basis=None,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
        return self.encode_device(texts, idf=idf, assoc=assoc, basis=basis,
                                  dtype=dtype).cpu().numpy()


def get_contrastive_encoder(ckpt_path: str = DEFAULT_CKPT,
                            device=None) -> Optional[ContrastiveEncoder]:
    """Cached encoder on ``device`` (the cache keeps the two used last, as
    the JAX package's does); None when ``ckpt_path`` does not exist.
    A checkpoint that is there but does not load raises."""
    if not os.path.exists(ckpt_path):
        return None
    return _cached_encoder(ckpt_path, str(resolve_device(device)))


@locked_cache(maxsize=2)
def _cached_encoder(ckpt_path: str, device: str) -> ContrastiveEncoder:
    return ContrastiveEncoder(ckpt_path, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=98304)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=192)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="checkpoints/encoder")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    train(n_pairs=a.pairs, steps=a.steps, batch=a.batch, d_model=a.d_model,
          n_layers=a.n_layers, lr=a.lr, seed=a.seed, out=a.out, device=a.device)


if __name__ == "__main__":
    main()
