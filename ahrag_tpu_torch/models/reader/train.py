"""Train the span reader on the device.

Run: ``python -m ahrag_tpu_torch.models.reader.train --out checkpoints/reader_port``

Port of ``ahrag_tpu/models/reader/train.py``: the whole featurized training
set lives on the device, each step gathers its minibatch through a row of a
pre-shuffled index matrix (``np.random.default_rng(seed)``, as in JAX),
replaces 30% of the word identities and 15% of the stem identities by random
buckets (JAX's threefry draws, ``utils/jax_random.py``, one key per
``--scan`` steps as the JAX loop scans), and takes one ``optax.adamw`` step
(warmup-cosine schedule, weight decay 1e-4; ``agent/optim.py``). Loss =
start/end cross-entropy over the evidence positions. Given the same
parameters, a step here equals a JAX step.

A fresh reader is drawn from a ``torch.Generator`` seeded by ``seed``
(flax's laws, not flax's stream). Artifacts: ``<out>.pt`` (``torch.save`` of
``{"params": state_dict}``; ``ReaderAnswerer`` reads it as it reads the JAX
package's msgpack) and ``<out>_curve.json`` (the loss / val-exact
trajectory).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ahrag_tpu_torch.agent.optim import Adam, warmup_cosine_decay
from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.models.reader.features import Q_LEN, STEM_VOCAB, WORD_VOCAB
from ahrag_tpu_torch.utils import jax_random

FIELDS = ("word_ids", "stem_ids", "scalars", "segments", "mask", "ev_mask")


def loss_fn(model, batch: Dict[str, torch.Tensor], starts: torch.Tensor,
            ends: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean start + end cross-entropy, exact-span accuracy); gold indices are
    evidence-relative, the logits cover the whole sequence."""
    s_log, e_log = model(*(batch[f] for f in FIELDS))
    ts, te = starts.long() + Q_LEN, ends.long() + Q_LEN
    ls = torch.nn.functional.cross_entropy(s_log, ts, reduction="none")
    le = torch.nn.functional.cross_entropy(e_log, te, reduction="none")
    acc = ((s_log.argmax(-1) == ts) & (e_log.argmax(-1) == te)).float().mean()
    return (ls + le).mean(), acc


def identity_dropout(key, shape: Tuple[int, int]):
    """One step's identity-dropout draws: ``(next key, word mask, random word
    ids, stem mask, random stem ids)`` as numpy, from ``key`` split five ways
    as the JAX step splits it."""
    key, k1, k2, k3, k4 = jax_random.split(key, 5)
    return (key, jax_random.bernoulli(k1, 0.3, shape),
            jax_random.randints(k2, shape, 0, WORD_VOCAB),
            jax_random.bernoulli(k3, 0.15, shape),
            jax_random.randints(k4, shape, 0, STEM_VOCAB))


def train_step(model, opt: Adam, data: Dict[str, torch.Tensor], starts: torch.Tensor,
               ends: torch.Tensor, take: np.ndarray, key):
    """One optimizer step on the minibatch ``take`` (indices into ``data``);
    returns ``(next key, loss, acc)`` as device scalars. Word identities (30%)
    and stem identities (15%) are replaced by random buckets: at inference
    the reader reads real English whose hash buckets it never trained."""
    dev = data["word_ids"].device
    t = torch.from_numpy(np.asarray(take, np.int64)).to(dev)
    mb = {f: data[f][t] for f in FIELDS}
    key, wm, wr, sm, sr = identity_dropout(key, tuple(mb["word_ids"].shape))
    mb["word_ids"] = torch.where(torch.from_numpy(wm).to(dev),
                                 torch.from_numpy(wr).to(dev), mb["word_ids"])
    mb["stem_ids"] = torch.where(torch.from_numpy(sm).to(dev),
                                 torch.from_numpy(sr).to(dev), mb["stem_ids"])
    opt.zero_grad()
    loss, acc = loss_fn(model, mb, starts[t], ends[t])
    loss.backward()
    opt.step()
    return key, loss.detach(), acc


def make_optimizer(model, lr: float, steps: int) -> Adam:
    """``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps,
    0.05 lr), weight_decay=1e-4)`` with ``warmup = min(200, max(1, steps //
    4))``, over the model's parameters in ``state_dict`` order."""
    warmup = min(200, max(1, steps // 4))
    return Adam(model.parameters(), warmup_cosine_decay(0.0, lr, warmup, steps, lr * 0.05),
                weight_decay=1e-4)


def minibatch_index(seed: int, n_train: int, batch: int, steps: int) -> np.ndarray:
    """The pre-shuffled minibatch index matrix [steps, batch], as JAX draws it."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_train)[:batch]
                     for _ in range(steps)]).astype(np.int32)


def to_device(fb, sl: slice, device) -> Dict[str, torch.Tensor]:
    return {f: torch.from_numpy(np.ascontiguousarray(getattr(fb, f)[sl])).to(device)
            for f in FIELDS}


def train(n_train: int = 16384, n_val: int = 1024, batch: int = 64,
          steps: int = 4096, scan_len: int = 256, lr: float = 3e-4,
          seed: int = 7, out: str = "checkpoints/reader",
          d_model: int = 128, n_layers: int = 2, d_ff: int = 0,
          n_heads: int = 4, device=None) -> dict:
    from ahrag_tpu_torch.models.reader.data import build_training_arrays
    from ahrag_tpu_torch.models.reader.model import SpanReader

    dev = resolve_device(device)
    t0 = time.time()
    print(f"[reader] generating {n_train}+{n_val} instances...", flush=True)
    fb, (gs, ge) = build_training_arrays(n_train + n_val, seed=seed)
    print(f"[reader] featurized in {time.time() - t0:.1f}s", flush=True)
    train_sl, val_sl = slice(0, n_train), slice(n_train, n_train + n_val)
    data, val = to_device(fb, train_sl, dev), to_device(fb, val_sl, dev)
    starts = torch.from_numpy(gs[train_sl]).to(dev)
    ends = torch.from_numpy(ge[train_sl]).to(dev)
    v_starts = torch.from_numpy(gs[val_sl]).to(dev)
    v_ends = torch.from_numpy(ge[val_sl]).to(dev)

    d_ff = d_ff or 2 * d_model
    model = SpanReader(d_model=d_model, n_layers=n_layers, d_ff=d_ff,
                       n_heads=n_heads, seed=seed, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[reader] {n_params/1e6:.2f}M params", flush=True)
    opt = make_optimizer(model, lr, steps)
    idx = minibatch_index(seed, n_train, batch, steps)

    curve = []
    t1 = time.time()
    for c in range(0, steps, scan_len):
        key = jax_random.prng_key(seed * 100003 + c)
        losses, accs = [], []
        for take in idx[c:c + scan_len]:
            key, loss, acc = train_step(model, opt, data, starts, ends, take, key)
            losses.append(loss)
            accs.append(acc)
        with torch.no_grad():
            _, val_acc = loss_fn(model, val, v_starts, v_ends)
        loss = float(torch.stack(losses).mean())
        acc, val_acc = float(torch.stack(accs).mean()), float(val_acc)
        curve.append({"step": c + scan_len, "loss": round(loss, 4),
                      "train_exact": round(acc, 4),
                      "val_exact": round(val_acc, 4),
                      "wall_s": round(time.time() - t1, 1)})
        print(f"[reader] step {c + scan_len}/{steps} loss {loss:.4f} "
              f"train_exact {acc:.3f} val_exact {val_acc:.3f}", flush=True)

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               out + ".pt")
    meta = {"d_model": d_model, "n_layers": n_layers, "d_ff": d_ff,
            "n_heads": n_heads, "n_params": n_params,
            "steps": steps, "batch": batch, "lr": lr, "seed": seed,
            "n_train": n_train, "n_val": n_val,
            "final_val_exact": curve[-1]["val_exact"] if curve else None,
            "train_wall_s": round(time.time() - t1, 1),
            "backend": dev.type, "curve": curve}
    with open(out + "_curve.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[reader] done: val_exact {meta['final_val_exact']} "
          f"({meta['train_wall_s']}s train)", flush=True)
    return meta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--n-val", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--scan", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--out", default="checkpoints/reader")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    train(n_train=a.n_train, n_val=a.n_val, batch=a.batch, steps=a.steps,
          scan_len=a.scan, lr=a.lr, seed=a.seed, out=a.out,
          d_model=a.d_model, n_layers=a.n_layers, d_ff=a.d_ff,
          n_heads=a.n_heads, device=a.device)


if __name__ == "__main__":
    main()
