"""Cluster/hierarchy quality against a known topic structure.

The port's copy of ``ahrag_tpu/eval/clustering.py``: a deterministic
generator of corpora with ground-truth topic labels (disjoint per-topic
pseudo-vocabularies, plus label -1 noise entities drawing from a junk
vocabulary), and the standard external cluster metrics (purity, NMI, noise
precision/recall/F1) computed over the aggregator's actual output.

``evaluate_clustering`` runs the port's ``SemanticAggregator`` (entity
embeddings and spherical k-means) on ``device``, ``cuda`` unless named.
"""
from __future__ import annotations

import math
import random
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

_CONS = "bcdfghjklmnpqrstvwz"
_VOW = "aeiou"


def _pseudo_word(rng: random.Random) -> str:
    n = rng.choice((2, 3))
    return "".join(rng.choice(_CONS) + rng.choice(_VOW) for _ in range(n))


def make_labeled_entities(n_entities: int, n_topics: int, seed: int = 0,
                          noise_frac: float = 0.05,
                          words_per_topic: int = 24,
                          desc_words: int = 10,
                          n_super: int = 0,
                          super_frac: float = 0.3
                          ) -> Tuple[List[Dict[str, str]], List[int]]:
    """Synthetic entities with known topic labels.

    Each topic gets a disjoint pseudo-word vocabulary; an entity's description
    samples from its topic's vocabulary only, so ground truth is unambiguous.
    ``noise_frac`` of entities are label ``-1``: their descriptions sample
    uniformly across ALL topic vocabularies plus junk words — lexically adrift
    from every cluster core (the analogue of HDBSCAN's low-density noise).

    ``n_super`` > 0 adds a SECOND ground-truth level: topics are grouped into
    ``n_super`` super-topics (topic t belongs to super ``t % n_super``), and a
    ``super_frac`` fraction of each description samples from a super-topic
    vocabulary shared by sibling topics. Sibling L1 centroids then genuinely
    correlate, which is what makes L1-relation edges and L2 community recovery
    measurable (super label of entity i = ``label % n_super``).

    Returns (entities [{name, description, type}], labels [N] with -1 = noise).
    """
    rng = random.Random(seed)
    super_vocab: List[List[str]] = []
    used: set = set()
    for _ in range(max(n_super, 0)):
        words = []
        while len(words) < words_per_topic:
            w = _pseudo_word(rng)
            if w not in used:
                used.add(w)
                words.append(w)
        super_vocab.append(words)
    vocab: List[List[str]] = []
    for _ in range(n_topics):
        words = []
        while len(words) < words_per_topic:
            w = _pseudo_word(rng)
            if w not in used:
                used.add(w)
                words.append(w)
        vocab.append(words)
    def fresh_junk(count: int) -> List[str]:
        words = []
        while len(words) < count:
            w = _pseudo_word(rng)
            if w not in used:
                used.add(w)
                words.append(w)
        return words

    entities: List[Dict[str, str]] = []
    labels: List[int] = []
    n_noise = int(round(noise_frac * n_entities))
    for i in range(n_entities):
        if i < n_noise:
            # diffuse noise: mostly entity-unique junk words, so noise entities
            # are far from every cluster AND from each other (HDBSCAN-style
            # low-density points, not a hidden junk topic)
            label = -1
            pool = fresh_junk(desc_words - 2) + [
                w for v in rng.sample(vocab, 2) for w in rng.sample(v, 1)]
            words = rng.sample(pool, min(desc_words, len(pool)))
        else:
            label = i % n_topics
            n_sup_words = (int(round(super_frac * desc_words))
                           if n_super > 0 else 0)
            sup = super_vocab[label % n_super] if n_super > 0 else []
            words = ([rng.choice(sup) for _ in range(n_sup_words)]
                     + [rng.choice(vocab[label])
                        for _ in range(desc_words - n_sup_words)])
            rng.shuffle(words)
        name = f"ent {i} {words[0]}"
        entities.append({"name": name, "type": "concept",
                         "description": " ".join(words)})
        labels.append(label)
    return entities, labels


# ------------------------------------------------------------------ metrics
def purity(pred: List[int], true: List[int]) -> float:
    """Fraction of points whose cluster's majority true-label matches theirs.
    Noise predictions (-1) count as their own singleton-quality bucket only if
    matched to true noise; computed over non-noise predictions."""
    by_cluster: Dict[int, Counter] = {}
    n = 0
    for p, t in zip(pred, true):
        if p == -1:
            continue
        by_cluster.setdefault(p, Counter())[t] += 1
        n += 1
    if n == 0:
        return 0.0
    return sum(c.most_common(1)[0][1] for c in by_cluster.values()) / n


def nmi(pred: List[int], true: List[int]) -> float:
    """Normalized mutual information (arithmetic normalization), noise included
    as ordinary labels so collapsing everything to -1 scores ~0."""
    n = len(pred)
    if n == 0:
        return 0.0
    pc: Counter = Counter(pred)
    tc: Counter = Counter(true)
    joint: Counter = Counter(zip(pred, true))
    mi = 0.0
    for (p, t), c in joint.items():
        mi += (c / n) * math.log((c * n) / (pc[p] * tc[t]) + 1e-300)

    def ent(cnt: Counter) -> float:
        return -sum((c / n) * math.log(c / n + 1e-300) for c in cnt.values())

    hp, ht = ent(pc), ent(tc)
    denom = 0.5 * (hp + ht)
    return mi / denom if denom > 0 else 0.0


def noise_prf(pred: List[int], true: List[int]) -> Dict[str, float]:
    """Precision/recall/F1 of noise (-1) detection."""
    tp = sum(1 for p, t in zip(pred, true) if p == -1 and t == -1)
    fp = sum(1 for p, t in zip(pred, true) if p == -1 and t != -1)
    fn = sum(1 for p, t in zip(pred, true) if p != -1 and t == -1)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": prec, "recall": rec, "f1": f1}


def labeled_extractions(entities: List[Dict[str, str]]) -> list:
    """One single-entity ``Fact`` hyperedge per labeled entity."""
    from ahrag_tpu_torch.schema import Entity, HypergraphExtraction

    return [HypergraphExtraction(
        hyperedge=f"{e['name']} exists", relation_type="Fact",
        entities=[Entity(name=e["name"], type=e["type"],
                         description=e["description"])],
        confidence_score=8.0) for e in entities]


def predicted_labels(l1_nodes: List[Dict[str, Any]],
                     entities: List[Dict[str, str]]) -> List[int]:
    """Each entity's L1 topic id, -1 for an entity in no topic (an outlier)."""
    pred_by_name: Dict[str, int] = {}
    for node in l1_nodes:
        for m in node["members"]:
            pred_by_name[m] = node["topic_id"]
    return [pred_by_name.get(e["name"], -1) for e in entities]


def evaluate_clustering(entities: List[Dict[str, str]], labels: List[int],
                        encoder_name: Optional[str] = "hashed",
                        artifact_dir: Optional[str] = None, device=None,
                        **cluster_kw: Any) -> Dict[str, Any]:
    """Run the production aggregator's embed+cluster path on labeled entities
    on ``device`` and score it against ground truth."""
    import tempfile

    from ahrag_tpu_torch.aggregate.aggregator import SemanticAggregator

    with tempfile.TemporaryDirectory() as tmp:
        agg = SemanticAggregator(encoder_name=encoder_name,
                                 artifact_dir=artifact_dir or tmp, device=device)
        agg.embed_l0_entities(labeled_extractions(entities))
        res = agg.cluster_entities(**cluster_kw)

    name_to_label = {e["name"]: l for e, l in zip(entities, labels)}
    pred = predicted_labels(res["l1_nodes"], entities)
    true = [name_to_label[e["name"]] for e in entities]

    return {
        "n_entities": len(entities),
        "n_true_topics": len({t for t in true if t != -1}),
        "n_pred_topics": len(res["l1_nodes"]),
        "purity": purity(pred, true),
        "nmi": nmi(pred, true),
        "noise": noise_prf(pred, true),
        "pred": pred,
    }
