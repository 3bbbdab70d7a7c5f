"""The port's synthetic worlds and clustering eval against the JAX package's.

``eval/synth.py`` is a copy (pure Python on ``random.Random``): every frozen
``samples/synth_*`` file regenerates byte for byte from the port's
generator, those the JAX package's tests check (``tests/test_synth_eval.py``,
``test_synth_v2.py``, ``test_synth_sharedxl.py``) and the others, each at the
seed and size its split was written with; and the port's items equal the
JAX package's at other seeds. ``eval/clustering.py`` and
``cli/cluster_eval.run`` run the port's aggregator on the CPU and are held
equal to the JAX package's, every field but the stage seconds
(``embed_s``, ``cluster_s``, ``l2_s``).
"""
import json
import random

import pytest

from ahrag_tpu.cli import cluster_eval as jce
from ahrag_tpu.eval import clustering as jcl
from ahrag_tpu.eval import synth as jsynth
from ahrag_tpu_torch.cli import cluster_eval as tce
from ahrag_tpu_torch.eval import clustering as tcl
from ahrag_tpu_torch.eval import synth as tsynth
from chip_smoke import SAMPLES

SPLITS = ("train", "dev", "test")
# (version, seeds, {split: items}) of the frozen per-question files
FROZEN = {"eval": ("v1", "SPLIT_SEEDS", {"train": 100, "dev": 100, "test": 120}),
          "v2": ("v2", "SPLIT_SEEDS_V2", {"train": 100, "dev": 100, "test": 130}),
          "v3": ("v3", "SPLIT_SEEDS_V3", dict.fromkeys(SPLITS, 120)),
          "v4": ("v4", "SPLIT_SEEDS_V4", dict.fromkeys(SPLITS, 138)),
          "v5": ("v5", "SPLIT_SEEDS_V5", dict.fromkeys(SPLITS, 120)),
          "v6": ("v6", "SPLIT_SEEDS_V6", dict.fromkeys(SPLITS, 120))}
# the shared worlds: (seed offset, people, films, orgs, xl), 150 items each
SHARED = {"v4_shared": (500000, 400, 180, 80, False),
          "v4_sharedxl": (700000, 1200, 380, 220, True)}
TIMES = ("embed_s", "cluster_s", "l2_s")


def jsonl(items) -> str:
    """The frozen files' layout (``synth.main``)."""
    return "".join(json.dumps(it, ensure_ascii=False) + "\n" for it in items)


@pytest.mark.parametrize("name,split", [(n, s) for n in FROZEN for s in SPLITS])
def test_frozen_files_regenerate_byte_for_byte(name, split):
    version, seeds, sizes = FROZEN[name]
    items = tsynth.make_dataset(getattr(tsynth, seeds)[split], sizes[split], split=split,
                                version=version)
    assert jsonl(items) == (SAMPLES / f"synth_{name}_{split}.jsonl").read_text(encoding="utf-8")


@pytest.mark.parametrize("name,split", [(n, s) for n in SHARED for s in SPLITS])
def test_frozen_shared_worlds_regenerate_byte_for_byte(name, split, tmp_path):
    offset, people, films, orgs, xl = SHARED[name]
    world, items = tsynth.make_shared_dataset(
        tsynth.SPLIT_SEEDS_V4[split] + offset, 150, split=split, version="v4", xl=xl,
        n_people=people, n_films=films, n_orgs=orgs)
    assert jsonl(items) == (SAMPLES / f"synth_{name}_{split}.jsonl").read_text(encoding="utf-8")
    corpus = tmp_path / "corpus.txt"
    assert tsynth.write_shared_world(world, str(corpus)) == len(world["paragraphs"])
    kind = name.replace("v4_", "")
    assert corpus.read_text(encoding="utf-8") == \
        (SAMPLES / f"synth_v4_{kind}_corpus_{split}.txt").read_text(encoding="utf-8")


@pytest.mark.parametrize("version", ["v1", "v2", "v3", "v4", "v5", "v6"])
def test_generator_matches_jax_at_other_seeds(version):
    for seed, split in ((5, "train"), (77, "dev"), (901, "test")):
        assert tsynth.make_dataset(seed, 40, split=split, version=version) == \
            jsynth.make_dataset(seed, 40, split=split, version=version)


def test_shared_generator_matches_jax_at_another_seed():
    kw = dict(split="dev", version="v4", n_people=120, n_films=50, n_orgs=30)
    assert tsynth.make_shared_dataset(4242, 60, **kw) == jsynth.make_shared_dataset(4242, 60, **kw)
    assert tsynth.make_shared_dataset(4242, 60, xl=True, **kw) == \
        jsynth.make_shared_dataset(4242, 60, xl=True, **kw)


def test_synth_constants_match_jax():
    for name in ("NO_NAME_FAMILIES", "COUNTRIES", "COUNTRIES_XL", "V6_ATTR_VARIANTS",
                 "SPLIT_SEEDS", "SPLIT_SEEDS_V2", "SPLIT_SEEDS_V3", "SPLIT_SEEDS_V4",
                 "SPLIT_SEEDS_V5", "SPLIT_SEEDS_V6"):
        assert getattr(tsynth, name) == getattr(jsynth, name), name
    assert [n for n, _ in tsynth.QUESTION_FAMILIES] == [n for n, _ in jsynth.QUESTION_FAMILIES]


def test_synth_cli_writes_the_frozen_split(tmp_path, monkeypatch, capsys):
    out = tmp_path / "v2_dev.jsonl"
    monkeypatch.setattr("sys.argv", ["synth", "--split", "dev", "--n", "100", "--version", "v2",
                                     "--out", str(out)])
    tsynth.main()
    assert out.read_bytes() == (SAMPLES / "synth_v2_dev.jsonl").read_bytes()
    assert "wrote 100 items" in capsys.readouterr().out


# -------------------------------------------------------------- clustering
@pytest.mark.parametrize("kw", [dict(n_entities=300, n_topics=6, seed=0),
                                dict(n_entities=500, n_topics=12, seed=4, noise_frac=0.1),
                                dict(n_entities=400, n_topics=8, seed=2, n_super=3,
                                     super_frac=0.5)],
                         ids=["plain", "noisy", "super"])
def test_labeled_entities_match_jax(kw):
    assert tcl.make_labeled_entities(**kw) == jcl.make_labeled_entities(**kw)


@pytest.mark.parametrize("seed", range(4))
def test_cluster_metrics_match_jax(seed):
    rng = random.Random(seed)
    n = 200
    true = [rng.randrange(-1, 6) for _ in range(n)]
    pred = [t if rng.random() < 0.7 else rng.randrange(-1, 9) for t in true]
    assert tcl.purity(pred, true) == jcl.purity(pred, true)
    assert tcl.nmi(pred, true) == jcl.nmi(pred, true)
    assert tcl.noise_prf(pred, true) == jcl.noise_prf(pred, true)


def test_cluster_metrics_edge_cases_match_jax():
    for pred, true in (([], []), ([-1, -1], [0, 1]), ([0, 0, 0], [0, 0, 0]),
                       ([1, 2, 3], [-1, -1, -1])):
        assert tcl.purity(pred, true) == jcl.purity(pred, true)
        assert tcl.nmi(pred, true) == jcl.nmi(pred, true)
        assert tcl.noise_prf(pred, true) == jcl.noise_prf(pred, true)


def test_evaluate_clustering_matches_jax():
    ents, labels = jcl.make_labeled_entities(600, 10, seed=1, noise_frac=0.05)
    assert tcl.evaluate_clustering(ents, labels, device="cpu") == \
        jcl.evaluate_clustering(ents, labels)


@pytest.mark.parametrize("n_super", [0, 4])
def test_cluster_eval_run_matches_jax(n_super):
    """``cluster_eval.run`` at n 2,000, 16 topics, noise 0.05, seed 3."""
    got = tce.run(2000, 16, 0.05, 3, n_super=n_super, device="cpu")
    ref = jce.run(2000, 16, 0.05, 3, n_super=n_super)
    assert all(isinstance(got.pop(k), float) and ref.pop(k) is not None for k in TIMES)
    assert got == ref
    assert ("super" in got) == (n_super > 0)


def test_cluster_eval_cli(tmp_path, capsys):
    out = tmp_path / "r.json"
    tce.main(["--n", "300", "--topics", "6", "--super", "2", "--out", str(out),
              "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(out.read_text())
    assert printed["n_entities"] == 300 and printed["l1"]["n_pred_topics"] > 0
