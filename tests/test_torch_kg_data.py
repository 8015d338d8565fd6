"""The port's knowledge-graph datasets against the JAX package's
``data/kg``: the synthetic KG triple for triple from one seed (both of
its nearest-entity searches: the dense one up to 4,096 entities and the
sampled one above), and the FB15k-style files (``train/valid/test.txt``
with ``entities.dict``/``relations.dict``) parsed from
``$DGL_DOWNLOAD_DIR``, the test's own and the repository's fixture."""
import os
import pathlib

import numpy as np
import pytest
import torch

from dgl_hack_tpu.data import kg as jkg
from dgl_hack_tpu_torch.data import (KGDataset, load_kg_dataset,
                                     synthetic_kg)

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "data"


def _same(a, b):
    assert (a.num_entities, a.num_relations, a.name) == \
        (b.num_entities, b.num_relations, b.name)
    for split in ("train", "valid", "test"):
        for x, y in zip(getattr(a, split), getattr(b, split)):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,scale,seed", [
    ("FB15k", 0.005, 0), ("FB15k-237", 0.01, 3), ("wn18", 0.101, 1),
    ("unknown-kg", 0.02, 2)])
def test_synthetic_kg_matches_jax(name, scale, seed):
    a = synthetic_kg(name, scale=scale, seed=seed)
    b = jkg.synthetic_kg(name, scale=scale, seed=seed)
    assert isinstance(a, KGDataset)
    _same(a, b)
    if name == "wn18":
        assert a.num_entities > 4096        # the sampled search


def test_filter_dict_matches_jax():
    a = synthetic_kg("FB15k", scale=0.005, seed=4)
    b = jkg.synthetic_kg("FB15k", scale=0.005, seed=4)
    fa, fb = a.filter_dict(), b.filter_dict()
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])


def _write_kg(root: pathlib.Path, rng):
    """A small KG in the FB15k layout, with dictionary ids that are not in
    file order (the parser must map names through the dictionaries)."""
    root.mkdir(parents=True)
    ents = [f"/m/e{i:03d}" for i in range(30)]
    rels = [f"/r/{i}" for i in range(5)]
    e_ids, r_ids = rng.permutation(30), rng.permutation(5)
    (root / "entities.dict").write_text(
        "".join(f"{i}\t{e}\n" for i, e in zip(e_ids, ents)))
    (root / "relations.dict").write_text(
        "".join(f"{i}\t{r}\n" for i, r in zip(r_ids, rels)))
    want = {}
    for split, n in (("train", 50), ("valid", 7), ("test", 9)):
        h, r, t = (rng.integers(0, 30, n), rng.integers(0, 5, n),
                   rng.integers(0, 30, n))
        (root / f"{split}.txt").write_text("".join(
            f"{ents[a]}\t{rels[b]}\t{ents[c]}\n" for a, b, c in zip(h, r, t)))
        want[split] = (e_ids[h], r_ids[r], e_ids[t])
    return want


def test_load_kg_dataset_parses_written_files(tmp_path, monkeypatch):
    want = _write_kg(tmp_path / "FB15k-237", np.random.default_rng(0))
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    a = load_kg_dataset("FB15k-237")
    b = jkg.load_kg_dataset("FB15k-237")
    _same(a, b)
    assert (a.num_entities, a.num_relations, a.name) == (30, 5, "FB15k-237")
    for split in ("train", "valid", "test"):
        for x, y in zip(getattr(a, split), want[split]):
            np.testing.assert_array_equal(x, y)


def test_load_kg_dataset_fixture(monkeypatch):
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(FIXTURES))
    _same(load_kg_dataset("FB15k"), jkg.load_kg_dataset("FB15k"))


def test_load_kg_dataset_falls_back_with_warning(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="synthetic KG"):
        a = load_kg_dataset("FB15k", scale=0.005)
    with pytest.warns(UserWarning, match="synthetic KG"):
        b = jkg.load_kg_dataset("FB15k", scale=0.005)
    _same(a, b)
    assert a.name == "FB15k-synth"
    # a "-synth" name asks for the stand-in: no warning
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c = load_kg_dataset("FB15k-synth", scale=0.005)
    _same(c, a)
    assert os.listdir(tmp_path) == []
