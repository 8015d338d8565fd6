"""Knowledge-graph datasets (FB15k/FB15k-237/wn18/wn18rr), as
``dgl_hack_tpu.data.kg`` (reference: python/dgl/contrib/data/
knowledge_graph.py and apps/kg's dataset handling: triplet files
``train.txt/valid.txt/test.txt`` with ``entities.dict`` and
``relations.dict``).

The files are parsed from ``$DGL_DOWNLOAD_DIR/<name>`` (default
``~/.dgl_tpu``) when present; otherwise ``load_kg_dataset`` warns and
returns a deterministic synthetic KG with the dataset's entity and
relation counts, the same triples as the JAX package's for the same seed.
Host numpy only.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from .citation import _data_dir

_STATS = {  # name -> (entities, relations, train, valid, test)
    "FB15k": (14951, 1345, 483142, 50000, 59071),
    "FB15k-237": (14541, 237, 272115, 17535, 20466),
    "wn18": (40943, 18, 141442, 5000, 5000),
    "wn18rr": (40943, 11, 86835, 3034, 3134),
}


@dataclass
class KGDataset:
    num_entities: int
    num_relations: int
    train: Tuple[np.ndarray, np.ndarray, np.ndarray]   # (h, r, t)
    valid: Tuple[np.ndarray, np.ndarray, np.ndarray]
    test: Tuple[np.ndarray, np.ndarray, np.ndarray]
    name: str

    def filter_dict(self) -> Dict[Tuple[int, int], np.ndarray]:
        """(h, r) -> known tails across splits, for filtered ranking
        (reference: apps/kg eval 'filtered' protocol)."""
        d: Dict[Tuple[int, int], list] = {}
        for (h, r, t) in (self.train, self.valid, self.test):
            for hh, rr, tt in zip(h, r, t):
                d.setdefault((int(hh), int(rr)), []).append(int(tt))
        return {k: np.asarray(v) for k, v in d.items()}


def _read_triplets(root: str, split: str, ent2id, rel2id) -> np.ndarray:
    path = os.path.join(root, f"{split}.txt")
    hs, rs, ts = [], [], []
    with open(path) as f:
        for line in f:
            h, r, t = line.strip().split("\t")
            hs.append(ent2id[h])
            rs.append(rel2id[r])
            ts.append(ent2id[t])
    return (np.asarray(hs, np.int32), np.asarray(rs, np.int32),
            np.asarray(ts, np.int32))


def _read_dict(path: str) -> Dict[str, int]:
    d = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) == 2:
                d[parts[1]] = int(parts[0])
    return d


def synthetic_kg(name: str, scale: float = 1.0, seed: int = 0) -> KGDataset:
    ne, nr, ntr, nva, nte = _STATS.get(name, (10000, 100, 100000, 5000,
                                              5000))
    ne, ntr = max(int(ne * scale), 100), max(int(ntr * scale), 1000)
    nva, nte = max(int(nva * scale), 100), max(int(nte * scale), 100)
    rng = np.random.default_rng(seed)
    # latent 32-d embedding world: triples satisfy h + r ~ t (TransE-style)
    dim = 32
    ent = rng.normal(size=(ne, dim)).astype(np.float32)
    rel = rng.normal(size=(nr, dim)).astype(np.float32) * 0.5

    def sample(n):
        h = rng.integers(0, ne, n).astype(np.int32)
        r = rng.integers(0, nr, n).astype(np.int32)
        target = ent[h] + rel[r] + 0.1 * rng.normal(size=(n, dim))
        # nearest entity by blocked l2 search
        t = np.empty(n, np.int32)
        for i in range(0, n, 4096):
            blk = target[i:i + 4096]
            d2 = ((blk[:, None, :] - ent[None, :, :]) ** 2).sum(-1) \
                if ne <= 4096 else None
            if d2 is None:
                # two-stage: coarse sample then refine
                cand = rng.integers(0, ne, (len(blk), 256))
                diffs = ent[cand] - blk[:, None, :]
                d2c = (diffs ** 2).sum(-1)
                t[i:i + 4096] = cand[np.arange(len(blk)),
                                     d2c.argmin(1)].astype(np.int32)
            else:
                t[i:i + 4096] = d2.argmin(1).astype(np.int32)
        return h, r, t

    return KGDataset(ne, nr, sample(ntr), sample(nva), sample(nte),
                     name=f"{name}-synth")


def load_kg_dataset(name: str = "FB15k", scale: float = 0.1) -> KGDataset:
    base = name.replace("-synth", "")
    root = os.path.join(_data_dir(), base)
    if os.path.exists(os.path.join(root, "train.txt")):
        ent2id = _read_dict(os.path.join(root, "entities.dict"))
        rel2id = _read_dict(os.path.join(root, "relations.dict"))
        return KGDataset(
            len(ent2id), len(rel2id),
            _read_triplets(root, "train", ent2id, rel2id),
            _read_triplets(root, "valid", ent2id, rel2id),
            _read_triplets(root, "test", ent2id, rel2id), name=base)
    if not name.endswith("-synth"):
        warnings.warn(f"raw {base} files not found under {root}; using the "
                      "synthetic KG stand-in")
    return synthetic_kg(base, scale=scale)
