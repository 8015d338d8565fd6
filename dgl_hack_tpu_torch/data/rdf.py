"""RDF entity-classification datasets (AIFB/MUTAG/BGS/AM), as
``dgl_hack_tpu.data.rdf``: the same generator, so the same name, scale and
seed give the same arrays and the same graph in both packages.

Raw files load from ``$DGL_DOWNLOAD_DIR/<name>/<name>.npz`` when present
(arrays ``src``, ``dst``, ``etypes``, ``labels``, ``train_mask``,
``test_mask`` and the scalars ``num_nodes``, ``num_classes``,
``num_rels``); otherwise a deterministic synthetic relational graph with
the dataset's shape statistics stands in (its relations are
class-predictive, so R-GCN has signal to learn).  Nothing is downloaded.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np

from ..core.graph import Graph, _build

_STATS = {  # name -> (nodes, rels, classes, edges, labeled)
    "aifb": (8285, 45, 4, 29043, 176),
    "mutag": (23644, 23, 2, 74227, 340),
    "bgs": (333845, 103, 2, 916199, 146),
    "am": (1666764, 133, 11, 5988321, 1000),
}


@dataclass
class RDFDataset:
    graph: Graph
    etypes: np.ndarray          # (E,) relation id per edge (user order)
    labels: np.ndarray          # (N,) class (-1 = unlabeled)
    train_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    num_rels: int
    name: str


def synthetic_rdf(name: str, scale: float = 1.0,
                  seed: int = 0) -> RDFDataset:
    """A relational graph with the named dataset's node, relation, class,
    edge and label counts (times ``scale``), every edge doubled by its
    inverse relation.  With probability 0.9 an edge's relation is
    congruent to its dst node's class modulo the class count, else
    uniform."""
    n, R, C, E, n_labeled = _STATS.get(name.replace("-synth", ""),
                                       (5000, 20, 4, 30000, 200))
    n = max(int(n * scale), 100)
    E = max(int(E * scale), 1000)
    rng = np.random.default_rng(seed)
    labels_all = rng.integers(0, C, n).astype(np.int32)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    c_dst = labels_all[dst].astype(np.int64)
    k = rng.integers(0, max(R // C, 1), E).astype(np.int64)
    ety_sig = (c_dst + C * k) % R
    ety_rnd = rng.integers(0, R, E).astype(np.int64)
    use_sig = rng.random(E) < 0.9
    ety = np.where(use_sig, ety_sig, ety_rnd).astype(np.int32)
    # symmetrised with inverse relations, as the RDF loaders do
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    ety2 = np.concatenate([ety, ety + R]).astype(np.int32)
    g = _build(src2, dst2, n, n, is_block=False)

    labeled = rng.choice(n, size=min(n_labeled, n), replace=False)
    train_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    cut = int(0.8 * len(labeled))
    train_mask[labeled[:cut]] = True
    test_mask[labeled[cut:]] = True
    return RDFDataset(g, ety2, labels_all, train_mask, test_mask, C, 2 * R,
                      name=f"{name}")


def load_rdf_dataset(name: str, scale: float = 0.1) -> RDFDataset:
    """The npz file of ``name`` under ``$DGL_DOWNLOAD_DIR`` (default
    ``~/.dgl_tpu``) if there is one, else ``synthetic_rdf`` (at full size
    for aifb and mutag, at ``scale`` for the others), with a warning unless
    the name ends in ``-synth``."""
    base = name.replace("-synth", "")
    root = os.path.join(
        os.environ.get("DGL_DOWNLOAD_DIR",
                       os.path.expanduser("~/.dgl_tpu")), base)
    npz = os.path.join(root, f"{base}.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        g = _build(z["src"], z["dst"], int(z["num_nodes"]),
                   int(z["num_nodes"]), is_block=False)
        return RDFDataset(g, z["etypes"], z["labels"], z["train_mask"],
                          z["test_mask"], int(z["num_classes"]),
                          int(z["num_rels"]), name=base)
    if not name.endswith("-synth"):
        warnings.warn(f"raw {base} files not found under {root}; using the "
                      "synthetic relational stand-in")
    small = base in ("aifb", "mutag")
    return synthetic_rdf(base, scale=1.0 if small else scale)


def AIFBDataset(**kw):
    return load_rdf_dataset("aifb", **kw)


def MUTAGDataset(**kw):
    return load_rdf_dataset("mutag", **kw)


def BGSDataset(**kw):
    return load_rdf_dataset("bgs", **kw)


def AMDataset(**kw):
    return load_rdf_dataset("am", **kw)
