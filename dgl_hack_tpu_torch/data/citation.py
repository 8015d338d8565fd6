"""Citation datasets (Cora/Citeseer/Pubmed) and Reddit, as
``dgl_hack_tpu.data.citation`` (reference: python/dgl/data/
citation_graph.py, the planetoid ``ind.*`` pickled format, and
python/dgl/data/reddit.py, the npz archive).

If the raw files are under ``$DGL_DOWNLOAD_DIR`` (or ``~/.dgl_tpu``) they
are parsed; otherwise each loader returns the deterministic synthetic
stand-in (data/synthetic.py) with a warning, so tests and benchmarks run
offline.  Graphs are built on the host; ``Graph.to`` moves them.
"""
from __future__ import annotations

import os
import pickle
import warnings

import numpy as np
import scipy.sparse as sp

from ..core.graph import _build
from .synthetic import (NodeClassificationDataset, planted_partition,
                        synthetic_reddit)

_STATS = {  # name -> (nodes, classes, feat_dim, avg_deg, train/class)
    "cora": (2708, 7, 1433, 3.9, 20),
    "citeseer": (3327, 6, 3703, 2.8, 20),
    "pubmed": (19717, 3, 500, 4.5, 20),
}


def _data_dir() -> str:
    return os.environ.get("DGL_DOWNLOAD_DIR",
                          os.path.join(os.path.expanduser("~"), ".dgl_tpu"))


def _parse_index_file(path):
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def _load_planetoid(name: str, root: str) -> NodeClassificationDataset:
    """Parse the planetoid ``ind.<name>.*`` files (the reference's format,
    data/citation_graph.py)."""
    objs = {}
    for ext in ["x", "y", "tx", "ty", "allx", "ally", "graph"]:
        with open(os.path.join(root, f"ind.{name}.{ext}"), "rb") as f:
            objs[ext] = pickle.load(f, encoding="latin1")
    test_idx = _parse_index_file(os.path.join(root, f"ind.{name}.test.index"))
    test_range = np.sort(test_idx)

    allx, tx = objs["allx"], objs["tx"]
    if name == "citeseer":
        # citeseer has isolated test nodes: pad tx to the full test range
        full = sp.lil_matrix((test_range[-1] - test_range[0] + 1, tx.shape[1]))
        full[test_range - test_range.min()] = tx
        tx = full
        ty_full = np.zeros((full.shape[0], objs["ty"].shape[1]))
        ty_full[test_range - test_range.min()] = objs["ty"]
        objs["ty"] = ty_full

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx] = features[test_range]
    labels_oh = np.vstack((objs["ally"], objs["ty"]))
    labels_oh[test_idx] = labels_oh[test_range]
    labels = labels_oh.argmax(1).astype(np.int32)

    n = features.shape[0]
    src, dst = [], []
    for u, nbrs in objs["graph"].items():
        for v in nbrs:
            src.append(u)
            dst.append(v)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    # symmetrize + self-loop, as the reference examples do
    loop = np.arange(n, dtype=np.int32)
    s = np.concatenate([src, dst, loop])
    d = np.concatenate([dst, src, loop])
    uniq = np.unique(np.stack([s, d], 1), axis=0)
    g = _build(uniq[:, 0], uniq[:, 1], n, n, is_block=False)

    idx_train = np.arange(objs["y"].shape[0])
    idx_val = np.arange(objs["y"].shape[0], objs["y"].shape[0] + 500)
    train_mask = np.zeros(n, bool)
    train_mask[idx_train] = True
    val_mask = np.zeros(n, bool)
    val_mask[idx_val] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx] = True

    feats = np.asarray(features.todense(), dtype=np.float32)
    # row-normalize features (reference: citation_graph.py _preprocess)
    rowsum = feats.sum(1, keepdims=True)
    feats = feats / np.maximum(rowsum, 1.0)
    return NodeClassificationDataset(g, feats, labels, train_mask, val_mask,
                                     test_mask, labels_oh.shape[1], name=name)


def _citation(name: str, synthetic_seed: int = 0) -> NodeClassificationDataset:
    root = os.path.join(_data_dir(), name)
    if os.path.exists(os.path.join(root, f"ind.{name}.graph")):
        return _load_planetoid(name, root)
    warnings.warn(
        f"raw {name} files not found under {root}; using the deterministic "
        "synthetic stand-in (zero-egress container). Place planetoid "
        f"ind.{name}.* files there to use the real dataset.")
    n, c, fdim, deg, tpc = _STATS[name]
    return planted_partition(n, c, fdim, avg_degree=deg, homophily=0.81,
                             feat_noise=2.0, seed=synthetic_seed,
                             train_per_class=tpc, name=f"{name}-synth")


def CoraGraphDataset(**kw):
    return _citation("cora", **kw)


def CiteseerGraphDataset(**kw):
    return _citation("citeseer", **kw)


def PubmedGraphDataset(**kw):
    return _citation("pubmed", **kw)


def RedditDataset(self_loop: bool = False, scale: float = 0.1,
                  **kw) -> NodeClassificationDataset:
    """Reference: python/dgl/data/reddit.py (reddit_data.npz +
    reddit_graph.npz).  Falls back to a scaled synthetic stand-in
    (``scale`` of Reddit's 232,965 nodes)."""
    root = os.path.join(_data_dir(), "reddit")
    data_p = os.path.join(root, "reddit_data.npz")
    graph_p = os.path.join(root, "reddit_graph.npz")
    if os.path.exists(data_p) and os.path.exists(graph_p):
        with np.load(data_p) as data:
            feature, label = data["feature"], data["label"]
            types = data["node_types"]
        gdata = sp.load_npz(graph_p).tocoo()
        n = feature.shape[0]
        g = _build(gdata.row.astype(np.int32), gdata.col.astype(np.int32),
                   n, n, is_block=False)
        return NodeClassificationDataset(
            g, feature.astype(np.float32), label.astype(np.int32),
            types == 1, types == 2, types == 3, int(label.max() + 1),
            name="reddit")
    warnings.warn("reddit raw files not found; using synthetic stand-in")
    return synthetic_reddit(num_nodes=int(232965 * scale))
