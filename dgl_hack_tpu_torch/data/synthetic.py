"""Deterministic synthetic datasets (numpy), the same generators as
``dgl_hack_tpu.data.synthetic``: the same seed gives the same arrays and
the same graph in both packages.

A planted-partition ("homophily SBM") citation-style graph whose features
carry class signal stands in for Cora and Reddit offline, with their
shapes and sparsity.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.graph import Graph, _build


@dataclass
class NodeClassificationDataset:
    graph: Graph
    features: np.ndarray
    labels: np.ndarray
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    name: str = "synthetic"

    def __getitem__(self, idx):
        if idx != 0:
            raise IndexError(idx)
        return self.graph

    def __len__(self):
        return 1


def planted_partition(num_nodes: int, num_classes: int, feat_dim: int,
                      avg_degree: float = 4.0, homophily: float = 0.9,
                      feat_noise: float = 1.0, seed: int = 0,
                      train_per_class: int = 20, num_val: int = 500,
                      num_test: int = 1000,
                      name: str = "synthetic") -> NodeClassificationDataset:
    """Citation-graph stand-in: within-class edges with prob ``homophily``,
    class-mean features + gaussian noise, planetoid-style splits."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    E = int(num_nodes * avg_degree)

    u = rng.integers(0, num_nodes, size=2 * E).astype(np.int32)
    same = rng.random(2 * E) < homophily
    # choose a partner: same class when homophilous, else any node
    order = np.argsort(labels, kind="stable")
    class_off = np.searchsorted(labels[order], np.arange(num_classes + 1))
    cls_u = labels[u]
    lo, hi = class_off[cls_u], class_off[cls_u + 1]
    partner_same = order[(lo + (rng.random(2 * E) * (hi - lo)).astype(np.int64))
                         % num_nodes]
    partner_rand = rng.integers(0, num_nodes, size=2 * E).astype(np.int32)
    v = np.where(same, partner_same, partner_rand).astype(np.int32)
    keep = u != v
    u, v = u[:E][keep[:E]], v[:E][keep[:E]]
    # symmetrize + self loops (citation datasets are used symmetrized)
    src = np.concatenate([u, v, np.arange(num_nodes, dtype=np.int32)])
    dst = np.concatenate([v, u, np.arange(num_nodes, dtype=np.int32)])
    g = _build(src, dst, num_nodes, num_nodes, is_block=False)

    centers = rng.normal(size=(num_classes, feat_dim)).astype(np.float32)
    feats = (centers[labels]
             + feat_noise * rng.normal(size=(num_nodes, feat_dim))
             ).astype(np.float32)

    train_mask = np.zeros(num_nodes, bool)
    for c in range(num_classes):
        idx = np.where(labels == c)[0][:train_per_class]
        train_mask[idx] = True
    rest = np.where(~train_mask)[0]
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    val_mask[rest[:num_val]] = True
    test_mask[rest[num_val:num_val + num_test]] = True

    return NodeClassificationDataset(g, feats, labels, train_mask, val_mask,
                                     test_mask, num_classes, name=name)


def synthetic_cora(seed: int = 0) -> NodeClassificationDataset:
    """Shape-compatible Cora stand-in (2708 nodes, 1433 feats, 7 classes)."""
    return planted_partition(2708, 7, 1433, avg_degree=3.9, homophily=0.81,
                             feat_noise=2.0, seed=seed, name="cora-synth")


def synthetic_reddit(seed: int = 0,
                     num_nodes: int = 232965) -> NodeClassificationDataset:
    """Reddit-scale stand-in (232,965 nodes, 602 features, 41 classes,
    ~23.5M edges after symmetrisation and self loops)."""
    # split sizes scale with the node count (full-size: 3000/cls train,
    # 20k val, 50k test like the real Reddit split)
    tpc = max(min(3000, num_nodes // (41 * 3)), 5)
    nval = max(num_nodes // 12, 50)
    ntest = max(num_nodes // 5, 100)
    return planted_partition(num_nodes, 41, 602, avg_degree=50.0,
                             homophily=0.8, feat_noise=1.5, seed=seed,
                             train_per_class=tpc, num_val=nval,
                             num_test=ntest, name="reddit-synth")


def random_power_law_graph(num_nodes: int, avg_degree: float = 16.0,
                           alpha: float = 2.1, offset: float = 100.0,
                           seed: int = 0) -> Graph:
    """Power-law in-degree graph for kernel benchmarking.

    ``offset`` shifts the zipf ranks (p ~ (rank+offset)^-alpha) so the
    head is heavy but no single node owns most edges.
    """
    rng = np.random.default_rng(seed)
    E = int(num_nodes * avg_degree)
    ranks = np.arange(num_nodes, dtype=np.float64) + 1.0 + offset
    p = ranks ** -alpha
    p /= p.sum()
    dst = rng.choice(num_nodes, size=E, p=p).astype(np.int32)
    src = rng.integers(0, num_nodes, size=E).astype(np.int32)
    return _build(src, dst, num_nodes, num_nodes, is_block=False)
