"""Graph classification datasets, as
``dgl_hack_tpu.data.graph_classification``: the same generator draws the
same ``default_rng`` stream, so a seed gives the same graphs, features and
labels in both packages.

An SBM mixture stands in for the TU/GIN datasets offline: the label of a
graph is its community count, a structural signal GIN can learn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core.graph import Graph, _build


@dataclass
class GraphClassificationDataset:
    graphs: List[Graph]
    features: List[np.ndarray]
    labels: np.ndarray
    num_classes: int
    name: str = "synthetic-gc"

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i], self.labels[i]


def sbm_mixture(num_graphs: int = 200, nodes_per_graph: int = 40,
                communities=(1, 2, 4), p_in: float = 0.5,
                p_out: float = 0.05, feat_dim: int = 8,
                seed: int = 0) -> GraphClassificationDataset:
    """Graphs drawn from SBMs with varying community counts; the label is
    the index of the community count in ``communities``."""
    rng = np.random.default_rng(seed)
    graphs, feats, labels = [], [], []
    for _ in range(num_graphs):
        ci = rng.integers(0, len(communities))
        k = communities[ci]
        comm = rng.integers(0, k, nodes_per_graph)
        prob = np.where(comm[:, None] == comm[None, :], p_in, p_out)
        adj = rng.random((nodes_per_graph, nodes_per_graph)) < prob
        np.fill_diagonal(adj, False)
        adj = adj | adj.T
        s, d = np.nonzero(adj)
        graphs.append(_build(s.astype(np.int32), d.astype(np.int32),
                             nodes_per_graph, nodes_per_graph,
                             is_block=False))
        feats.append(np.ones((nodes_per_graph, feat_dim), np.float32))
        labels.append(ci)
    return GraphClassificationDataset(graphs, feats,
                                      np.asarray(labels, np.int32),
                                      len(communities), name="sbm-mixture")


def TUDatasetSynthetic(name: str = "synthetic", **kw):
    return sbm_mixture(**kw)
