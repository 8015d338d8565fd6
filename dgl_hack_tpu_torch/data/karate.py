"""Zachary's karate club, as ``dgl_hack_tpu.data.karate`` (reference:
python/dgl/data/karate.py): fully deterministic, no download."""
import numpy as np

from ..core.graph import _build
from .synthetic import NodeClassificationDataset

# the canonical 78 undirected edges of Zachary's karate club
_EDGES = [
    (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2), (4, 0), (5, 0), (6, 0),
    (6, 4), (6, 5), (7, 0), (7, 1), (7, 2), (7, 3), (8, 0), (8, 2), (9, 2),
    (10, 0), (10, 4), (10, 5), (11, 0), (12, 0), (12, 3), (13, 0), (13, 1),
    (13, 2), (13, 3), (16, 5), (16, 6), (17, 0), (17, 1), (19, 0), (19, 1),
    (21, 0), (21, 1), (25, 23), (25, 24), (27, 2), (27, 23), (27, 24),
    (28, 2), (29, 23), (29, 26), (30, 1), (30, 8), (31, 0), (31, 24),
    (31, 25), (31, 28), (32, 2), (32, 8), (32, 14), (32, 15), (32, 18),
    (32, 20), (32, 22), (32, 23), (32, 29), (32, 30), (32, 31), (33, 8),
    (33, 9), (33, 13), (33, 14), (33, 15), (33, 18), (33, 19), (33, 20),
    (33, 22), (33, 23), (33, 26), (33, 27), (33, 28), (33, 29), (33, 30),
    (33, 31), (33, 32),
]
# instructor (node 0) vs administrator (node 33) factions
_LABELS = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0,
                    1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                   dtype=np.int32)


def KarateClubDataset() -> NodeClassificationDataset:
    e = np.asarray(_EDGES, np.int32)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    g = _build(src, dst, 34, 34, is_block=False)
    feats = np.eye(34, dtype=np.float32)
    train = np.zeros(34, bool)
    train[[0, 33]] = True
    other = ~train
    return NodeClassificationDataset(g, feats, _LABELS, train, other, other,
                                     2, name="karate")
