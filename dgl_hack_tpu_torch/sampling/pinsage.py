"""PinSAGE-style random-walk neighbor samplers, as
``dgl_hack_tpu.sampling.pinsage`` (DGL: python/dgl/sampling/pinsage.py).

``RandomWalkNeighborSampler`` walks a metapath with restarts from each
seed and keeps the most-visited nodes of the seed's type as its
neighbors, with the visit counts as the edge feature ``weights``;
``PinSAGESampler`` is its bidirectional-bipartite case.  Host numpy over
the port's ``HeteroGraph``, with the JAX package's draws; the result is a
``Graph`` (on the CPU) ready for ``prepare_spmm`` and the conv layers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.graph import Graph, _build
from .randomwalk import metapath_random_walk

__all__ = ["RandomWalkNeighborSampler", "PinSAGESampler"]


class RandomWalkNeighborSampler:
    """Most-visited metapath-endpoint neighbors per seed
    (reference: pinsage.py RandomWalkNeighborSampler)."""

    def __init__(self, G, random_walk_length: int,
                 random_walk_restart_prob: float, num_random_walks: int,
                 num_neighbors: int, metapath: Optional[Sequence] = None,
                 weight_column: str = "weights", seed: Optional[int] = None):
        self.G = G
        if metapath is None:
            if len(G.canonical_etypes) != 1:
                raise ValueError("metapath required for multi-etype graphs")
            metapath = [G.canonical_etypes[0]]
        self.metapath = [G.to_canonical_etype(et) for et in metapath]
        st = self.metapath[0][0]
        dt = self.metapath[-1][2]
        if st != dt:
            raise ValueError("metapath must begin and end at one ntype")
        self.ntype = st
        self.full_path = list(self.metapath) * random_walk_length
        self.restart_prob = random_walk_restart_prob
        self.num_random_walks = num_random_walks
        self.num_neighbors = num_neighbors
        self.weight_column = weight_column
        self.rng = np.random.default_rng(seed)
        self.hops = len(self.metapath)

    def __call__(self, seed_nodes) -> Graph:
        seeds = np.asarray(seed_nodes, np.int64)
        rep = np.repeat(seeds, self.num_random_walks)
        traces, _ = metapath_random_walk(
            self.G, self.full_path, rep,
            restart_prob=self.restart_prob, rng=self.rng)
        # endpoints of each completed metapath traversal are same-type
        ends = traces[:, self.hops::self.hops]           # (walks, length)
        n = self.G.num_nodes(self.ntype)
        counts = {}
        for srow, endrow in zip(rep, ends):
            for v in endrow:
                if v >= 0:
                    counts[(int(v), int(srow))] = \
                        counts.get((int(v), int(srow)), 0) + 1
        src, dst, w = [], [], []
        per_seed: dict = {}
        for (v, s), c in counts.items():
            per_seed.setdefault(s, []).append((c, v))
        for s, lst in per_seed.items():
            lst.sort(reverse=True)
            for c, v in lst[:self.num_neighbors]:
                src.append(v)
                dst.append(s)
                w.append(c)
        g = _build(np.asarray(src, np.int32), np.asarray(dst, np.int32),
                   n, n, is_block=False)
        g.edata[self.weight_column] = torch.from_numpy(
            np.asarray(w, np.int64))
        return g


class PinSAGESampler(RandomWalkNeighborSampler):
    """PinSAGE sampler over a bidirectional bipartite graph
    (reference: pinsage.py PinSAGESampler:122): one metapath step =
    ntype -> other_type -> ntype."""

    def __init__(self, G, ntype: str, other_type: str,
                 random_walk_length: int, random_walk_restart_prob: float,
                 num_random_walks: int, num_neighbors: int,
                 weight_column: str = "weights", seed: Optional[int] = None):
        fwd = [c for c in G.canonical_etypes
               if c[0] == ntype and c[2] == other_type]
        bwd = [c for c in G.canonical_etypes
               if c[0] == other_type and c[2] == ntype]
        if len(fwd) != 1 or len(bwd) != 1:
            raise ValueError("expected exactly one etype each way between "
                             f"{ntype!r} and {other_type!r}")
        super().__init__(G, random_walk_length, random_walk_restart_prob,
                         num_random_walks, num_neighbors,
                         metapath=[fwd[0], bwd[0]],
                         weight_column=weight_column, seed=seed)
