"""Random walks, as ``dgl_hack_tpu.sampling.randomwalk`` (DGL:
dgl.sampling.random_walk, src/graph/sampling/randomwalks/).

Host numpy over the graph's CSR arrays, with the same draws from the same
``np.random.Generator`` as the JAX package, so that one generator gives
the same traces in both packages.  Walks feed node2vec/metapath2vec-style
training and the PinSAGE samplers."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.graph import Graph


class _HostCSR:
    """numpy copies of a graph's CSR arrays: out-neighbors by source."""

    def __init__(self, g: Graph):
        if g.csr_indptr is None:
            raise ValueError("random walks need the CSR format")
        self.indptr = g.host("csr_indptr")
        # out-neighbors: dst of edges sorted by src
        eids = g.host("csr_eids")
        self.dst = g.host("dst")[eids]


def _get_csr(g: Graph) -> _HostCSR:
    cache = getattr(g, "_host_csr", None)
    if cache is None:
        cache = _HostCSR(g)
        g._host_csr = cache
    return cache


def random_walk(g: Graph, nodes: Sequence[int], length: int,
                restart_prob: float = 0.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Uniform random walks of ``length`` steps from each start node.

    Returns (len(nodes), length+1) traces; -1 marks early termination
    (dead end), matching the reference's trace padding semantics
    (src/graph/sampler.cc random walk APIs).
    """
    rng = rng or np.random.default_rng()
    csr = _get_csr(g)
    nodes = np.asarray(nodes, dtype=np.int64)
    n = len(nodes)
    traces = np.full((n, length + 1), -1, dtype=np.int32)
    traces[:, 0] = nodes
    cur = nodes.copy()
    alive = np.ones(n, dtype=bool)
    for t in range(1, length + 1):
        deg = csr.indptr[cur + 1] - csr.indptr[cur]
        alive &= deg > 0
        if restart_prob > 0:
            alive &= rng.random(n) >= restart_prob
        if not alive.any():
            break
        pick = (rng.random(n) * np.maximum(deg, 1)).astype(np.int64)
        # a walk that has ended reads position 0, not past the last edge
        # (the JAX package reads csr.dst at the dead end's offset, out of
        # range where that node's id is past every source)
        nxt = csr.dst[np.where(alive, csr.indptr[cur] + pick, 0)]
        cur = np.where(alive, nxt, cur)
        traces[alive, t] = nxt[alive]
    return traces


def node2vec_random_walk(g: Graph, nodes: Sequence[int], p: float, q: float,
                         length: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """Biased 2nd-order walks (node2vec).  Simple rejection-sampling
    implementation."""
    rng = rng or np.random.default_rng()
    csr = _get_csr(g)
    nodes = np.asarray(nodes, dtype=np.int64)
    n = len(nodes)
    traces = np.full((n, length + 1), -1, dtype=np.int32)
    traces[:, 0] = nodes
    for i, start in enumerate(nodes):
        prev, cur = -1, int(start)
        for t in range(1, length + 1):
            lo, hi = csr.indptr[cur], csr.indptr[cur + 1]
            if hi == lo:
                break
            # rejection sampling on the node2vec bias
            for _ in range(64):
                nxt = int(csr.dst[lo + rng.integers(0, hi - lo)])
                if prev < 0:
                    break
                if nxt == prev:
                    w = 1.0 / p
                else:
                    plo, phi = csr.indptr[prev], csr.indptr[prev + 1]
                    is_common = np.any(csr.dst[plo:phi] == nxt)
                    w = 1.0 if is_common else 1.0 / q
                if rng.random() < w / max(1.0, 1.0 / p, 1.0 / q):
                    break
            traces[i, t] = nxt
            prev, cur = cur, nxt
    return traces


def random_walk_with_restart(g: Graph, nodes: Sequence[int],
                             restart_prob: float,
                             max_nodes_per_seed: int,
                             max_visit_counts: int = 0,
                             max_frequent_visited_nodes: int = 0,
                             rng: Optional[np.random.Generator] = None):
    """Restarting walks until ``max_nodes_per_seed`` distinct nodes are
    visited per seed (reference: contrib.sampling random_walk_with_restart
    -> _CAPI_DGLSamplerRandomWalkWithRestart, src/graph/sampler.cc).

    Returns a list (one per seed) of int32 arrays of the distinct visited
    nodes, in first-visit order.  The optional early-stop pair
    (max_visit_counts, max_frequent_visited_nodes) terminates a seed once
    that many nodes have been visited at least that many times, matching
    the reference's frequency-based stopping."""
    rng = rng or np.random.default_rng()
    csr = _get_csr(g)
    out = []
    for start in np.asarray(nodes, dtype=np.int64):
        visited: dict = {}
        counts: dict = {}
        cur = int(start)
        visited[cur] = None
        counts[cur] = 1
        # bounded total steps as a safety net on disconnected components
        for _ in range(64 * max(1, max_nodes_per_seed)):
            if len(visited) >= max_nodes_per_seed:
                break
            if max_visit_counts > 0 and max_frequent_visited_nodes > 0:
                freq = sum(1 for c in counts.values()
                           if c >= max_visit_counts)
                if freq >= max_frequent_visited_nodes:
                    break
            if rng.random() < restart_prob:
                cur = int(start)
                continue
            lo, hi = csr.indptr[cur], csr.indptr[cur + 1]
            if hi == lo:
                cur = int(start)
                continue
            cur = int(csr.dst[lo + rng.integers(0, hi - lo)])
            visited.setdefault(cur, None)
            counts[cur] = counts.get(cur, 0) + 1
        out.append(np.fromiter(visited.keys(), dtype=np.int32,
                               count=len(visited)))
    return out


def metapath_random_walk(hg, metapath, nodes,
                         restart_prob: float = 0.0,
                         rng: Optional[np.random.Generator] = None):
    """Random walks following a metapath over a heterograph
    (reference: python/dgl/sampling/randomwalks.py random_walk with
    metapath=, backed by metapath_randomwalk.h).

    Returns (traces (len(nodes), len(metapath)+1) int64 with -1 padding
    after dead ends, node_types (len(metapath)+1,) int64 into hg.ntypes).
    """
    rng = rng or np.random.default_rng()
    cets = [hg.to_canonical_etype(et) for et in metapath]
    ntypes = list(hg.ntypes)
    types = [ntypes.index(cets[0][0])] + \
        [ntypes.index(c[2]) for c in cets]
    csrs = []
    for c in cets:
        rel = hg.relations[c]
        s, d = rel.host_edges()
        order = np.argsort(s, kind="stable")
        indptr = np.zeros(rel.num_src_nodes + 1, np.int64)
        np.cumsum(np.bincount(s, minlength=rel.num_src_nodes),
                  out=indptr[1:])
        csrs.append((indptr, d[order]))
    nodes = np.asarray(nodes, np.int64)
    traces = np.full((len(nodes), len(cets) + 1), -1, np.int64)
    traces[:, 0] = nodes
    for i, start in enumerate(nodes):
        cur = int(start)
        for step, (indptr, dsts) in enumerate(csrs):
            if restart_prob > 0 and step > 0 and rng.random() < restart_prob:
                break
            lo, hi = indptr[cur], indptr[cur + 1]
            if hi == lo:
                break
            cur = int(dsts[lo + rng.integers(0, hi - lo)])
            traces[i, step + 1] = cur
    return traces, np.asarray(types, np.int64)


def pack_traces(traces, types):
    """Concatenate traces dropping the -1 padding (reference:
    python/dgl/sampling/randomwalks.py pack_traces:160).

    Returns (concat_vids, concat_types, lengths, offsets)."""
    traces = np.asarray(traces)
    types = np.asarray(types)
    vids, tys, lengths, offsets = [], [], [], []
    off = 0
    for row in traces:
        keep = row >= 0
        n = int(keep.sum())
        vids.append(row[keep])
        tys.append(types[keep])
        lengths.append(n)
        offsets.append(off)
        off += n
    return (np.concatenate(vids) if vids else np.zeros(0, np.int64),
            np.concatenate(tys) if tys else np.zeros(0, np.int64),
            np.asarray(lengths, np.int64), np.asarray(offsets, np.int64))
