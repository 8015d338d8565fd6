"""Neighbor sampling into minibatch blocks, as
``dgl_hack_tpu.sampling.neighbor``.

Sampling stays on the host, as in the JAX package (and in DGL, whose
samplers run on the CPU too).  Uniform picks (``fanout >= 0`` and no
``prob``), the path every minibatch loader takes, go through the native
C++/OpenMP sampler (``native.rowwise_sample_native``), exactly where the
JAX package takes its own: it draws ``rng.integers(1 << 62)`` and hands
it to the sampler, whose picks are a function of that seed alone, so one
generator gives the same frontiers, edge ids and blocks in both packages.
``_pick_uniform_plain`` is that step's plain numpy version (the JAX
package's fallback when its library does not build); tests call it, the
samplers never do.  Taking all in-edges and weighted picks stay in numpy,
as in the JAX package.

Blocks have static shapes: with ``replace=True`` each block has exactly
``len(seeds) * fanout`` edges; without replacement it is padded to that
count with masked edges, and the src set is padded to a power of two
(``_round_up_pow2``).  The blocks' tensors stay on the host; a training
loop moves them (``Graph.to``, or ``distributed.prefetch_to_device``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.batch import batch as batch_graphs
from ..core.graph import Graph, _build
from ..core.transform import to_block
from ..native import rowwise_sample_native


class _HostCSC:
    """numpy copies of a graph's CSC arrays, for host sampling."""

    def __init__(self, g: Graph):
        self.indptr = g.host("csc_indptr")
        self.src = g.host("src")
        self.eid = (g.host("int2user") if g.int2user is not None
                    else np.arange(len(self.src), dtype=np.int32))
        self.num_src = g.num_src_nodes
        self.num_dst = g.num_dst_nodes


def _get_csc(g: Graph) -> _HostCSC:
    cache = getattr(g, "_host_csc", None)
    if cache is None:
        cache = _HostCSC(g)
        g._host_csc = cache
    return cache


def _frontier(csc: _HostCSC, pos: np.ndarray, dst_sel: np.ndarray
              ) -> Tuple[Graph, np.ndarray]:
    """The frontier of the CSC positions ``pos`` into ``dst_sel`` (original
    node ids, no CSR) and the picked edges' user-order ids."""
    frontier = _build(csc.src[pos].astype(np.int32),
                      dst_sel.astype(np.int32), csc.num_src, csc.num_dst,
                      is_block=False, build_csr=False)
    return frontier, csc.eid[pos].astype(np.int32)


def _pick_uniform(csc: _HostCSC, nodes: np.ndarray, fanout: int,
                  replace: bool, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``fanout`` uniform in-edges of each seed (with replacement; without
    it min(fanout, degree)), by the native sampler from one seed drawn
    from ``rng``.  Returns (CSC positions, picks per seed)."""
    return rowwise_sample_native(csc.indptr, csc.src, nodes, fanout,
                                 replace, int(rng.integers(1 << 62)))


def _pick_uniform_plain(csc: _HostCSC, nodes: np.ndarray, fanout: int,
                        replace: bool, rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain numpy version of ``_pick_uniform``: the same counts from
    other draws.  It draws the native sampler's seed first and leaves it
    unused, as the JAX package's numpy fallback does, so that it gives
    that fallback's picks from one generator."""
    rng.integers(1 << 62)
    starts = csc.indptr[nodes].astype(np.int64)
    degs = (csc.indptr[nodes + 1] - csc.indptr[nodes]).astype(np.int64)
    if replace:
        # fanout picks per seed; a seed without in-edges gets none
        nz = degs > 0
        r = rng.random((nz.sum(), fanout))
        pick = (r * degs[nz][:, None]).astype(np.int64)
        pos = (starts[nz][:, None] + pick).reshape(-1)
        return pos, np.where(nz, fanout, 0).astype(np.int32)
    pos_list = []
    for s, c in zip(starts, degs):
        if c:
            pos_list.append(s + rng.choice(int(c), size=min(fanout, int(c)),
                                           replace=False))
    pos = np.concatenate(pos_list) if pos_list else np.zeros(0, np.int64)
    return pos, np.minimum(degs, fanout).astype(np.int32)


def sample_neighbors(g: Graph, nodes: Sequence[int], fanout: int,
                     replace: bool = False,
                     prob: Optional[np.ndarray] = None,
                     rng: Optional[np.random.Generator] = None
                     ) -> Tuple[Graph, np.ndarray]:
    """Pick up to ``fanout`` in-edges per seed (fanout=-1: all), uniformly
    or by the per-edge weights ``prob`` (user order), with or without
    replacement.

    Returns (frontier, edge_ids): the frontier keeps the original node ids
    (g's node counts); edge_ids are the user-order ids of the picked
    edges."""
    rng = rng or np.random.default_rng()
    csc = _get_csc(g)
    nodes = np.asarray(nodes, dtype=np.int64)
    if fanout >= 0 and prob is None:
        pos, counts = _pick_uniform(csc, nodes, fanout, replace, rng)
        return _frontier(csc, pos, np.repeat(nodes, counts))
    starts = csc.indptr[nodes].astype(np.int64)
    degs = (csc.indptr[nodes + 1] - csc.indptr[nodes]).astype(np.int64)

    if fanout < 0:          # take all in-edges
        pos = np.concatenate([np.arange(s, s + c)
                              for s, c in zip(starts, degs)]) \
            if len(nodes) else np.zeros(0, np.int64)
        dst_sel = np.repeat(nodes, degs)
    elif replace:
        # weighted with replacement: inverse CDF over each seed's prefix
        # sums of the edge weights
        nz = degs > 0
        w = prob[csc.eid].astype(np.float64)
        cumw = np.concatenate([[0.0], np.cumsum(w)])
        lo, hi = cumw[starts[nz]], cumw[starts[nz] + degs[nz]]
        r = lo[:, None] + rng.random((int(nz.sum()), fanout)) \
            * (hi - lo)[:, None]
        pick = np.searchsorted(cumw, r.reshape(-1), side="right") - 1
        pos = np.minimum(pick, np.repeat(starts[nz] + degs[nz] - 1, fanout))
        dst_sel = np.repeat(nodes[nz], fanout)
    else:
        # weighted without replacement: a partial permutation per seed
        pos_list, dst_list = [], []
        for v, s, c in zip(nodes, starts, degs):
            if c == 0:
                continue
            k = min(fanout, int(c))
            p = prob[csc.eid[s:s + c]].astype(np.float64)
            sel = rng.choice(int(c), size=k, replace=False, p=p / p.sum())
            pos_list.append(s + sel)
            dst_list.append(np.full(k, v, np.int64))
        pos = np.concatenate(pos_list) if pos_list else np.zeros(0, np.int64)
        dst_sel = np.concatenate(dst_list) if dst_list else \
            np.zeros(0, np.int64)
    return _frontier(csc, pos, dst_sel)


def _round_up_pow2(n: int, floor: int = 128) -> int:
    r = floor
    while r < n:
        r <<= 1
    return r


class MultiLayerNeighborSampler:
    """One bipartite block per GNN layer (sample_neighbors, then to_block),
    outermost first.  With ``pad`` the blocks have static shapes: num_src
    rounded up to a power of two, the edges padded to len(seeds) * fanout
    with masked edges.  The blocks stay on the host."""

    def __init__(self, fanouts: Sequence[int], replace: bool = False,
                 pad: bool = True, seed: Optional[int] = None):
        self.fanouts = list(fanouts)
        self.replace = replace
        self.pad = pad
        self.rng = np.random.default_rng(seed)

    def sample_blocks(self, g: Graph, seeds: Sequence[int]
                      ) -> Tuple[List[Graph], np.ndarray, np.ndarray]:
        """Returns (blocks outermost-first, input_node_ids, seed_ids)."""
        seeds = np.asarray(seeds, dtype=np.int32)
        blocks: List[Graph] = []
        cur = seeds
        for fanout in reversed(self.fanouts):
            frontier, eids = sample_neighbors(g, cur, fanout,
                                              replace=self.replace,
                                              rng=self.rng)
            pad_src = pad_e = None
            if self.pad and fanout > 0:
                pad_e = len(cur) * fanout
                pad_src = _round_up_pow2(len(cur) + pad_e)
            blk, src_ids, _ = to_block(frontier, cur, pad_num_src=pad_src,
                                       pad_num_edges=pad_e)
            blk.edata["_ID"] = np.pad(eids, (0, blk.num_edges() - len(eids)))
            blocks.insert(0, blk)
            cur = src_ids
        return blocks, cur, seeds


class NodeDataLoader:
    """Minibatches over seed nodes: yields (input_nodes, seeds, blocks).
    The last partial batch is padded to ``batch_size`` with repeats of its
    first seed, so that shapes stay static."""

    def __init__(self, g: Graph, nids: Sequence[int],
                 sampler: MultiLayerNeighborSampler, batch_size: int,
                 shuffle: bool = True, drop_last: bool = False,
                 seed: Optional[int] = None):
        self.g = g
        self.nids = np.asarray(nids, dtype=np.int32)
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.nids)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self):
        order = self.rng.permutation(len(self.nids)) if self.shuffle \
            else np.arange(len(self.nids))
        bs = self.batch_size
        for i in range(0, len(order) - (bs - 1 if self.drop_last else 0), bs):
            batch = self.nids[order[i:i + bs]]
            if len(batch) < bs:
                batch = np.concatenate(
                    [batch, batch[np.zeros(bs - len(batch), np.int64)]])
            blocks, input_nodes, seeds = self.sampler.sample_blocks(
                self.g, batch)
            yield input_nodes, seeds, blocks


class GraphDataLoader:
    """Minibatches over a graph-classification dataset: yields
    (batched_graph, stacked_features, labels) of ``batch_size`` graphs
    each; a last partial batch is dropped."""

    def __init__(self, graphs, features, labels, batch_size: int,
                 shuffle: bool = True, seed: Optional[int] = None):
        self.graphs = list(graphs)
        self.features = list(features)
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.graphs) // self.batch_size

    def __iter__(self):
        order = self.rng.permutation(len(self.graphs)) if self.shuffle \
            else np.arange(len(self.graphs))
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            sel = order[i:i + bs]
            bg = batch_graphs([self.graphs[j] for j in sel])
            x = np.concatenate([self.features[j] for j in sel])
            yield bg, x, self.labels[sel]


def select_topk(g: Graph, k: int, weight: np.ndarray,
                nodes: Optional[Sequence[int]] = None):
    """Keep the k highest-weight in-edges of each node (``weight`` per
    edge in user order).  Returns (frontier, edge_ids) as
    sample_neighbors."""
    csc = _get_csc(g)
    weight = np.asarray(weight)
    if nodes is None:
        nodes = np.arange(csc.num_dst, dtype=np.int64)
    else:
        nodes = np.asarray(nodes, dtype=np.int64)
    pos_list, dst_list = [], []
    for v in nodes:
        lo, hi = csc.indptr[v], csc.indptr[v + 1]
        if hi == lo:
            continue
        w = weight[csc.eid[lo:hi]]
        kk = min(k, hi - lo)
        sel = np.argpartition(-w, kk - 1)[:kk] if kk < hi - lo \
            else np.arange(hi - lo)
        pos_list.append(lo + sel)
        dst_list.append(np.full(kk, v, np.int64))
    pos = np.concatenate(pos_list) if pos_list else np.zeros(0, np.int64)
    dsts = np.concatenate(dst_list) if dst_list else np.zeros(0, np.int64)
    return _frontier(csc, pos, dsts)


def sample_layer_neighbors(g: Graph, seeds: Sequence[int], layer_size: int,
                           rng: Optional[np.random.Generator] = None):
    """Layer-wise (LADIES/FastGCN-style) sampling: one shared set of at
    most ``layer_size`` source nodes for the whole layer.  Returns
    (frontier, edge_ids): the edges from the sampled sources into the
    seeds."""
    rng = rng or np.random.default_rng()
    csc = _get_csc(g)
    seeds = np.asarray(seeds, dtype=np.int64)
    pos_all = np.concatenate([np.arange(csc.indptr[v], csc.indptr[v + 1])
                              for v in seeds]) if len(seeds) else \
        np.zeros(0, np.int64)
    cand = np.unique(csc.src[pos_all])
    if len(cand) > layer_size:
        cand = rng.choice(cand, size=layer_size, replace=False)
    sel_mask = np.zeros(csc.num_src, bool)
    sel_mask[cand] = True
    keep = sel_mask[csc.src[pos_all]]
    pos = pos_all[keep]
    dsts = np.repeat(seeds, csc.indptr[seeds + 1] - csc.indptr[seeds])[keep]
    return _frontier(csc, pos, dsts)


class EdgeSampler:
    """Minibatches of positive edges, with chunked negative nodes for link
    prediction: each batch is a dict of ``src``, ``dst``, ``eid`` (user
    order) and, with ``neg_sample_size``, ``neg`` (one row of negative
    nodes per chunk of ``chunk_size`` edges) and ``neg_is_head``."""

    def __init__(self, g: Graph, batch_size: int, neg_sample_size: int = 0,
                 chunk_size: int = 1, negative_mode: str = "tail",
                 shuffle: bool = True, seed: Optional[int] = None):
        self.g = g
        self.batch_size = batch_size
        self.neg_sample_size = neg_sample_size
        self.chunk_size = chunk_size
        self.negative_mode = negative_mode
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        s, d = self.g.host_edges()
        E = len(s)
        order = self.rng.permutation(E) if self.shuffle else np.arange(E)
        bs = self.batch_size
        for i in range(0, E - bs + 1, bs):
            sel = order[i:i + bs]
            batch = {"src": s[sel], "dst": d[sel], "eid": sel.astype(np.int32)}
            if self.neg_sample_size:
                C = -(-bs // self.chunk_size)
                batch["neg"] = self.rng.integers(
                    0, self.g.num_nodes(),
                    (C, self.neg_sample_size)).astype(np.int32)
                batch["neg_is_head"] = self.negative_mode == "head"
            yield batch
