"""Graph transforms (host-side numpy and scipy), as
``dgl_hack_tpu.core.transform``.  A transform of a graph lands on that
graph's device (``to_block``'s block and ``knn_graph``'s graph on the
CPU); node and edge id arrays come back as numpy, as there."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from .graph import Graph, _build

__all__ = ["khop_graph", "line_graph", "to_bidirected", "add_self_loop",
           "remove_self_loop", "to_simple", "remove_edges", "node_subgraph",
           "edge_subgraph", "in_subgraph", "out_subgraph", "compact_graphs",
           "to_block", "knn_graph", "laplacian_lambda_max", "khop_adj",
           "segmented_knn_graph", "reorder_graph", "add_edges", "add_nodes"]


def _adj(g: Graph) -> sp.csr_matrix:
    s, d = g.host_edges()
    n = g.num_nodes()
    return sp.csr_matrix((np.ones(len(s)), (s, d)), shape=(n, n))


def _on(g: Graph, src, dst, num_src: int, num_dst: int,
        is_block: bool = False) -> Graph:
    """A graph built from (src, dst) on g's device."""
    return _build(np.asarray(src).astype(np.int32),
                  np.asarray(dst).astype(np.int32), num_src, num_dst,
                  is_block=is_block).to(g.device)


def khop_graph(g: Graph, k: int) -> Graph:
    """Edges u -> v for every k-hop path, with multiplicity."""
    coo = (_adj(g) ** k).tocoo()
    n = coo.data.astype(np.int64)
    return _on(g, np.repeat(coo.row, n), np.repeat(coo.col, n),
               g.num_nodes(), g.num_nodes())


def line_graph(g: Graph, backtracking: bool = True) -> Graph:
    """One node per edge (user order); e1 -> e2 where dst(e1) ==
    src(e2), without e2 = reverse(e1) unless ``backtracking``."""
    s, d = g.host_edges()
    E = len(s)
    by_src: dict = {}
    for e in range(E):
        by_src.setdefault(s[e], []).append(e)
    ls, ld = [], []
    for e1 in range(E):
        for e2 in by_src.get(d[e1], ()):
            if not backtracking and s[e1] == d[e2] and d[e1] == s[e2]:
                continue
            ls.append(e1)
            ld.append(e2)
    return _on(g, ls, ld, E, E)


def to_bidirected(g: Graph) -> Graph:
    """The symmetrised simple graph."""
    s, d = g.host_edges()
    uniq = np.unique(np.stack([np.concatenate([s, d]),
                               np.concatenate([d, s])], 1), axis=0)
    return _on(g, uniq[:, 0], uniq[:, 1], g.num_nodes(), g.num_nodes())


def add_self_loop(g: Graph) -> Graph:
    """g's edges (user order) followed by one loop per node; the result
    lands on g's device."""
    s, d = g.host_edges()
    loop = np.arange(g.num_nodes(), dtype=np.int32)
    return _on(g, np.concatenate([s, loop]), np.concatenate([d, loop]),
               g.num_nodes(), g.num_nodes())


def remove_self_loop(g: Graph) -> Graph:
    """g without its loops; the result lands on g's device."""
    s, d = g.host_edges()
    keep = s != d
    return _on(g, s[keep], d[keep], g.num_nodes(), g.num_nodes())


def to_simple(g: Graph, return_counts: bool = False):
    """Parallel edges merged (with each pair's count)."""
    s, d = g.host_edges()
    pairs, counts = np.unique(np.stack([s, d], 1), axis=0,
                              return_counts=True)
    out = _on(g, pairs[:, 0], pairs[:, 1], g.num_src_nodes, g.num_dst_nodes,
              g.is_block)
    return (out, counts.astype(np.int32)) if return_counts else out


def remove_edges(g: Graph, eids: Sequence[int]) -> Graph:
    """g without the edges ``eids`` (user order)."""
    s, d = g.host_edges()
    keep = np.ones(len(s), bool)
    keep[np.asarray(eids, np.int64)] = False
    return _on(g, s[keep], d[keep], g.num_src_nodes, g.num_dst_nodes,
               g.is_block)


def node_subgraph(g: Graph, nodes: Sequence[int], relabel: bool = True):
    """The subgraph induced by ``nodes``: (subgraph, node ids, edge ids)."""
    nodes = np.asarray(nodes, np.int64)
    s, d = g.host_edges()
    sel = np.zeros(g.num_nodes(), bool)
    sel[nodes] = True
    keep = sel[s] & sel[d]
    new_id = np.full(g.num_nodes(), -1, np.int32)
    new_id[nodes] = np.arange(len(nodes), dtype=np.int32)
    sub = _on(g, new_id[s[keep]], new_id[d[keep]], len(nodes), len(nodes))
    return sub, nodes.astype(np.int32), np.nonzero(keep)[0].astype(np.int32)


def edge_subgraph(g: Graph, eids: Sequence[int], relabel_nodes: bool = True):
    """The subgraph of the edges ``eids``: (subgraph, node ids, edge ids);
    without ``relabel_nodes`` it keeps every node of g."""
    eids = np.asarray(eids, np.int64)
    s, d = g.host_edges()
    es, ed = s[eids], d[eids]
    if relabel_nodes:
        nodes = np.unique(np.concatenate([es, ed]))
        new_id = np.full(g.num_nodes(), -1, np.int32)
        new_id[nodes] = np.arange(len(nodes), dtype=np.int32)
        sub = _on(g, new_id[es], new_id[ed], len(nodes), len(nodes))
        return sub, nodes.astype(np.int32), eids.astype(np.int32)
    sub = _on(g, es, ed, g.num_nodes(), g.num_nodes())
    return sub, np.arange(g.num_nodes(), dtype=np.int32), \
        eids.astype(np.int32)


def in_subgraph(g: Graph, nodes: Sequence[int]):
    """Every in-edge of ``nodes``, node ids kept."""
    sel = np.zeros(g.num_dst_nodes, bool)
    sel[np.asarray(nodes, np.int64)] = True
    return edge_subgraph(g, np.nonzero(sel[g.host_edges()[1]])[0],
                         relabel_nodes=False)


def out_subgraph(g: Graph, nodes: Sequence[int]):
    """Every out-edge of ``nodes``, node ids kept."""
    sel = np.zeros(g.num_src_nodes, bool)
    sel[np.asarray(nodes, np.int64)] = True
    return edge_subgraph(g, np.nonzero(sel[g.host_edges()[0]])[0],
                         relabel_nodes=False)


def compact_graphs(graphs, always_preserve=None):
    """The graphs without the nodes no edge of any of them touches,
    relabelled consistently: (new graphs, src node ids, dst node ids)."""
    single = isinstance(graphs, Graph)
    if single:
        graphs = [graphs]
    src_used, dst_used = [], []
    for g in graphs:
        s, d = g.host_edges()
        src_used.append(s)
        dst_used.append(d)
    if always_preserve is not None:
        dst_used.append(np.asarray(always_preserve, np.int32))
    src_ids = np.unique(np.concatenate(src_used))
    dst_ids = np.unique(np.concatenate(dst_used))
    smap = np.full(graphs[0].num_src_nodes, -1, np.int32)
    smap[src_ids] = np.arange(len(src_ids), dtype=np.int32)
    dmap = np.full(graphs[0].num_dst_nodes, -1, np.int32)
    dmap[dst_ids] = np.arange(len(dst_ids), dtype=np.int32)
    outs = []
    for g in graphs:
        s, d = g.host_edges()
        outs.append(_on(g, smap[s], dmap[d], len(src_ids), len(dst_ids),
                        g.is_block))
    return (outs[0] if single else outs), src_ids.astype(np.int32), \
        dst_ids.astype(np.int32)


def to_block(frontier: Graph, dst_nodes: Optional[np.ndarray] = None,
             include_dst_in_src: bool = True,
             pad_num_src: Optional[int] = None,
             pad_num_edges: Optional[int] = None):
    """Bipartite compaction of a sampled frontier, the minibatch block
    builder, on the host in numpy as the JAX package's.

    dst nodes are ``dst_nodes`` (default: the frontier's unique dst); src
    nodes are the dst nodes first (dstdata is a prefix of srcdata) and then
    the other source endpoints.  Where ``dst_nodes`` repeats an id, the
    last of its places wins, in both maps.  ``pad_num_src`` pads the src
    set and ``pad_num_edges`` the edges (to node 0 -> node 0, mask False);
    asking for edge padding always carries a mask and the internal/user
    permutations, even at an exact fit, so that every padded block has the
    same structure.  The block's tensors are on the CPU.

    Returns (block, src_orig_ids, dst_orig_ids)."""
    s, d = frontier.host_edges()
    if dst_nodes is None:
        dst_nodes = np.unique(d)
    dst_nodes = np.asarray(dst_nodes, np.int32)
    n_dst = len(dst_nodes)

    dmap = np.full(frontier.num_dst_nodes, -1, np.int32)
    dmap[dst_nodes] = np.arange(n_dst, dtype=np.int32)

    if include_dst_in_src:
        smap = np.full(frontier.num_src_nodes, -1, np.int64)
        smap[dst_nodes] = np.arange(n_dst)
        extra = np.unique(s[smap[s] < 0]) if len(s) else np.zeros(0, np.int64)
        extra = extra[smap[extra] < 0]
        smap[extra] = n_dst + np.arange(len(extra))
        src_ids = np.concatenate([dst_nodes, extra.astype(np.int32)])
    else:
        src_ids = np.unique(s)
        smap = np.full(frontier.num_src_nodes, -1, np.int64)
        smap[src_ids] = np.arange(len(src_ids))
    n_src = len(src_ids)

    bs = smap[s].astype(np.int32)
    bd = dmap[d]
    keep = bd >= 0
    bs, bd = bs[keep], bd[keep]
    E = len(bs)

    num_src = n_src if pad_num_src is None else max(pad_num_src, n_src)
    mask = None
    if pad_num_edges is not None:
        pad = max(pad_num_edges - E, 0)
        bs = np.concatenate([bs, np.zeros(pad, np.int32)])
        bd = np.concatenate([bd, np.zeros(pad, np.int32)])
        mask = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    blk = _build(bs, bd, num_src, n_dst, is_block=True, edge_mask=mask,
                 force_perm=pad_num_edges is not None)
    if pad_num_src is not None and num_src > n_src:
        src_ids = np.concatenate(
            [src_ids, np.zeros(num_src - n_src, np.int32)])
    return blk, src_ids.astype(np.int32), dst_nodes


def laplacian_lambda_max(g: Graph) -> List[float]:
    """The largest eigenvalue of ``I - D^-1/2 A D^-1/2`` per graph of a
    batch (host scipy; scales ChebConv)."""
    import scipy.sparse.linalg as spla
    sizes = g.batch_num_nodes or (g.num_nodes(),)
    s, d = g.host_edges()
    out = []
    off = 0
    for n in sizes:
        m = (s >= off) & (s < off + n)
        a = sp.coo_matrix((np.ones(int(m.sum())), (s[m] - off, d[m] - off)),
                          shape=(n, n)).tocsr()
        deg = np.asarray(a.sum(1)).ravel()
        dmat = sp.diags(np.where(deg > 0, deg, 1.0) ** -0.5)
        lap = sp.eye(n) - dmat @ a @ dmat
        if n <= 2:
            out.append(float(np.linalg.eigvals(lap.toarray()).real.max()))
        else:
            val = spla.eigs(lap, 1, which="LM", return_eigenvectors=False,
                            tol=1e-6)
            out.append(float(val.real[0]))
        off += n
    return out


def _knn_edges(x: np.ndarray, k: int):
    """(src, dst): the k nearest points of each point (itself included)."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    nbrs = np.argsort(d2, axis=1)[:, :k]
    return nbrs.reshape(-1), np.repeat(np.arange(len(x)), k)


def _points(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def knn_graph(x, k: int) -> Graph:
    """The k-nearest-neighbour graph of the points ``x`` (N, D), edges
    neighbour -> point, on the CPU."""
    x = _points(x)
    src, dst = _knn_edges(x, k)
    return _build(src.astype(np.int32), dst.astype(np.int32), len(x),
                  len(x), is_block=False)


def segmented_knn_graph(x, k: int, segs) -> Graph:
    """``knn_graph`` within each run of ``segs`` points, as one graph on
    the CPU."""
    x = _points(x)
    offs = np.concatenate([[0], np.cumsum(segs)]).astype(np.int64)
    srcs, dsts = [], []
    for i in range(len(segs)):
        s, d = _knn_edges(x[offs[i]:offs[i + 1]], k)
        srcs.append(s + offs[i])
        dsts.append(d + offs[i])
    return _build(np.concatenate(srcs).astype(np.int32),
                  np.concatenate(dsts).astype(np.int32),
                  int(offs[-1]), int(offs[-1]), is_block=False)


def reorder_graph(g: Graph, method: str = "degree"):
    """g with its nodes relabelled ('degree': by in-degree, descending;
    'random': a seeded permutation): (new graph, orig_ids), with
    ``orig_ids[new_id] = old_id`` so that features follow as
    ``x[orig_ids]``."""
    n = g.num_nodes()
    if method == "degree":
        indptr = g.host("csc_indptr")
        orig_ids = np.argsort(-(indptr[1:] - indptr[:-1]),
                              kind="stable").astype(np.int32)
    elif method == "random":
        orig_ids = np.random.default_rng(0).permutation(n).astype(np.int32)
    else:
        raise ValueError(method)
    new_id = np.empty(n, np.int32)
    new_id[orig_ids] = np.arange(n, dtype=np.int32)
    s, d = g.host_edges()
    return _on(g, new_id[s], new_id[d], n, n), orig_ids


def add_edges(g: Graph, src, dst) -> Graph:
    """A new graph: g's edges, then (src, dst); nodes grow to fit."""
    s, d = g.host_edges()
    s2 = np.concatenate([s, np.asarray(src, np.int32)])
    d2 = np.concatenate([d, np.asarray(dst, np.int32)])
    n = max(g.num_nodes(), int(s2.max(initial=-1)) + 1,
            int(d2.max(initial=-1)) + 1)
    return _on(g, s2, d2, n, n)


def add_nodes(g: Graph, num: int) -> Graph:
    """A new graph: g with ``num`` more nodes."""
    s, d = g.host_edges()
    n = g.num_nodes() + int(num)
    return _on(g, s, d, n, n)


def khop_adj(g: Graph, k: int) -> np.ndarray:
    """The dense k-hop adjacency A^k, A[dst, src] with multiplicity, as a
    float32 numpy array."""
    a = _adj(g).T.astype(np.float64)
    return np.linalg.matrix_power(a.toarray(), k).astype(np.float32)
