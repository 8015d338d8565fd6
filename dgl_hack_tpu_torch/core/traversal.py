"""Graph traversals as frontier batches, on the host (numpy), as
``dgl_hack_tpu.core.traversal``: BFS, topological and DFS orders returned
as lists of per-step node (or user-order edge id) arrays, which
``propagate`` feeds to message passing one frontier at a time."""
from __future__ import annotations

from typing import List

import numpy as np

from .graph import Graph, _user_eids


def _csr(g: Graph):
    """(indptr, dst of each out-edge in CSR order)."""
    return g.host("csr_indptr"), g.host("dst")[g.host("csr_eids")]


def bfs_nodes_generator(g: Graph, source, reverse: bool = False
                        ) -> List[np.ndarray]:
    """Per-level node frontiers of a BFS from ``source`` (along in-edges
    with ``reverse``)."""
    if reverse:
        indptr, nbr = g.host("csc_indptr"), g.host("src")
    else:
        indptr, nbr = _csr(g)
    visited = np.zeros(g.num_nodes(), bool)
    frontier = np.atleast_1d(np.asarray(source, np.int64))
    visited[frontier] = True
    out = []
    while len(frontier):
        out.append(frontier.astype(np.int32))
        nxt = np.unique(np.concatenate(
            [nbr[indptr[v]:indptr[v + 1]] for v in frontier]))
        nxt = nxt[~visited[nxt]]
        visited[nxt] = True
        frontier = nxt
    return out


def bfs_edges_generator(g: Graph, source, reverse: bool = False
                        ) -> List[np.ndarray]:
    """Per-level frontiers of the edge ids (user order) that enter newly
    visited nodes."""
    s, d = g.host_edges()
    if reverse:
        s, d = d, s
    visited = np.zeros(g.num_nodes(), bool)
    visited[np.atleast_1d(np.asarray(source, np.int64))] = True
    out = []
    while True:
        cand = np.nonzero(visited[s] & ~visited[d])[0]
        if not len(cand):
            break
        out.append(cand.astype(np.int32))
        visited[d[cand]] = True
    return out


def topological_nodes_generator(g: Graph, reverse: bool = False
                                ) -> List[np.ndarray]:
    """Topological frontiers: nodes whose in-edges (out-edges with
    ``reverse``) all leave earlier frontiers."""
    if reverse:
        indptr = g.host("csr_indptr")
        deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
        indptr, nbr = g.host("csc_indptr"), g.host("src")
    else:
        cindptr = g.host("csc_indptr")
        deg = (cindptr[1:] - cindptr[:-1]).astype(np.int64)
        indptr, nbr = _csr(g)
    frontier = np.nonzero(deg == 0)[0]
    out = []
    while len(frontier):
        out.append(frontier.astype(np.int32))
        cnt = np.zeros(g.num_nodes(), np.int64)
        for v in frontier:
            np.add.at(cnt, nbr[indptr[v]:indptr[v + 1]], 1)
        deg = deg - cnt
        deg[frontier] = -1
        frontier = np.nonzero(deg == 0)[0]
    return out


def _dfs_arrays(g: Graph, reverse: bool):
    """(indptr, neighbour, user edge id) of each node's out-edges (in-edges
    with ``reverse``) in walk order."""
    if reverse:
        return g.host("csc_indptr"), g.host("src"), _user_eids(g)
    indptr, nbr = _csr(g)
    return indptr, nbr, _user_eids(g)[g.host("csr_eids")]


def dfs_edges_generator(g: Graph, source, reverse: bool = False
                        ) -> List[np.ndarray]:
    """The tree edges of a DFS from each source in turn, one edge id (user
    order) per step."""
    indptr, nbr, eids = _dfs_arrays(g, reverse)
    visited = np.zeros(g.num_nodes(), bool)
    order = []
    for s0 in np.atleast_1d(np.asarray(source, np.int64)):
        if visited[s0]:
            continue
        visited[s0] = True
        stack = [(int(s0), 0)]
        while stack:
            v, i = stack.pop()
            if i >= indptr[v + 1] - indptr[v]:
                continue
            stack.append((v, i + 1))
            pos = indptr[v] + i
            u = nbr[pos]
            if not visited[u]:
                visited[u] = True
                order.append(eids[pos])
                stack.append((int(u), 0))
    return [np.asarray([e], np.int32) for e in order]


def dfs_labeled_edges_generator(g: Graph, source, reverse: bool = False,
                                has_reverse_edge: bool = False,
                                has_nontree_edge: bool = False):
    """DFS with edge labels: (edge frontiers, label frontiers), labels 0
    forward (tree), 1 reverse (back along a tree edge when its subtree is
    done), 2 nontree."""
    FORWARD, REVERSE, NONTREE = 0, 1, 2
    indptr, nbr, eids = _dfs_arrays(g, reverse)
    visited = np.zeros(g.num_nodes(), bool)
    edges, labels = [], []
    for s0 in np.atleast_1d(np.asarray(source, np.int64)):
        if visited[s0]:
            continue
        visited[s0] = True
        stack = [(int(s0), 0, -1)]     # (node, next neighbour, tree edge in)
        while stack:
            v, i, in_eid = stack.pop()
            if i >= indptr[v + 1] - indptr[v]:
                if has_reverse_edge and in_eid >= 0:
                    edges.append(in_eid)
                    labels.append(REVERSE)
                continue
            pos = indptr[v] + i
            u = int(nbr[pos])
            eid = int(eids[pos])
            stack.append((v, i + 1, in_eid))
            if not visited[u]:
                visited[u] = True
                edges.append(eid)
                labels.append(FORWARD)
                stack.append((u, 0, eid))
            elif has_nontree_edge:
                edges.append(eid)
                labels.append(NONTREE)
    return ([np.asarray([e], np.int64) for e in edges],
            [np.asarray([lab], np.int64) for lab in labels])
