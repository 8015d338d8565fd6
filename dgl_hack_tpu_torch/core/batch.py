"""Graph batching: disjoint union with per-graph node and edge counts.

The same design as ``dgl_hack_tpu.core.batch``: the batched graph carries
``batch_num_nodes``/``batch_num_edges`` (tuples of ints), from which the
readouts (``ops/readout.py``) take their segments.  In the batched graph's
internal (CSC) order the edges of graph i come before those of graph
i + 1, since its dst ids do, so a graph's edges are one run of rows.

The structure is built on the host with numpy and placed on the device of
the first graph.  ``batch_hetero``/``unbatch_hetero`` do the same for
heterographs, relation by relation.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .graph import Graph, _build

Tensor = torch.Tensor


def batch(graphs: Sequence[Graph]) -> Graph:
    """Disjoint union of homogeneous graphs; features present in every
    graph are concatenated (edge features in user order)."""
    if any(g.is_block for g in graphs):
        raise ValueError("cannot batch blocks")
    n_nodes = [g.num_nodes() for g in graphs]
    n_edges = [g.num_edges() for g in graphs]
    node_off = np.concatenate([[0], np.cumsum(n_nodes)]).astype(np.int64)
    srcs, dsts = [], []
    for g, off in zip(graphs, node_off[:-1]):
        s, d = g.host_edges()
        srcs.append(s + off)
        dsts.append(d + off)
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    bg = _build(src.astype(np.int32), dst.astype(np.int32),
                int(node_off[-1]), int(node_off[-1]), is_block=False)
    bg.batch_num_nodes = tuple(n_nodes)
    bg.batch_num_edges = tuple(n_edges)
    if graphs:
        bg = bg.to(graphs[0].device)
        common_n = set(graphs[0].ndata.keys())
        common_e = set(graphs[0].edata.keys())
        for g in graphs[1:]:
            common_n &= set(g.ndata.keys())
            common_e &= set(g.edata.keys())
        for k in sorted(common_n):
            bg.ndata[k] = torch.cat([g.ndata[k] for g in graphs])
        for k in sorted(common_e):
            bg.edata[k] = torch.cat([g.edata[k] for g in graphs])
    return bg


def unbatch(bg: Graph) -> List[Graph]:
    """Split a batched graph back into its components, features too."""
    n_nodes = bg.batch_num_nodes
    if n_nodes is None:
        raise ValueError("graph was not produced by batch()")
    n_edges = bg.batch_num_edges
    node_off = np.concatenate([[0], np.cumsum(n_nodes)]).astype(np.int64)
    edge_off = np.concatenate([[0], np.cumsum(n_edges)]).astype(np.int64)
    src, dst = bg.host_edges()
    out = []
    for i, (nn_, ne) in enumerate(zip(n_nodes, n_edges)):
        e0, e1 = edge_off[i], edge_off[i + 1]
        g = _build((src[e0:e1] - node_off[i]).astype(np.int32),
                   (dst[e0:e1] - node_off[i]).astype(np.int32), nn_, nn_,
                   is_block=False).to(bg.device)
        for k in bg.ndata.keys():
            g.ndata[k] = bg.ndata[k][node_off[i]:node_off[i + 1]]
        for k in bg.edata.keys():
            g.edata[k] = bg.edata[k][e0:e1]
        out.append(g)
    return out


def node_segment_ids(bg: Graph) -> Tensor:
    """(num_nodes,) int32 graph id of each node."""
    ids = np.repeat(np.arange(len(bg.batch_num_nodes)), bg.batch_num_nodes)
    return torch.from_numpy(ids.astype(np.int32)).to(bg.device)


def edge_segment_ids(bg: Graph) -> Tensor:
    """(num_edges,) int32 graph id of each edge, in internal order."""
    ids = np.repeat(np.arange(len(bg.batch_num_edges)), bg.batch_num_edges)
    ids = torch.from_numpy(ids.astype(np.int32)).to(bg.device)
    if bg.int2user is not None:
        ids = ids[bg.int2user]
    return ids


def num_graphs(bg: Graph) -> int:
    """Number of graphs in a batch; 1 for a graph not made by batch()."""
    return 1 if bg.batch_num_nodes is None else len(bg.batch_num_nodes)


def batch_hetero(graphs):
    """Disjoint union of heterographs sharing one metagraph; per-ntype
    node frames and per-relation edge frames (user order) present in
    every graph are concatenated.  Placed on the first graph's device."""
    from .heterograph import HeteroGraph
    if not graphs:
        raise ValueError("batch_hetero needs at least one graph")
    cets = graphs[0].canonical_etypes
    ntypes = graphs[0].ntypes
    for g in graphs[1:]:
        if g.canonical_etypes != cets or g.ntypes != ntypes:
            raise ValueError("heterographs must share one metagraph")
    device = graphs[0].device

    bnn = {nt: tuple(g.num_nodes(nt) for g in graphs) for nt in ntypes}
    bne = {c: tuple(g.num_edges(c) for g in graphs) for c in cets}
    node_off = {nt: np.concatenate([[0], np.cumsum(bnn[nt])])
                for nt in ntypes}
    num_nodes = {nt: int(node_off[nt][-1]) for nt in ntypes}

    relations = {}
    for c in cets:
        st, _, dt = c
        srcs, dsts = [], []
        for i, g in enumerate(graphs):
            s, d = g.relations[c].host_edges()
            srcs.append(s + node_off[st][i])
            dsts.append(d + node_off[dt][i])
        rel = _build(np.concatenate(srcs).astype(np.int32),
                     np.concatenate(dsts).astype(np.int32), num_nodes[st],
                     num_nodes[dt], is_block=(st != dt)).to(device)
        common_e = set(graphs[0].relations[c].edata.keys())
        for g in graphs[1:]:
            common_e &= set(g.relations[c].edata.keys())
        for k in sorted(common_e):
            rel.edata[k] = torch.cat([g.relations[c].edata[k]
                                      for g in graphs])
        relations[c] = rel

    node_frames = {}
    for nt in ntypes:
        common_n = set(graphs[0].nodes_data(nt).keys())
        for g in graphs[1:]:
            common_n &= set(g.nodes_data(nt).keys())
        node_frames[nt] = {k: torch.cat([g.nodes_data(nt)[k]
                                         for g in graphs])
                           for k in sorted(common_n)}
    return HeteroGraph(relations, num_nodes, node_frames,
                       batch_info=(bnn, bne))


def unbatch_hetero(bg):
    """Split a batched heterograph back into its components, features
    too."""
    from .heterograph import HeteroGraph
    if bg._batch_info is None:
        raise ValueError("graph was not produced by batch_hetero()")
    bnn, bne = bg._batch_info
    node_off = {nt: np.concatenate([[0], np.cumsum(cnt)])
                for nt, cnt in bnn.items()}
    edge_off = {c: np.concatenate([[0], np.cumsum(cnt)])
                for c, cnt in bne.items()}
    out = []
    for i in range(bg.batch_size):
        rels, frames = {}, {}
        for c, rel in bg.relations.items():
            st, _, dt = c
            s, d = rel.host_edges()
            e0, e1 = edge_off[c][i], edge_off[c][i + 1]
            rg = _build((s[e0:e1] - node_off[st][i]).astype(np.int32),
                        (d[e0:e1] - node_off[dt][i]).astype(np.int32),
                        int(bnn[st][i]), int(bnn[dt][i]),
                        is_block=(st != dt)).to(rel.device)
            for k in rel.edata.keys():
                rg.edata[k] = rel.edata[k][e0:e1]
            rels[c] = rg
        for nt in bnn:
            n0, n1 = node_off[nt][i], node_off[nt][i + 1]
            view = bg.nodes_data(nt)
            frames[nt] = {k: view[k][n0:n1] for k in view.keys()}
        out.append(HeteroGraph(rels, {nt: int(c[i]) for nt, c in bnn.items()},
                               frames))
    return out
