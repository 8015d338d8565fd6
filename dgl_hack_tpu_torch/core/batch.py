"""Graph batching: disjoint union with per-graph node and edge counts.

The same design as ``dgl_hack_tpu.core.batch``: the batched graph carries
``batch_num_nodes``/``batch_num_edges`` (tuples of ints), from which the
readouts (``ops/readout.py``) take their segments.  In the batched graph's
internal (CSC) order the edges of graph i come before those of graph
i + 1, since its dst ids do, so a graph's edges are one run of rows.

The structure is built on the host with numpy and placed on the device of
the first graph.
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


def _hetero_not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported yet (ROADMAP: Queue 1 item 5, "
        "'core/heterograph.py')")


def batch_hetero(graphs):
    """Heterograph batching needs ``core/heterograph.py``, not ported."""
    raise _hetero_not_ported("batch_hetero")


def unbatch_hetero(bg):
    """Heterograph unbatching needs ``core/heterograph.py``, not ported."""
    raise _hetero_not_ported("unbatch_hetero")
