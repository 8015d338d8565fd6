"""Per-graph readouts over batched graphs, as ``dgl_hack_tpu.ops.readout``.

A graph's nodes are one run of rows of the node features, and in internal
(CSC) order its edges are one run of rows of the edge features
(``core/batch.py``), so sum and mean are sorted-segment sums: K1's
edge-row mode on CUDA (``SegmentSumRows``, its plain version on the CPU),
with the segments cached on the graph.  A weighted readout multiplies
first and then sums.  max, softmax, broadcast and topk are torch ops
(scatter, gather, sort), where the JAX package runs XLA: its ``max`` splits
the cotangent evenly between tied rows, as torch's ``scatter_reduce``
does.  A graph not made by ``batch()`` is one segment.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.graph import Graph
from . import segment
from .cuda.spmm_kernel import (graph_segments, segment_mean_rows,
                               segment_sum_rows)

Tensor = torch.Tensor


def _node_ids(g: Graph):
    seg = graph_segments(g, "nodes")
    return seg.ids, seg.indptr.numel() - 1


def _edge_ids(g: Graph):
    seg = graph_segments(g, "edges")
    return seg.ids, seg.indptr.numel() - 1


def _resolve_n(g: Graph, feat: Union[str, Tensor]) -> Tensor:
    return g.ndata[feat] if isinstance(feat, str) else feat


def _resolve_e(g: Graph, feat: Union[str, Tensor]) -> Tensor:
    """Edge readouts take internal-order data."""
    return g.edata_internal[feat] if isinstance(feat, str) else feat


def _weighted(x: Tensor, w: Optional[Tensor]) -> Tensor:
    if w is None:
        return x
    return x * w.reshape(tuple(w.shape) + (1,) * (x.dim() - w.dim()))


def _rows(g: Graph, kind: str, x: Tensor, mean: bool) -> Tensor:
    seg = graph_segments(g, kind)
    return segment_mean_rows(x, seg) if mean else segment_sum_rows(x, seg)


def sum_nodes(g, feat, weight=None):
    x = _weighted(_resolve_n(g, feat),
                  None if weight is None else _resolve_n(g, weight))
    return _rows(g, "nodes", x, mean=False)


def mean_nodes(g, feat, weight=None):
    x = _weighted(_resolve_n(g, feat),
                  None if weight is None else _resolve_n(g, weight))
    return _rows(g, "nodes", x, mean=True)


def max_nodes(g, feat):
    ids, n = _node_ids(g)
    return segment.segment_max(_resolve_n(g, feat), ids, n)


def sum_edges(g, feat, weight=None):
    x = _weighted(_resolve_e(g, feat),
                  None if weight is None else _resolve_e(g, weight))
    return _rows(g, "edges", x, mean=False)


def mean_edges(g, feat, weight=None):
    x = _weighted(_resolve_e(g, feat),
                  None if weight is None else _resolve_e(g, weight))
    return _rows(g, "edges", x, mean=True)


def max_edges(g, feat):
    ids, n = _edge_ids(g)
    return segment.segment_max(_resolve_e(g, feat), ids, n)


def softmax_nodes(g, feat):
    ids, n = _node_ids(g)
    return segment.segment_softmax(_resolve_n(g, feat), ids, n)


def softmax_edges(g, feat):
    ids, n = _edge_ids(g)
    return segment.segment_softmax(_resolve_e(g, feat), ids, n)


def broadcast_nodes(g, value: Tensor) -> Tensor:
    """(num_graphs, *) -> (num_nodes, *) per-graph broadcast."""
    ids, _ = _node_ids(g)
    return value[ids]


def broadcast_edges(g, value: Tensor) -> Tensor:
    ids, _ = _edge_ids(g)
    return value[ids]


def dense_positions(counts, device):
    """(graph id, position in its graph) of each row of runs of
    ``counts[i]`` rows, for scattering them into a (G, max count) buffer."""
    counts = np.asarray(counts, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    gid = np.repeat(np.arange(counts.shape[0]), counts)
    pos = np.arange(offs[-1]) - offs[gid]
    return (torch.from_numpy(gid).to(device),
            torch.from_numpy(pos).to(device))


def _topk(x: Tensor, counts, k: int, descending: bool,
          idx: Optional[int]) -> Tensor:
    """Rows scattered into a (G, max_n, *) buffer padded with -inf
    (descending) or +inf, sorted along the rows, cut to k.  With ``idx``
    the rows are ranked by column ``idx`` through a stable ascending
    argsort, reversed for descending order (so tied rows come in reverse
    index order, as in the JAX package); else each column is sorted on its
    own."""
    gid, pos = dense_positions(counts, x.device)
    pad = -float("inf") if descending else float("inf")
    dense = x.new_full((len(counts), max(counts)) + tuple(x.shape[1:]), pad)
    dense = dense.index_put((gid, pos), x)
    if idx is None:
        srt = torch.sort(dense, dim=1).values
        return (srt.flip(1) if descending else srt)[:, :k]
    order = torch.argsort(dense[..., idx], dim=1, stable=True)
    order = order.flip(1) if descending else order
    order = order.reshape(order.shape + (1,) * (dense.dim() - 2))
    return torch.take_along_dim(dense, order, dim=1)[:, :k]


def topk_nodes(g, feat, k: int, descending: bool = True,
               idx: Optional[int] = None):
    """Per-graph top-k of node features: (num_graphs, k, *).  A graph of
    fewer than k nodes gets -inf (+inf ascending) rows."""
    counts = g.batch_num_nodes or (g.num_dst_nodes,)
    return _topk(_resolve_n(g, feat), counts, k, descending, idx)


def topk_edges(g, feat, k: int, descending: bool = True,
               idx: Optional[int] = None):
    """Per-graph top-k of edge features (internal order), as
    ``topk_nodes``."""
    counts = g.batch_num_edges or (g.num_edges_static,)
    return _topk(_resolve_e(g, feat), counts, k, descending, idx)
