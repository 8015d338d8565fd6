"""dgl_hack_tpu_torch: the PyTorch/CUDA port of dgl_hack_tpu for an
NVIDIA H100.

The public API mirrors the JAX package's: ``graph()``, ``block()``,
``batch()``/``unbatch()``, the heterographs (``heterograph()``,
``HeteroGraph.multi_update_all`` ..., ``batch_hetero()``/
``unbatch_hetero()``), ``add_self_loop()``/``remove_self_loop()``,
``to_block()`` and the samplers of ``sampling``,
``gspmm()``, ``gsddmm()``, ``edge_softmax()``, ``gat_attention()``,
``prepare_spmm()``, ``prepare_rgcn()``, ``update_all()``/``apply_edges()``/``apply_nodes()``
with the builtin functions of ``fn``, the readouts (``sum_nodes`` …
``topk_edges``), the layers of ``nn`` and the models of ``models``, with
the same tensor layouts.  CUDA tensors run the hand-written kernels under
``csrc/`` (built at first use); CPU tensors run their plain PyTorch
versions.  This package never imports JAX.
"""
from . import function, sampling
from .core.batch import batch, batch_hetero, unbatch, unbatch_hetero
from .core.graph import Graph, block, graph
from .core.heterograph import (HeteroGraph, bipartite, hetero_from_relations,
                               heterograph, metapath_reachable_graph,
                               to_heterogeneous, to_homogeneous)
from .core.message import (EdgeBatch, NodeBatch, apply_edges, apply_nodes,
                           update_all)
from .core.transform import add_self_loop, remove_self_loop, to_block
from .ops import readout, segment
from .ops.cuda.spmm_kernel import prepare_spmm
from .ops.edge_softmax import edge_softmax
from .ops.gat import gat_attention
from .ops.rgcn import prepare_rgcn
from .ops.readout import (broadcast_edges, broadcast_nodes, max_edges,
                          max_nodes, mean_edges, mean_nodes, softmax_edges,
                          softmax_nodes, sum_edges, sum_nodes, topk_edges,
                          topk_nodes)
from .ops.sddmm import gsddmm
from .ops.spmm import copy_u_sum, gspmm, u_mul_e_sum

fn = function  # DGL-style alias: dgl.function

__all__ = ["Graph", "graph", "block", "batch", "unbatch", "batch_hetero",
           "unbatch_hetero", "HeteroGraph", "heterograph", "bipartite",
           "to_homogeneous", "to_heterogeneous", "hetero_from_relations",
           "metapath_reachable_graph", "prepare_rgcn", "add_self_loop", "remove_self_loop", "to_block",
           "sampling",
           "edge_softmax", "gat_attention", "gsddmm", "gspmm", "copy_u_sum",
           "u_mul_e_sum", "prepare_spmm", "update_all", "apply_edges",
           "apply_nodes", "EdgeBatch", "NodeBatch", "function", "fn",
           "segment", "readout", "sum_nodes", "mean_nodes", "max_nodes",
           "sum_edges", "mean_edges", "max_edges", "softmax_nodes",
           "softmax_edges", "broadcast_nodes", "broadcast_edges",
           "topk_nodes", "topk_edges"]
