"""dgl_hack_tpu_torch: the PyTorch/CUDA port of dgl_hack_tpu for an
NVIDIA H100.

The public API mirrors the JAX package's: ``graph()``, ``block()``,
``batch()``/``unbatch()``, the heterographs (``heterograph()``,
``HeteroGraph.multi_update_all`` ..., ``batch_hetero()``/
``unbatch_hetero()``), the graph transforms of ``transform``
(``add_self_loop()`` ... ``segmented_knn_graph()``, ``to_block()``), the
traversals and ``propagate``, the samplers of ``sampling``,
``gspmm()``, ``gsddmm()``, ``edge_softmax()``, ``gat_attention()``,
``prepare_spmm()``, ``prepare_rgcn()``, the message-passing API
(``update_all()``, ``apply_edges()``, ``apply_nodes()``,
``send_and_recv()``, ``pull()``, ``push()``, ``send()``/``recv()``,
``Graph.group_apply_edges``) with the builtin functions of ``fn`` or
UDFs, the readouts (``sum_nodes`` …
``topk_edges``), the layers of ``nn`` and the models of ``models``, with
the same tensor layouts.  CUDA tensors run the hand-written kernels under
``csrc/`` (built at first use); CPU tensors run their plain PyTorch
versions.  This package never imports JAX.
"""
from . import function, sampling
from .core.batch import batch, batch_hetero, unbatch, unbatch_hetero
from .core import propagate, transform, traversal
from .core.graph import (Graph, block, from_networkx, from_scipy, graph,
                         reverse, to_networkx)
from .core.heterograph import (HeteroGraph, bipartite, hetero_from_relations,
                               heterograph, metapath_reachable_graph,
                               to_heterogeneous, to_homogeneous)
from .core.message import (EdgeBatch, NodeBatch, apply_edges, apply_nodes,
                           pull, push, recv, send, send_and_recv, update_all)
from .core.transform import (add_edges, add_nodes, add_self_loop,
                             compact_graphs, edge_subgraph, in_subgraph,
                             khop_adj, khop_graph, knn_graph,
                             laplacian_lambda_max, line_graph, node_subgraph,
                             out_subgraph, remove_edges, remove_self_loop,
                             reorder_graph, segmented_knn_graph,
                             to_bidirected, to_block, to_simple)
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

__all__ = ["Graph", "graph", "block", "from_scipy", "reverse",
           "from_networkx", "to_networkx", "batch", "unbatch", "batch_hetero",
           "unbatch_hetero", "HeteroGraph", "heterograph", "bipartite",
           "to_homogeneous", "to_heterogeneous", "hetero_from_relations",
           "metapath_reachable_graph", "prepare_rgcn", "transform",
           "traversal", "propagate", "khop_graph", "line_graph",
           "to_bidirected", "add_self_loop", "remove_self_loop", "to_simple",
           "remove_edges", "node_subgraph", "edge_subgraph", "in_subgraph",
           "out_subgraph", "compact_graphs", "to_block", "knn_graph",
           "reorder_graph", "add_edges", "add_nodes", "laplacian_lambda_max",
           "khop_adj", "segmented_knn_graph", "sampling", "send_and_recv",
           "pull", "push", "send", "recv",
           "edge_softmax", "gat_attention", "gsddmm", "gspmm", "copy_u_sum",
           "u_mul_e_sum", "prepare_spmm", "update_all", "apply_edges",
           "apply_nodes", "EdgeBatch", "NodeBatch", "function", "fn",
           "segment", "readout", "sum_nodes", "mean_nodes", "max_nodes",
           "sum_edges", "mean_edges", "max_edges", "softmax_nodes",
           "softmax_edges", "broadcast_nodes", "broadcast_edges",
           "topk_nodes", "topk_edges"]
