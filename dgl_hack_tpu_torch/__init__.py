"""dgl_hack_tpu_torch: the PyTorch/CUDA port of dgl_hack_tpu for an
NVIDIA H100.

The public API mirrors the JAX package's: ``graph()``, ``block()``,
``gspmm()``, ``gsddmm()``, ``edge_softmax()``, ``gat_attention()``,
``prepare_spmm()``, ``update_all()``/``apply_edges()``/``apply_nodes()``
with the builtin functions of ``fn``, the
``GraphConv``/``GATConv``/``SAGEConv``/``GINConv`` layers and the
``GCN``/``GAT``/``GraphSAGE``/``GraphTransformer`` models, with the same
tensor layouts.  CUDA tensors run the hand-written kernels under
``csrc/`` (built at first use); CPU tensors run their plain PyTorch
versions.  This package never imports JAX.
"""
from . import function
from .core.graph import Graph, block, graph
from .core.message import (EdgeBatch, NodeBatch, apply_edges, apply_nodes,
                           update_all)
from .ops.edge_softmax import edge_softmax
from .ops.gat import gat_attention
from .ops.sddmm import gsddmm
from .ops.spmm import copy_u_sum, gspmm, u_mul_e_sum
from .ops.cuda.spmm_kernel import prepare_spmm

fn = function  # DGL-style alias: dgl.function

__all__ = ["Graph", "graph", "block", "edge_softmax", "gat_attention",
           "gsddmm", "gspmm", "copy_u_sum", "u_mul_e_sum", "prepare_spmm",
           "update_all", "apply_edges", "apply_nodes", "EdgeBatch",
           "NodeBatch", "function", "fn"]
