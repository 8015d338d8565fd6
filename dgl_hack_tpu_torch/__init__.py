"""dgl_hack_tpu_torch: the PyTorch/CUDA port of dgl_hack_tpu for an
NVIDIA H100.

The public API mirrors the JAX package's: ``graph()``, ``gspmm()``,
``gsddmm()``, ``edge_softmax()``, ``gat_attention()``, ``prepare_spmm()``,
the ``GraphConv``/``GATConv``/``SAGEConv``/``GINConv`` layers and the
``GCN``/``GAT``/``GraphSAGE`` models, with the same tensor layouts.  CUDA
tensors run the hand-written kernels under ``csrc/`` (built at first
use); CPU tensors run their plain PyTorch versions.  This package never imports JAX.
"""
from .core.graph import Graph, graph
from .ops.edge_softmax import edge_softmax
from .ops.gat import gat_attention
from .ops.sddmm import gsddmm
from .ops.spmm import copy_u_sum, gspmm, u_mul_e_sum
from .ops.cuda.spmm_kernel import prepare_spmm

__all__ = ["Graph", "graph", "edge_softmax", "gat_attention", "gsddmm",
           "gspmm", "copy_u_sum", "u_mul_e_sum", "prepare_spmm"]
