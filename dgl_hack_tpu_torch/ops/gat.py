"""Fused GAT attention op, dispatched by device.

CUDA tensors go through the fused kernels K2 (forward) and K3 + K1
(backward) in ``ops/cuda/gat_kernel.py``; CPU tensors take the composed
path gsddmm -> leaky_relu -> edge_softmax -> gspmm.  Both are
differentiable and agree to kernel tolerance.  Operands of any other shape
than (N_src, H, D), (N_src, H) and (N_dst, H) raise on either device,
before the dispatch (the JAX package's composed path fails on them too).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.env import get_config
from .cuda.gat_kernel import gat_attention_fused
from .edge_softmax import edge_softmax
from .sddmm import gsddmm
from .spmm import gspmm

Tensor = torch.Tensor


def check_operands(g, fsrc: Tensor, el: Tensor, er: Tensor) -> None:
    """Raise a ValueError naming the expected shapes unless fsrc is (N_src,
    H, D), el (N_src, H) and er (N_dst, H) on g: the JAX package's fused
    condition (``dgl_hack_tpu/ops/gat.py:_fused_eligible``), with the
    widths tied to each other and to the graph."""
    ok = fsrc.dim() == 3 and el.dim() == 2 and er.dim() == 2
    if ok:
        N, H = fsrc.shape[:2]
        ok = (N == g.num_src_nodes and tuple(el.shape) == (N, H)
              and tuple(er.shape) == (g.num_dst_nodes, H))
    if not ok:
        raise ValueError(
            "gat_attention takes fsrc (N_src, H, D), el (N_src, H) and er "
            f"(N_dst, H) with N_src={g.num_src_nodes}, "
            f"N_dst={g.num_dst_nodes}; got fsrc {tuple(fsrc.shape)}, el "
            f"{tuple(el.shape)}, er {tuple(er.shape)}")


def gat_attention(g, fsrc: Tensor, el: Tensor, er: Tensor,
                  negative_slope: float = 0.2,
                  attn_w: Optional[Tensor] = None) -> Tensor:
    """out[v] = sum_{e=(u,v)} softmax_v(leaky_relu(el[u] + er[v]))_e
    * attn_w[e] * fsrc[u].

    fsrc (N_src, H, D), el (N_src, H), er (N_dst, H); ``attn_w`` is an
    optional post-softmax per-edge multiplier (attention dropout) of shape
    (E, H) in internal edge order.  Returns (N_dst, H, D).  The softmax
    shift of the fused path follows ``DGL_TPU_GAT_SOFTMAX``."""
    check_operands(g, fsrc, el, er)
    if attn_w is not None and g.edge_mask is not None:
        attn_w = attn_w * g.edge_mask[:, None].to(attn_w.dtype)
    if fsrc.is_cuda:
        return gat_attention_fused(g, fsrc, el, er, negative_slope, attn_w,
                                   softmax=get_config().gat_softmax)
    e = gsddmm(g, "add", el[:, :, None], er[:, :, None], "u", "v")
    e = F.leaky_relu(e, negative_slope)
    a = edge_softmax(g, e)                                   # (E, H, 1)
    if attn_w is not None:
        a = a * attn_w[:, :, None]
    return gspmm(g, "mul", "sum", fsrc, a, "u", "e")
