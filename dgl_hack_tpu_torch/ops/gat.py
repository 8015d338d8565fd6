"""Fused GAT attention op, dispatched by device.

CUDA tensors go through the fused kernels K2 (forward) and K3 + K1
(backward) in ``ops/cuda/gat_kernel.py``; CPU tensors take the composed
path gsddmm -> leaky_relu -> edge_softmax -> gspmm.  Both are
differentiable and agree to kernel tolerance.  Operands of any other shape
than (N_src, H, D), (N_src, H) and (N_dst, H) raise on either device,
before the dispatch (the JAX package's composed path fails on them too).

Both routes compute the function of the JAX package's fused path
(``gat_attention_pallas``): operands narrower than float32 (bf16) are
upcast, the edge phase runs in float32, and the result is rounded once to
fsrc's dtype; each operand's gradient comes back in its own dtype, rounded
once.  With ``DGL_TPU_GAT_PACKED=1`` the features are read rounded to bf16
(round to nearest even) where H * D is even, the logits exact, and the
gradient goes straight through the rounding (``_gat_fused_bwd``).
``DGL_TPU_DEBUG_DISPATCH=1`` prints ``kernel`` (the card) or ``plain`` (the
CPU) once per distinct call (``utils/env.py:dispatch_log``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.env import dispatch_log, get_config
from .cuda.gat_kernel import gat_attention_fused
from .cuda.spmm_kernel import widened
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


class RoundToBf16(torch.autograd.Function):
    """x rounded to bf16 (to nearest even) and back to x's dtype, with the
    gradient passed straight through: the packed GAT's features."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return g


def gat_attention(g, fsrc: Tensor, el: Tensor, er: Tensor,
                  negative_slope: float = 0.2,
                  attn_w: Optional[Tensor] = None) -> Tensor:
    """out[v] = sum_{e=(u,v)} softmax_v(leaky_relu(el[u] + er[v]))_e
    * attn_w[e] * fsrc[u].

    fsrc (N_src, H, D), el (N_src, H), er (N_dst, H); ``attn_w`` is an
    optional post-softmax per-edge multiplier (attention dropout) of shape
    (E, H) in internal edge order.  Returns (N_dst, H, D) in fsrc's dtype.
    The softmax shift of the fused path follows ``DGL_TPU_GAT_SOFTMAX``,
    the packed features ``DGL_TPU_GAT_PACKED``."""
    check_operands(g, fsrc, el, er)
    if attn_w is not None and g.edge_mask is not None:
        attn_w = attn_w * g.edge_mask[:, None].to(attn_w.dtype)
    cfg = get_config()
    H, D = fsrc.shape[1], fsrc.shape[2]
    detail = (f"H={H} D={D} softmax={cfg.gat_softmax} "
              f"packed={cfg.gat_packed}")
    if fsrc.is_cuda:
        dispatch_log("gat", "kernel", "K2/K3, " + detail + (
            ", real-edge-view" if g.edge_mask is not None else ""))
        return gat_attention_fused(g, fsrc, el, er, negative_slope, attn_w,
                                   softmax=cfg.gat_softmax,
                                   packed=cfg.gat_packed)
    dispatch_log("gat", "plain", detail)
    out_dtype = fsrc.dtype
    fsrc, el, er, attn_w = map(widened, (fsrc, el, er, attn_w))
    if cfg.gat_packed and (H * D) % 2 == 0:
        fsrc = RoundToBf16.apply(fsrc)
    e = gsddmm(g, "add", el[:, :, None], er[:, :, None], "u", "v")
    # jax.nn.leaky_relu's where(x >= 0): its slope at 0 is 1, as in K3
    # (F.leaky_relu's is negative_slope; bf16 logits hit 0 often)
    e = torch.where(e >= 0, e, negative_slope * e)
    a = edge_softmax(g, e)                                   # (E, H, 1)
    if attn_w is not None:
        a = a * attn_w[:, :, None]
    return gspmm(g, "mul", "sum", fsrc, a, "u", "e").to(out_dtype)
