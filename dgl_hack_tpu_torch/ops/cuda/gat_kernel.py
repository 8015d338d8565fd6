"""K2 and K3, the fused GAT edge phase, and the autograd.Function that
joins them.

``gat_fwd`` wraps ``csrc/gat_fwd.cu`` (which replaces the TPU kernels
``dgl_hack_tpu/ops/pallas/gat_kernel.py:_gat_kernel_shift`` and
``_gat_kernel``); ``gat_bwd`` wraps ``csrc/gat_bwd.cu`` (which replaces
``_gat_bwd_kernel``).  ``gat_fwd_plain`` and ``gat_bwd_plain`` are their
plain PyTorch versions, on the same arguments.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.

``GatFused`` is the counterpart of the JAX package's ``_gat_fused``
custom VJP: the forward saves rst, den and the per-dst shift; the backward
computes sds in torch, runs K3 over the CSR direction, then K1 in
edge-row mode over the CSC direction for der.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import LAUNCHES, check, library, ptr, require, stream_ptr
from .spmm_kernel import (_unsupported, graph_row_plan, rev_gidx,
                          segment_sum)

Tensor = torch.Tensor

NEG = -1e30               # shift of an empty row in 'exact' mode
SMEM_BYTES = 48 * 1024    # K3's static shared-memory budget per block
MAX_WARPS = 8


def _rows(indptr: Tensor) -> Tensor:
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)


def shift_bound(el: Tensor, er: Tensor, slope: float) -> Tensor:
    """'shift' mode subtrahend c[v] = leaky(max_u el[u] + er[v]) (leaky is
    monotone, so every logit into v is <= c[v] and exp(logit - c) <= 1)."""
    elmax = el.max(0).values if el.shape[0] else el.new_zeros(el.shape[1])
    return F.leaky_relu(elmax[None, :] + er, slope)


# ---------------------------------------------------------------------------
# K2: forward
# ---------------------------------------------------------------------------
def gat_fwd_plain(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor,
                  er: Tensor, w: Optional[Tensor], shift: Optional[Tensor],
                  slope: float, exact: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K2.  wh (N_src, H*D), el (N_src, H), er (N_dst, H),
    w (E, H) or None, shift (N_dst, H) ('shift' mode) or None ('exact').
    Returns rst (N_dst, H*D), den (N_dst, H), shift (N_dst, H)."""
    if wh.is_cuda:
        LAUNCHES.add("plain.gat_fwd")
    N, H = er.shape
    D = wh.shape[1] // H
    rows = _rows(indptr)
    logit = F.leaky_relu(el[src] + er[rows], slope)                    # (E, H)
    if exact:
        shift = torch.full((N, H), NEG, dtype=logit.dtype,
                           device=logit.device)
        idx = rows[:, None].expand_as(logit)
        shift = shift.scatter_reduce(0, idx, logit, "amax", include_self=True)
    p = torch.exp(logit - shift[rows])
    pw = p * w if w is not None else p
    msg = pw[:, :, None] * wh.view(-1, H, D)[src]
    num = wh.new_zeros((N, H, D)).index_add(0, rows, msg)
    den = p.new_zeros((N, H)).index_add(0, rows, p)
    rst = num / torch.where(den > 0, den, torch.ones_like(den))[:, :, None]
    return rst.reshape(N, H * D), den, shift


def gat_fwd(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor, er: Tensor,
            w: Optional[Tensor], shift: Optional[Tensor], slope: float,
            exact: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 wrapper; arguments and results as ``gat_fwd_plain``."""
    if wh.device.type == "cpu":
        return gat_fwd_plain(indptr, src, wh, el, er, w, shift, slope, exact)
    if wh.device.type != "cuda":
        raise ValueError(f"gat_fwd: unsupported device {wh.device}")
    dev = wh.device
    N, H = er.shape
    HD = wh.shape[1]
    if H == 0 or HD % H:
        raise ValueError(f"gat_fwd: width {HD} is not a multiple of H={H}")
    E = src.numel()
    require(indptr, "indptr", torch.int32, dev, N + 1)
    require(src, "src", torch.int32, dev)
    require(wh, "wh", torch.float32, dev)
    require(el, "el", torch.float32, dev, wh.shape[0] * H)
    require(er, "er", torch.float32, dev)
    if w is not None:
        require(w, "w", torch.float32, dev, E * H)
    if exact:
        shift = torch.empty((N, H), dtype=torch.float32, device=dev)
    else:
        require(shift, "shift", torch.float32, dev, N * H)
    rst = torch.empty((N, HD), dtype=torch.float32, device=dev)
    den = torch.empty((N, H), dtype=torch.float32, device=dev)
    lib = library()
    LAUNCHES.add("gat_fwd")
    check("gat_fwd", lib.gat_fwd_f32(
        ptr(indptr), ptr(src), ptr(wh), ptr(el), ptr(er), ptr(w), ptr(shift),
        ptr(rst), ptr(den), N, H, HD // H, float(slope), int(bool(exact)),
        stream_ptr(dev)))
    return rst, den, shift


# ---------------------------------------------------------------------------
# K3: backward
# ---------------------------------------------------------------------------
def gat_bwd_plain(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
                  wh: Tensor, el: Tensor, er: Tensor, shift: Tensor,
                  den: Tensor, sds: Tensor, dout: Tensor, w: Optional[Tensor],
                  slope: float):
    """Plain version of K3.  Per CSR edge e=(u->v): recompute a, daw,
    dlogit and draw; returns dwh (N_src, H*D), del (N_src, H), draw (E, H)
    and dw (E, H) or None, per-edge outputs at internal edge ids."""
    if wh.is_cuda:
        LAUNCHES.add("plain.gat_bwd")
    Ns, HD = wh.shape
    H = el.shape[1]
    D = HD // H
    srcs = _rows(csr_indptr)
    e = csr_eids.long()
    v = dst_csr.long()
    raw = el[srcs] + er[v]
    dv = den[v]
    a = torch.exp(torch.clamp(F.leaky_relu(raw, slope) - shift[v], max=60.0))
    a = a / torch.where(dv > 0, dv, torch.ones_like(dv))
    do_v = dout.view(-1, H, D)[v]
    daw = (wh.view(Ns, H, D)[srcs] * do_v).sum(-1)
    wv = w[e] if w is not None else torch.ones_like(a)
    dlogit = a * (daw * wv - sds[v])
    draw = dlogit * torch.where(raw >= 0, torch.ones_like(raw),
                                torch.full_like(raw, slope))
    dwh = wh.new_zeros((Ns, H, D)).index_add(0, srcs, (a * wv)[:, :, None]
                                             * do_v)
    del_ = el.new_zeros((Ns, H)).index_add(0, srcs, draw)
    draw_out = torch.empty_like(draw)
    draw_out[e] = draw
    dw = None
    if w is not None:
        dw = torch.empty_like(draw)
        dw[e] = a * daw
    return dwh.reshape(Ns, HD), del_, draw_out, dw


def gat_bwd(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
            wh: Tensor, el: Tensor, er: Tensor, shift: Tensor, den: Tensor,
            sds: Tensor, dout: Tensor, w: Optional[Tensor], slope: float):
    """K3 wrapper; arguments and results as ``gat_bwd_plain``."""
    if wh.device.type == "cpu":
        return gat_bwd_plain(csr_indptr, csr_eids, dst_csr, wh, el, er, shift,
                             den, sds, dout, w, slope)
    if wh.device.type != "cuda":
        raise ValueError(f"gat_bwd: unsupported device {wh.device}")
    dev = wh.device
    Ns, HD = wh.shape
    Nd, H = er.shape
    E = csr_eids.numel()
    require(csr_indptr, "csr_indptr", torch.int32, dev, Ns + 1)
    require(csr_eids, "csr_eids", torch.int32, dev)
    require(dst_csr, "dst_csr", torch.int32, dev, E)
    require(wh, "wh", torch.float32, dev)
    require(el, "el", torch.float32, dev, Ns * H)
    for name, t in (("er", er), ("shift", shift), ("den", den),
                    ("sds", sds)):
        require(t, name, torch.float32, dev, Nd * H)
    require(dout, "dout", torch.float32, dev, Nd * HD)
    if w is not None:
        require(w, "w", torch.float32, dev, E * H)
    per_warp = (2 * HD + 2 * H) * 4
    warps = min(MAX_WARPS, SMEM_BYTES // per_warp)
    if warps < 1:
        raise _unsupported(f"GAT backward at width H*D={HD}, H={H}",
                           "wide GAT heads")
    dwh = torch.empty((Ns, HD), dtype=torch.float32, device=dev)
    del_ = torch.empty((Ns, H), dtype=torch.float32, device=dev)
    draw = torch.empty((E, H), dtype=torch.float32, device=dev)
    dw = torch.empty((E, H), dtype=torch.float32, device=dev) \
        if w is not None else None
    lib = library()
    LAUNCHES.add("gat_bwd")
    check("gat_bwd", lib.gat_bwd_f32(
        ptr(csr_indptr), ptr(csr_eids), ptr(dst_csr), ptr(wh), ptr(el),
        ptr(er), ptr(shift), ptr(den), ptr(sds), ptr(dout), ptr(w), ptr(dwh),
        ptr(del_), ptr(draw), ptr(dw), Ns, H, HD // H, float(slope), warps,
        stream_ptr(dev)))
    return dwh, del_, draw, dw


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class GatFused(torch.autograd.Function):
    """out[v] = sum_{e=(u,v)} softmax_v(leaky(el[u]+er[v]))_e * w[e] * fsrc[u]
    through K2 (forward) and K3 + K1 (backward)."""

    @staticmethod
    def forward(ctx, fsrc: Tensor, el: Tensor, er: Tensor,
                w: Optional[Tensor], g, slope: float, softmax: str) -> Tensor:
        N, H, D = fsrc.shape
        wh = fsrc.reshape(N, H * D).contiguous()
        el = el.contiguous()
        er = er.contiguous()
        exact = softmax == "exact"
        shift = None if exact else shift_bound(el, er, slope).contiguous()
        rst, den, shift = gat_fwd(g.csc_indptr, g.src, wh, el, er, w, shift,
                                  slope, exact)
        ctx.g, ctx.slope, ctx.HD = g, slope, (H, D)
        ctx.save_for_backward(wh, el, er, w, rst, den, shift)
        return rst.view(-1, H, D)

    @staticmethod
    def backward(ctx, dout: Tensor):
        wh, el, er, w, rst, den, shift = ctx.saved_tensors
        g = ctx.g
        H, D = ctx.HD
        Nd = er.shape[0]
        dout = dout.reshape(Nd, H * D).contiguous()
        sds = (rst.view(Nd, H, D) * dout.view(Nd, H, D)).sum(-1).contiguous()
        dwh, del_, draw, dw = gat_bwd(g.csr_indptr, g.csr_eids, rev_gidx(g),
                                      wh, el, er, shift, den, sds, dout, w,
                                      ctx.slope)
        der = segment_sum(g.csc_indptr, draw, site="edge",
                          plan=graph_row_plan(g, "csc"))
        return (dwh.view(-1, H, D), del_, der,
                dw if ctx.needs_input_grad[3] else None, None, None, None)


def gat_attention_fused(g, fsrc: Tensor, el: Tensor, er: Tensor,
                        negative_slope: float = 0.2,
                        attn_w: Optional[Tensor] = None,
                        softmax: str = "shift") -> Tensor:
    """Fused GAT edge phase.  fsrc (N_src, H, D), el (N_src, H), er (N_dst,
    H), attn_w (E, H) in internal edge order or None.  Returns (N_dst, H,
    D).  On CUDA: float32 and unmasked graphs only."""
    if fsrc.is_cuda:
        if g.edge_mask is not None:
            raise _unsupported("gat_attention on a masked (padded) graph",
                               "masked graphs")
        if fsrc.dtype != torch.float32:
            raise _unsupported(f"gat_attention in {fsrc.dtype}", "bf16")
    if attn_w is not None:
        attn_w = attn_w.contiguous()
    return GatFused.apply(fsrc, el, er, attn_w, g, float(negative_slope),
                          softmax)
