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

On the card both kernels are bound by the rows they gather per edge (Wh[u]
in K2; dout[v] and the dst's er, shift, den and sds in K3), and short of
that by how many of those loads a warp keeps in flight and how many
scattered requests each edge costs.  Their design is that of K1, K4 and K5
(``csrc/rowwalk.cuh``) with the lanes laid out by head: work items from
the graph's cached row plans (``graph_row_plan``: CSC for K2, CSR for K3),
so a hub row is cut into pieces of ``K1_PIECE`` edges whose partial rows
(num and den in K2, dWh and del in K3) a fix-up adds in piece order; the
edge walk with indices loaded a chunk ahead and several edges in flight;
16-, 8- or 4-byte loads by ``vector_width`` over every tensor read or
written in rows, over the head width D; a head's per-edge work (K2's logit
and exp, K3's dot and epilogue) done by the head's own lanes, as few as
hold its D columns in ``K2_LANE_FLOATS`` / ``K3_LANE_FLOATS`` floats each,
the dot reduced by shuffles in a fixed order; accumulators in registers.
K3 reads the dst's four (N, H) operands packed into one (N, H, 4) array
(one 16-byte load, where four 4-byte loads cost four scattered requests)
and writes dw only where attn_w wants a gradient (GAT's dropout mask does
not).  No feature slices: slices of whole heads lost on the card at every
width (PERF.md).  Any H * D that K2 takes, K3 takes: a head wider than one pass goes in
passes, and no shared memory is used.  'exact' mode takes the per-dst max
first with K4 over el (``exact_shift``), so its pieces need no rescaling.
A masked graph runs both kernels over its real-edge view
(``on_real_edges``), attn_w gathered into the view's order: the padded
edges are left out of the softmax and the sum, and attn_w's gradient is
0 there.  Left for later: bf16 storage (ROADMAP: 'bf16').
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import LAUNCHES, check, library, ptr, require, stream_ptr
from .segment_max_kernel import MINMAX_NEG, segment_max
from .spmm_kernel import (_I32_MAX, RowPlan, _unsupported, checked_plan,
                          graph_row_plan, on_real_edges, plan_args, rev_gidx,
                          segment_sum, vector_width)

Tensor = torch.Tensor

NEG = -1e30               # shift of an empty row in 'exact' mode
# The most floats of an edge's row that a lane holds (csrc/rowwalk.cuh:
# head_shape): fewer lanes per edge put more edges in flight, more floats
# per lane cost registers.  Chosen per kernel from chip_smoke.py's sweep
# (PERF.md): K2 8, K3 4.
K2_LANE_FLOATS = 8
K3_LANE_FLOATS = 4


def _rows(indptr: Tensor) -> Tensor:
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)


def shift_bound(el: Tensor, er: Tensor, slope: float) -> Tensor:
    """'shift' mode subtrahend c[v] = leaky(max_u el[u] + er[v]) (leaky is
    monotone, so every logit into v is <= c[v] and exp(logit - c) <= 1)."""
    elmax = el.max(0).values if el.shape[0] else el.new_zeros(el.shape[1])
    return F.leaky_relu(elmax[None, :] + er, slope)


def exact_shift(elmax: Tensor, er: Tensor, slope: float) -> Tensor:
    """'exact' mode subtrahend: the per-dst max of leaky(el[u] + er[v]) from
    elmax[v] = max_u el[u] (K4's result, ``MINMAX_NEG`` on an empty row).
    leaky and the rounded add are monotone, so leaky(elmax + er) is the max
    over the row's logits bit for bit; an empty row gets ``NEG``."""
    return torch.where(elmax > MINMAX_NEG * 0.5,
                       F.leaky_relu(elmax + er, slope),
                       torch.full_like(er, NEG)).contiguous()


def _scratch(plan: RowPlan, HD: int, H: int, dev) -> Optional[Tensor]:
    """The pieces' partial rows, (P, H*D) then (P, H), or None."""
    P = plan.pieces.shape[0]
    return torch.empty(P * (HD + H), dtype=torch.float32, device=dev) \
        if P else None


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
            exact: bool, *, plan: Optional[RowPlan] = None
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 wrapper; arguments and results as ``gat_fwd_plain``.  ``plan`` is
    ``row_plan(indptr)``, built here when None.  In 'exact' mode K4 takes
    the per-dst max of el first (``exact_shift``)."""
    if wh.device.type == "cpu":
        return gat_fwd_plain(indptr, src, wh, el, er, w, shift, slope, exact)
    if wh.device.type != "cuda":
        raise ValueError(f"gat_fwd: unsupported device {wh.device}")
    launch, shift = gat_fwd_launcher(indptr, src, wh, el, er, w, shift, slope,
                                     exact, plan)
    LAUNCHES.add("gat_fwd")
    rst, den = launch()
    return rst, den, shift


def gat_fwd_launcher(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor,
                     er: Tensor, w: Optional[Tensor], shift: Optional[Tensor],
                     slope: float, exact: bool,
                     plan: Optional[RowPlan] = None):
    """Check K2's arguments on CUDA, take the 'exact' shift (K4), and
    return ``(launch, shift)``: ``launch(lane_floats)`` runs the kernel at
    that many floats per lane (None: ``K2_LANE_FLOATS``) and returns (rst,
    den).  ``gat_fwd`` launches through it; ``chip_smoke.py`` sweeps the
    lane budget with it."""
    dev = wh.device
    N, H = er.shape
    HD = wh.shape[1]
    if H == 0 or HD % H:
        raise ValueError(f"gat_fwd: width {HD} is not a multiple of H={H}")
    D = HD // H
    E = src.numel()
    require(indptr, "indptr", torch.int32, dev, N + 1)
    require(src, "src", torch.int32, dev)
    require(wh, "wh", torch.float32, dev)
    require(el, "el", torch.float32, dev, wh.shape[0] * H)
    require(er, "er", torch.float32, dev)
    if w is not None:
        require(w, "w", torch.float32, dev, E * H)
    if max(N, E, wh.shape[0]) > _I32_MAX:
        raise ValueError("gat_fwd: sizes exceed the int32 index range")
    plan = checked_plan(plan, indptr, "gat_fwd")
    if exact:
        shift = exact_shift(segment_max(indptr, el.view(-1, H), src,
                                        plan=plan), er, slope)
    else:
        require(shift, "shift", torch.float32, dev, N * H)
    vec = vector_width(D, wh)            # a lane's columns lie in one head

    def launch(lane_floats: Optional[int] = None) -> Tuple[Tensor, Tensor]:
        lane_floats = max(lane_floats or K2_LANE_FLOATS, vec)
        rst = torch.empty((N, HD), dtype=torch.float32, device=dev)
        den = torch.empty((N, H), dtype=torch.float32, device=dev)
        check("gat_fwd", library().gat_fwd_f32(
            ptr(indptr), ptr(src), ptr(wh), ptr(el), ptr(er), ptr(w),
            ptr(shift), ptr(rst), ptr(den), N, H, D, float(slope), vec,
            lane_floats, *plan_args(plan, _scratch(plan, HD, H, dev)),
            stream_ptr(dev)))
        return rst, den
    return launch, shift


# ---------------------------------------------------------------------------
# K3: backward
# ---------------------------------------------------------------------------
def gat_bwd_plain(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
                  wh: Tensor, el: Tensor, er: Tensor, shift: Tensor,
                  den: Tensor, sds: Tensor, dout: Tensor, w: Optional[Tensor],
                  slope: float, want_dw: bool = True):
    """Plain version of K3.  Per CSR edge e=(u->v): recompute a, daw,
    dlogit and draw; returns dwh (N_src, H*D), del (N_src, H), draw (E, H)
    and dw (E, H), None without w or ``want_dw``; per-edge outputs at
    internal edge ids."""
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
    if w is not None and want_dw:
        dw = torch.empty_like(draw)
        dw[e] = a * daw
    return dwh.reshape(Ns, HD), del_, draw_out, dw


def gat_bwd(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
            wh: Tensor, el: Tensor, er: Tensor, shift: Tensor, den: Tensor,
            sds: Tensor, dout: Tensor, w: Optional[Tensor], slope: float,
            want_dw: bool = True, *, plan: Optional[RowPlan] = None):
    """K3 wrapper; arguments and results as ``gat_bwd_plain``; dw is None
    unless ``want_dw`` (and w is given).  ``plan`` is
    ``row_plan(csr_indptr)``, built here when None."""
    if wh.device.type == "cpu":
        return gat_bwd_plain(csr_indptr, csr_eids, dst_csr, wh, el, er, shift,
                             den, sds, dout, w, slope, want_dw)
    if wh.device.type != "cuda":
        raise ValueError(f"gat_bwd: unsupported device {wh.device}")
    launch = gat_bwd_launcher(csr_indptr, csr_eids, dst_csr, wh, el, er,
                              shift, den, sds, dout, w, slope, want_dw, plan)
    LAUNCHES.add("gat_bwd")
    return launch()


def gat_bwd_launcher(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
                     wh: Tensor, el: Tensor, er: Tensor, shift: Tensor,
                     den: Tensor, sds: Tensor, dout: Tensor,
                     w: Optional[Tensor], slope: float,
                     want_dw: bool = True, plan: Optional[RowPlan] = None):
    """Check K3's arguments on CUDA, pack er, shift, den and sds into one
    (N_dst, H, 4) array, which K3 reads with one 16-byte load per (edge,
    head), and return ``launch(lane_floats)``, which runs the kernel as
    ``gat_fwd_launcher``'s does (None: ``K3_LANE_FLOATS``) and returns
    (dwh, del, draw, dw)."""
    dev = wh.device
    Ns, HD = wh.shape
    Nd, H = er.shape
    if H == 0 or HD % H:
        raise ValueError(f"gat_bwd: width {HD} is not a multiple of H={H}")
    D = HD // H
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
    if max(Ns, Nd, E) > _I32_MAX:
        raise ValueError("gat_bwd: sizes exceed the int32 index range")
    plan = checked_plan(plan, csr_indptr, "gat_bwd")
    vec = vector_width(D, wh, dout)      # a lane's columns lie in one head
    dstp = torch.stack([er, shift, den, sds], -1).contiguous()

    def launch(lane_floats: Optional[int] = None):
        lane_floats = max(lane_floats or K3_LANE_FLOATS, vec)
        dwh = torch.empty((Ns, HD), dtype=torch.float32, device=dev)
        del_ = torch.empty((Ns, H), dtype=torch.float32, device=dev)
        draw = torch.empty((E, H), dtype=torch.float32, device=dev)
        dw = torch.empty((E, H), dtype=torch.float32, device=dev) \
            if w is not None and want_dw else None
        check("gat_bwd", library().gat_bwd_f32(
            ptr(csr_indptr), ptr(csr_eids), ptr(dst_csr), ptr(wh), ptr(el),
            ptr(dstp), ptr(dout), ptr(w), ptr(dwh), ptr(del_), ptr(draw),
            ptr(dw), Ns, H, D, float(slope), vec, lane_floats,
            *plan_args(plan, _scratch(plan, HD, H, dev)), stream_ptr(dev)))
        return dwh, del_, draw, dw
    return launch


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
                                  slope, exact, plan=graph_row_plan(g, "csc"))
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
                                      ctx.slope, ctx.needs_input_grad[3],
                                      plan=graph_row_plan(g, "csr"))
        der = segment_sum(g.csc_indptr, draw, site="edge",
                          plan=graph_row_plan(g, "csc"))
        return (dwh.view(-1, H, D), del_, der,
                dw, None, None, None)


def gat_attention_fused(g, fsrc: Tensor, el: Tensor, er: Tensor,
                        negative_slope: float = 0.2,
                        attn_w: Optional[Tensor] = None,
                        softmax: str = "shift") -> Tensor:
    """Fused GAT edge phase.  fsrc (N_src, H, D), el (N_src, H), er (N_dst,
    H), attn_w (E, H) in internal edge order or None.  Returns (N_dst, H,
    D).  On CUDA: float32 only.  A masked graph runs over its real-edge
    view."""
    if fsrc.is_cuda and fsrc.dtype != torch.float32:
        raise _unsupported(f"gat_attention in {fsrc.dtype}", "bf16")
    g, attn_w = on_real_edges(g, attn_w)
    if attn_w is not None:
        attn_w = attn_w.contiguous()
    return GatFused.apply(fsrc, el, er, attn_w, g, float(negative_slope),
                          softmax)
