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
0 there.

Wh may be bf16 (``gat_fwd_bf16``, ``gat_bwd_bf16``; launches counted as
``gat_fwd_bf16.*`` and ``gat_bwd_bf16.*``): the JAX package's packed z
(``_pack_z``: bf16 features, float32 logits) and its bf16
``gat_attention_pallas`` (bf16 operands upcast into a float32 z, the
result rounded once to fsrc's dtype).  Both kernels widen Wh on the load;
el, er, w, dout, the sums and every output stay float32.  ``GatFused``
rounds Wh to bf16 once in packed mode and saves that copy, so the backward
differentiates the function the forward ran (``_gat_fused_bwd``'s zt),
straight through the rounding: dWh is float32.  A bf16 fsrc gets its
gradient rounded once to bf16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import LAUNCHES, counted, library, ptr, require, run
from .segment_max_kernel import MINMAX_NEG, segment_max
from .spmm_kernel import (_I32_MAX, FEATURE_DTYPES, RowPlan,
                          check_cuda_call, checked_plan, graph_row_plan,
                          on_real_edges, plan_args, rev_gidx, segment_sum,
                          vector_width, widened)

Tensor = torch.Tensor

NEG = -1e30               # shift of an empty row in 'exact' mode
# The most floats of an edge's row that a lane holds (csrc/rowwalk.cuh:
# head_shape): fewer lanes per edge put more edges in flight, more floats
# per lane cost registers.  Chosen per kernel from chip_smoke.py's sweep
# (PERF.md): K2 8, K3 4.
K2_LANE_FLOATS = 8
K3_LANE_FLOATS = 4
# Values per load of a bf16 Wh (8: one 16-byte load; 4: 8 bytes).  K2's
# from chip_smoke.py's sweep on an H100 (80GB HBM3, 700 W): at synthetic
# Reddit's hidden layer 4 took 2.071 ms and 8 2.095 (PERF.md).
# K3 reads Wh once per src row and gathers float32 dout, so it keeps
# float32's width.
K2_BF16_VALUES = 4
K3_BF16_VALUES = 4


def _widened(wh: Tensor, like: Tensor) -> Tensor:
    """wh (float32 or bf16) in the plain versions' working dtype: that of
    ``like`` (el), at least float32, so a bf16 Wh is summed in float32 (or
    float64 where a reference runs so)."""
    return wh.to(torch.promote_types(like.dtype, torch.float32))


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
    """Plain version of K2.  wh (N_src, H*D), float32 or bf16, el (N_src,
    H), er (N_dst, H), w (E, H) or None, shift (N_dst, H) ('shift' mode)
    or None ('exact').  Returns rst (N_dst, H*D), den (N_dst, H), shift
    (N_dst, H), in el's dtype (a bf16 wh is widened first)."""
    if wh.is_cuda:
        LAUNCHES.add("plain.gat_fwd")
    wh = _widened(wh, el)
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
    LAUNCHES.add(counted("gat_fwd", wh.dtype))
    rst, den = launch()
    return rst, den, shift


def gat_fwd_launcher(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor,
                     er: Tensor, w: Optional[Tensor], shift: Optional[Tensor],
                     slope: float, exact: bool,
                     plan: Optional[RowPlan] = None):
    """Check K2's arguments on CUDA, take the 'exact' shift (K4), and
    return ``(launch, shift)``: ``launch(lane_floats, values)`` runs the
    kernel at that many values per lane (None: ``K2_LANE_FLOATS``) and at
    most ``values`` per load (None: 4 of float32, ``K2_BF16_VALUES`` of
    bf16) and returns (rst, den).  ``gat_fwd`` launches through it;
    ``chip_smoke.py`` sweeps both with it."""
    dev = wh.device
    N, H = er.shape
    HD = wh.shape[1]
    if H == 0 or HD % H:
        raise ValueError(f"gat_fwd: width {HD} is not a multiple of H={H}")
    D = HD // H
    E = src.numel()
    require(indptr, "indptr", torch.int32, dev, N + 1)
    require(src, "src", torch.int32, dev)
    require(wh, "wh", FEATURE_DTYPES, dev)
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
    bf16 = wh.dtype == torch.bfloat16
    entry = library().gat_fwd_bf16 if bf16 else library().gat_fwd_f32
    max_values = K2_BF16_VALUES if bf16 else 4

    def launch(lane_floats: Optional[int] = None,
               values: Optional[int] = None) -> Tuple[Tensor, Tensor]:
        # a lane's columns lie in one head; ``values`` caps the load width
        vec = vector_width(D, wh, max_values=values or max_values)
        lane_floats = max(lane_floats or K2_LANE_FLOATS, vec)
        rst = torch.empty((N, HD), dtype=torch.float32, device=dev)
        den = torch.empty((N, H), dtype=torch.float32, device=dev)
        run("gat_fwd", entry, dev,
            ptr(indptr), ptr(src), ptr(wh), ptr(el), ptr(er), ptr(w),
            ptr(shift), ptr(rst), ptr(den), N, H, D, float(slope), vec,
            lane_floats, *plan_args(plan, _scratch(plan, HD, H, dev)))
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
    internal edge ids, all in el's dtype (a bf16 wh is widened first)."""
    if wh.is_cuda:
        LAUNCHES.add("plain.gat_bwd")
    wh = _widened(wh, el)
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
    LAUNCHES.add(counted("gat_bwd", wh.dtype))
    return launch()


def gat_bwd_launcher(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
                     wh: Tensor, el: Tensor, er: Tensor, shift: Tensor,
                     den: Tensor, sds: Tensor, dout: Tensor,
                     w: Optional[Tensor], slope: float,
                     want_dw: bool = True, plan: Optional[RowPlan] = None):
    """Check K3's arguments on CUDA, pack er, shift, den and sds into one
    (N_dst, H, 4) array, which K3 reads with one 16-byte load per (edge,
    head), and return ``launch(lane_floats, values)``, which runs the
    kernel as ``gat_fwd_launcher``'s does (None: ``K3_LANE_FLOATS``; 4
    values, ``K3_BF16_VALUES`` of a bf16 wh) and returns (dwh, del, draw,
    dw)."""
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
    require(wh, "wh", FEATURE_DTYPES, dev)
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
    dstp = torch.stack([er, shift, den, sds], -1).contiguous()
    bf16 = wh.dtype == torch.bfloat16
    entry = library().gat_bwd_bf16 if bf16 else library().gat_bwd_f32
    max_values = K3_BF16_VALUES if bf16 else 4

    def launch(lane_floats: Optional[int] = None,
               values: Optional[int] = None):
        # a lane's columns lie in one head
        vec = vector_width(D, wh, dout, max_values=values or max_values)
        lane_floats = max(lane_floats or K3_LANE_FLOATS, vec)
        dwh = torch.empty((Ns, HD), dtype=torch.float32, device=dev)
        del_ = torch.empty((Ns, H), dtype=torch.float32, device=dev)
        draw = torch.empty((E, H), dtype=torch.float32, device=dev)
        dw = torch.empty((E, H), dtype=torch.float32, device=dev) \
            if w is not None and want_dw else None
        run("gat_bwd", entry, dev,
            ptr(csr_indptr), ptr(csr_eids), ptr(dst_csr), ptr(wh), ptr(el),
            ptr(dstp), ptr(dout), ptr(w), ptr(dwh), ptr(del_), ptr(draw),
            ptr(dw), Ns, H, D, float(slope), vec, lane_floats,
            *plan_args(plan, _scratch(plan, HD, H, dev)))
        return dwh, del_, draw, dw
    return launch


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class GatFused(torch.autograd.Function):
    """out[v] = sum_{e=(u,v)} softmax_v(leaky(el[u]+er[v]))_e * w[e] * fsrc[u]
    through K2 (forward) and K3 + K1 (backward).  fsrc float32 or bf16;
    el, er and w float32.  ``packed``: Wh rounded to bf16 once here, and
    that copy is what K2 and K3 read.  The result is float32; fsrc's
    gradient comes back in fsrc's dtype."""

    @staticmethod
    def forward(ctx, fsrc: Tensor, el: Tensor, er: Tensor,
                w: Optional[Tensor], g, slope: float, softmax: str,
                packed: bool = False) -> Tensor:
        N, H, D = fsrc.shape
        wh = fsrc.reshape(N, H * D).contiguous()
        if packed:
            wh = wh.to(torch.bfloat16)
        el = el.contiguous()
        er = er.contiguous()
        exact = softmax == "exact"
        shift = None if exact else shift_bound(el, er, slope).contiguous()
        rst, den, shift = gat_fwd(g.csc_indptr, g.src, wh, el, er, w, shift,
                                  slope, exact, plan=graph_row_plan(g, "csc"))
        ctx.g, ctx.slope, ctx.HD = g, slope, (H, D)
        ctx.fdtype = fsrc.dtype
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
        return (dwh.view(-1, H, D).to(ctx.fdtype), del_, der,
                dw, None, None, None, None)


def gat_attention_fused(g, fsrc: Tensor, el: Tensor, er: Tensor,
                        negative_slope: float = 0.2,
                        attn_w: Optional[Tensor] = None,
                        softmax: str = "shift",
                        packed: bool = False) -> Tensor:
    """Fused GAT edge phase.  fsrc (N_src, H, D), el (N_src, H), er (N_dst,
    H), attn_w (E, H) in internal edge order or None.  Returns (N_dst, H,
    D) in fsrc's dtype.  On CUDA each is float32 or bf16 (another dtype
    raises).  As ``gat_attention_pallas``: a bf16 el, er or attn_w is
    upcast (their gradients come back rounded once to bf16), the sums run
    in float32 and a bf16 fsrc's result is rounded once.  ``packed`` (the
    JAX ``DGL_TPU_GAT_PACKED``) reads Wh rounded to bf16 where H * D is
    even, and is off for an odd H * D (``gat_kernel.py:940``).  A masked
    graph runs over its real-edge view."""
    for name, t in (("fsrc", fsrc), ("el", el), ("er", er),
                    ("attn_w", attn_w)):
        if t is not None:
            check_cuda_call(t, f"gat_attention {name}")
    g, attn_w = on_real_edges(g, attn_w)
    if attn_w is not None:
        attn_w = widened(attn_w).contiguous()
    H, D = fsrc.shape[1], fsrc.shape[2]
    out = GatFused.apply(fsrc, widened(el), widened(er), attn_w, g,
                         float(negative_slope), softmax,
                         packed and (H * D) % 2 == 0)
    return out.to(fsrc.dtype)
