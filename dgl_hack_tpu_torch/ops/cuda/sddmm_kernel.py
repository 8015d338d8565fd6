"""K6, the gSDDMM kernel, and the autograd.Function around it.

``sddmm`` wraps the CUDA kernel in ``csrc/sddmm.cu`` (which replaces the
TPU kernel ``dgl_hack_tpu/ops/pallas/sddmm_kernel.py:_sddmm_kernel``);
``sddmm_plain`` is its plain PyTorch version, on the same arguments.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``sddmm`` checks its arguments (``k6_args``), picks the load
width and lanes a row (``k6_widths``) and launches (``k6_run``);
``k6_route`` names the route.

``GsddmmFn`` is the counterpart of the JAX package's ``_gsddmm_fused``
custom VJP (``_gsddmm_fused_bwd``): every cotangent reduction is K1, the
dst-side one over the CSC direction and an src-side lhs's over the CSR
direction, and the per-edge lhs cotangent of mul/div/dot is K6 itself
(``g * rhs[dst]``).  ``gsddmm_kernel`` mirrors ``gsddmm_pallas``, with
DGL's output shapes.

bf16 (``sddmm_bf16``, counted as ``sddmm_bf16.*``): K6 reads bf16 lhs and
rhs, computes in float32 and rounds the result once, as ``_sddmm_kernel``
upcasts its operands and ``gsddmm_pallas`` casts its result.  The result's
dtype is JAX's (``result_dtype``): rhs's for copy_rhs and dot, lhs's for
add, sub, mul and div.  So two bf16 operands give bf16; a bf16 lhs beside a
float32 rhs gives bf16 for the elementwise ops and float32 for dot; a
float32 lhs beside a bf16 rhs gives float32 for the elementwise ops and
bf16 for dot and copy_rhs.  A mix runs the float32 kernel over the
operands cast up (exact) and rounds its result once.  The backward runs
in float32 (g and the operands cast up, K6 and K1 in float32) and rounds
each gradient once to its operand's dtype (``_gsddmm_fused_bwd``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..common import apply_binary
from .build import LAUNCHES, counted, library, ptr, require, run
from .spmm_kernel import (_I32_MAX, FEATURE_DTYPES, PLAIN_CHUNK_ELEMS,
                          check_cuda_call, edge_lanes, graph_row_plan,
                          segment_sum, vector_width, widened)

Tensor = torch.Tensor

# op codes of csrc/sddmm.cu
OPS = {"copy_rhs": 0, "add": 1, "sub": 2, "mul": 3, "div": 4, "dot": 5}


def result_dtype(op: str, lhs: Optional[Tensor],
                 rhs: Tensor) -> torch.dtype:
    """The dtype of K6's result, as ``gsddmm_pallas`` casts it: rhs's for
    copy_rhs and dot, lhs's for the elementwise ops."""
    return rhs.dtype if op in ("copy_rhs", "dot") else lhs.dtype


def _combine(op: str, lhs: Optional[Tensor], rhs: Tensor,
             dot_d: int) -> Tensor:
    if op != "dot":
        return apply_binary(op, lhs, rhs)
    prod = lhs * rhs                     # each head sums dot_d lanes
    return prod.view(prod.shape[0], -1, dot_d).sum(-1)


def sddmm_plain(op: str, dst: Tensor, rhs: Tensor,
                lhs: Optional[Tensor] = None, src: Optional[Tensor] = None,
                dot_d: int = 0) -> Tensor:
    """out[e] = op(lhs[src[e]], rhs[dst[e]]) for every edge e, with lhs[e]
    when src is None (an edge operand); copy_rhs reads no lhs.  lhs and rhs
    are (rows, F); out is (E, F), or (E, F // dot_d) for dot, whose every
    head sums dot_d consecutive lanes.  Operands narrower than float32
    (bf16) are computed on in float32 and the result rounded once to
    ``result_dtype``.  Edges go in blocks of at most ``PLAIN_CHUNK_ELEMS``
    (edge, feature) elements."""
    if rhs.is_cuda:
        LAUNCHES.add("plain.sddmm")
    E, F = dst.numel(), rhs.shape[1]
    out = rhs.new_empty((E, F // dot_d if op == "dot" else F),
                        dtype=result_dtype(op, lhs, rhs))
    per = max(1, PLAIN_CHUNK_ELEMS // max(F, 1))
    for j0 in range(0, E, per):
        j1 = min(E, j0 + per)
        lhs_e = None
        if op != "copy_rhs":
            lhs_e = lhs[src[j0:j1]] if src is not None else lhs[j0:j1]
            lhs_e = widened(lhs_e)
        out[j0:j1] = _combine(op, lhs_e, widened(rhs[dst[j0:j1]]), dot_d)
    return out


# K6's routes (csrc/sddmm.cu): the elementwise ops take the vector route,
# which loads up to 16 bytes a lane (``vector_width``) in lane groups of
# ``k6_lanes``; the dot takes ``dot4`` (a thread an item) where its heads
# are at most DOT4_MAX_D wide and 4 values fit a load, else the vector
# route.  On an H100 80GB HBM3 at 700 W the first port's lane-group dot
# took 1.2-2.7x the vector route's time at D = 3 to 32, and its
# elementwise lane groups 1.4-6.6% more at DGCNN's F = 3 in float32
# (PERF.md, "Review follow-up").
DOT4_MAX_D = 32
_U32_MAX = 2**32 - 1

# Loads a lane makes over a row (ELEM_LANE_VECTORS) and over a dot's head
# (DOT_LANE_VECTORS); chip_smoke.py's k6_bench_shape times 1, 2 and 4.
# On an H100 80GB HBM3 at 700 W, at bench.py's graph, a head of 128
# float32 columns took 2.801 ms at two 16-byte loads a lane, 3.575 at one
# and 2.907 at four; of 128 bf16 columns 1.452, 1.906 and 1.941; two
# heads of 64 float32 columns 3.028, 3.443 and 4.278.  u_sub_v at F = 128
# took 5.668 ms at one load a lane, 5.670 at two and 6.060 at four in
# float32, 2.810, 2.986 and 4.503 in bf16.
ELEM_LANE_VECTORS = 1
DOT_LANE_VECTORS = 2


def k6_lanes(op: str, F: int, dot_d: int, vec: int, edges: int) -> int:
    """K6's route over ``edges`` edges at ``vec`` values a load, as the
    lanes a row (a head for dot) takes: 0 for ``dot4`` (heads of at most
    ``DOT4_MAX_D`` at 4 values a load or more, and at most 2^32 - 1 (edge,
    head) items); else enough lanes for ``ELEM_LANE_VECTORS`` loads each
    of the row's F columns, or ``DOT_LANE_VECTORS`` of a head's D, rounded
    up to a power of two, at most 32 (``edge_lanes``)."""
    if op != "dot":
        return edge_lanes(F, ELEM_LANE_VECTORS * vec)
    if dot_d <= DOT4_MAX_D and vec >= 4 and edges * (F // dot_d) <= _U32_MAX:
        return 0
    return edge_lanes(dot_d, DOT_LANE_VECTORS * vec)


def k6_route(op: str, vec: int, lanes: int) -> str:
    """The name of K6's route at ``vec`` values a load and ``lanes`` lanes
    a row (``k6_lanes``): ``dot4`` at 0 lanes, else ``vector`` or ``dot
    vector`` with the load width and lanes."""
    if lanes == 0:
        return "dot4"
    return (("dot vector" if op == "dot" else "vector")
            + f", {vec} a load, {lanes} lanes")


def k6_widths(op: str, rhs: Tensor, lhs: Optional[Tensor], dot_d: int,
              edges: int) -> tuple[int, int]:
    """The rule's (values a load, lanes a row) of K6 over ``edges`` edges
    and the operands as they reach the kernel: ``vector_width`` of their
    alignment and ``k6_lanes``."""
    F = rhs.shape[1]
    vec = vector_width(dot_d if op == "dot" else F, rhs, lhs)
    return vec, k6_lanes(op, F, dot_d, vec, edges)


class K6Args(NamedTuple):
    """K6's arguments on CUDA, checked, with a float32/bf16 mix cast up to
    float32 (``k6_args``); ``want`` is the result's dtype."""
    op: str
    dst: Tensor
    rhs: Tensor
    lhs: Optional[Tensor]
    src: Optional[Tensor]
    dot_d: int
    want: torch.dtype


def k6_args(op: str, dst: Tensor, rhs: Tensor, lhs: Optional[Tensor] = None,
            src: Optional[Tensor] = None, dot_d: int = 0) -> K6Args:
    """Check ``sddmm``'s arguments on CUDA and cast mixed operands up (the
    result is rounded once, to ``want``)."""
    dev = rhs.device
    if op not in OPS:
        raise ValueError(f"sddmm: unknown op {op!r}; expected one of "
                         f"{tuple(OPS)}")
    if rhs.dim() != 2:
        raise ValueError(f"sddmm takes rhs of shape (rows, F), got "
                         f"{tuple(rhs.shape)}")
    E, F = dst.numel(), rhs.shape[1]
    require(rhs, "rhs", FEATURE_DTYPES, dev)
    require(dst, "dst", torch.int32, dev)
    rows = 0
    if op == "copy_rhs":
        lhs = src = None
    else:
        if lhs is None or lhs.dim() != 2 or lhs.shape[1] != F:
            raise ValueError(f"sddmm {op} takes lhs of shape (rows, {F}), "
                             f"got {None if lhs is None else tuple(lhs.shape)}")
        require(lhs, "lhs", FEATURE_DTYPES, dev)
        rows = lhs.shape[0]
        if src is not None:
            require(src, "src", torch.int32, dev, E)
        elif rows != E:
            raise ValueError(f"edge lhs has {rows} rows, expected {E}")
    if op == "dot" and not (0 < dot_d and F % dot_d == 0):
        raise ValueError(f"dot head width {dot_d} does not divide F={F}")
    if max(E, rows, rhs.shape[0], F) > _I32_MAX:
        raise ValueError("sddmm: sizes exceed the int32 index range")
    want = result_dtype(op, lhs, rhs)
    if lhs is not None and lhs.dtype != rhs.dtype:   # a mix: cast up
        lhs, rhs = lhs.float(), rhs.float()
    return K6Args(op, dst, rhs, lhs, src, dot_d, want)


def k6_run(a: K6Args, *, vec: int, lanes: int) -> Tensor:
    """K6 over ``a`` at ``vec`` values a load and ``lanes`` lanes a row (0:
    dot4), the result in ``a.want``.  ``sddmm`` passes
    ``k6_widths``; ``chip_smoke.py``'s sweeps pass others."""
    E, F = a.dst.numel(), a.rhs.shape[1]
    out = torch.empty((E, F // a.dot_d if a.op == "dot" else F),
                      dtype=a.rhs.dtype, device=a.rhs.device)
    lib = library()
    entry = lib.sddmm_bf16 if a.rhs.dtype == torch.bfloat16 \
        else lib.sddmm_f32
    run("sddmm", entry, a.rhs.device, ptr(a.src), ptr(a.dst), ptr(a.lhs),
        ptr(a.rhs), ptr(out), OPS[a.op], E, F, a.dot_d, vec, lanes)
    return out.to(a.want)


def sddmm(op: str, dst: Tensor, rhs: Tensor, lhs: Optional[Tensor] = None,
          src: Optional[Tensor] = None, dot_d: int = 0, *,
          site: str = "fwd") -> Tensor:
    """K6 wrapper; arguments and result as ``sddmm_plain``.  rhs and lhs
    float32 or bf16 (rows, F); dst and src int32 (E,).  ``site`` names the
    call site in the launch count (fwd, bwd)."""
    if rhs.device.type == "cpu":
        return sddmm_plain(op, dst, rhs, lhs, src, dot_d)
    if rhs.device.type != "cuda":
        raise ValueError(f"sddmm: unsupported device {rhs.device}")
    a = k6_args(op, dst, rhs, lhs, src, dot_d)
    vec, lanes = k6_widths(a.op, a.rhs, a.lhs, a.dot_d, a.dst.numel())
    LAUNCHES.add(f"{counted('sddmm', a.rhs.dtype)}.{site}")
    return k6_run(a, vec=vec, lanes=lanes)


def flat_operands(op: str, lhs_data: Optional[Tensor], rhs_data: Tensor):
    """gsddmm's operands as K6 takes them: (lhs, rhs) with rows and
    features flattened, contiguous (None lhs for copy_rhs), and dot's head
    width (0 for the other ops)."""
    rhs = rhs_data.reshape(rhs_data.shape[0], -1).contiguous()
    lhs = None if op == "copy_rhs" else \
        lhs_data.reshape(lhs_data.shape[0], -1).contiguous()
    return lhs, rhs, int(rhs_data.shape[-1]) if op == "dot" else 0


def gsddmm_route(op: str, lhs_data: Optional[Tensor], rhs_data: Tensor,
                 edges: int) -> str:
    """``k6_route`` of a gsddmm call over ``edges`` edges on the card, from
    the operands that reach K6 (``flat_operands``; a float32/bf16 mix as a
    fresh float32 copy of the bf16 one); the dispatch log prints it."""
    lhs, rhs, dot_d = flat_operands(op, lhs_data, rhs_data)
    if lhs is not None and lhs.dtype != rhs.dtype:
        lhs, rhs = (torch.empty(t.shape, device="meta")
                    if t.dtype != torch.float32 else t for t in (lhs, rhs))
    return k6_route(op, *k6_widths(op, rhs, lhs, dot_d, edges))


class GsddmmFn(torch.autograd.Function):
    """out[e=(u,v)] = op(lhs[u or e], rhs[v]) in internal edge order.

    lhs (N_src, F) for ``lhs_target='u'``, (E, F) for 'e', None for
    copy_rhs; rhs (N_dst, F); dot_d is dot's head width."""

    @staticmethod
    def forward(ctx, lhs: Optional[Tensor], rhs: Tensor, g, op: str,
                lhs_target: str, dot_d: int) -> Tensor:
        ctx.g, ctx.op, ctx.lhs_target, ctx.dot_d = g, op, lhs_target, dot_d
        ctx.save_for_backward(lhs, rhs)
        src = g.src if lhs_target == "u" else None
        return sddmm(op, g.dst, rhs, lhs, src, dot_d, site="fwd")

    @staticmethod
    def backward(ctx, grad: Tensor):
        lhs, y = ctx.saved_tensors
        dtypes = (None if lhs is None else lhs.dtype, y.dtype)
        # in float32, rounded once to each operand's dtype at the end
        grad, lhs, y = widened(grad), widened(lhs), widened(y)
        g, op = ctx.g, ctx.op
        node_lhs = ctx.lhs_target == "u"
        need_lhs = op != "copy_rhs" and ctx.needs_input_grad[0]
        need_rhs = ctx.needs_input_grad[1]
        if need_lhs and node_lhs and g.csr_eids is None:
            raise ValueError("gsddmm backward of a node ('u') lhs needs the "
                             "graph's CSR format")
        gr = grad.contiguous()
        if op == "dot":                 # one scalar per head -> D lanes
            gr = gr.repeat_interleave(ctx.dot_d, dim=1)
        dlhs_e = dy = None
        if op in ("copy_rhs", "add", "sub"):
            if need_rhs:
                dy = segment_sum(g.csc_indptr, gr, site="edge",
                                 plan=graph_row_plan(g, "csc"))
                if op == "sub":
                    dy = -dy
            dlhs_e = gr
        else:                           # mul, dot: y; div: 1 / y
            yy = 1.0 / y if op == "div" else y
            if need_lhs:
                dlhs_e = sddmm("mul", g.dst, yy, gr, None, site="bwd")
            if need_rhs:
                # sum over v's in-edges of g[e] * lhs[u or e]
                dy = segment_sum(g.csc_indptr, lhs,
                                 g.src if node_lhs else None, w=gr,
                                 site="fwd" if node_lhs else "edge",
                                 plan=graph_row_plan(g, "csc"))
                if op == "div":
                    dy = -dy * yy * yy
        dlhs = None
        if need_lhs:
            dlhs = (segment_sum(g.csr_indptr, dlhs_e, g.csr_eids, site="rev",
                                plan=graph_row_plan(g, "csr"))
                    if node_lhs else dlhs_e).to(dtypes[0])
        if dy is not None:
            dy = dy.to(dtypes[1])
        return dlhs, dy, None, None, None, None


def gsddmm_kernel(g, op: str, lhs_data: Optional[Tensor], rhs_data: Tensor,
                  lhs_target: str) -> Tensor:
    """Per-edge ``op(lhs[lhs_target], rhs['v'])`` through K6, the
    counterpart of ``gsddmm_pallas``.  lhs (N_src, ...) for 'u', (E, ...)
    for 'e', None for copy_rhs, with rhs's feature shape; rhs (N_dst, ...).
    Returns internal-order edge values with DGL's shapes: (E, ...) for the
    elementwise ops, and for dot (E, 1) from 2-D operands and (E, H, 1)
    from (N, H, D) ones, in ``result_dtype``."""
    check_cuda_call(rhs_data, "gsddmm")
    if op != "copy_rhs":
        check_cuda_call(lhs_data, "gsddmm")
    if rhs_data.shape[0] != g.num_dst_nodes:
        raise ValueError(f"rhs has {rhs_data.shape[0]} rows, the graph "
                         f"{g.num_dst_nodes} dst nodes")
    if op != "copy_rhs" and lhs_target == "u" \
            and lhs_data.shape[0] != g.num_src_nodes:
        raise ValueError(f"lhs has {lhs_data.shape[0]} rows, the graph "
                         f"{g.num_src_nodes} src nodes")
    shape_r = rhs_data.shape
    lhs2, y2, dot_d = flat_operands(op, lhs_data, rhs_data)
    out = GsddmmFn.apply(lhs2, y2, g, op, lhs_target, dot_d)
    E = out.shape[0]
    if op == "dot":
        return out.reshape((E,) + tuple(shape_r[1:-1]) + (1,))
    ref = shape_r if op == "copy_rhs" else lhs_data.shape
    return out.reshape((E,) + tuple(ref[1:]))
