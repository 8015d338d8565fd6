"""K6, the gSDDMM kernel, and the autograd.Function around it.

``sddmm`` wraps the CUDA kernel in ``csrc/sddmm.cu`` (which replaces the
TPU kernel ``dgl_hack_tpu/ops/pallas/sddmm_kernel.py:_sddmm_kernel``);
``sddmm_plain`` is its plain PyTorch version, on the same arguments.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

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

from typing import Optional

import torch

from ..common import apply_binary
from .build import LAUNCHES, counted, library, ptr, require, run
from .spmm_kernel import (_I32_MAX, FEATURE_DTYPES, PLAIN_CHUNK_ELEMS,
                          check_cuda_call, graph_row_plan, segment_sum,
                          widened)

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
    if op not in OPS:
        raise ValueError(f"sddmm: unknown op {op!r}; expected one of "
                         f"{tuple(OPS)}")
    dev = rhs.device
    if rhs.dim() != 2:
        raise ValueError(f"sddmm takes rhs of shape (rows, F), got "
                         f"{tuple(rhs.shape)}")
    E, F = dst.numel(), rhs.shape[1]
    require(rhs, "rhs", FEATURE_DTYPES, dev)
    require(dst, "dst", torch.int32, dev)
    rows = 0
    if op != "copy_rhs":
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
    kind = rhs.dtype if lhs is None or lhs.dtype == rhs.dtype \
        else torch.float32
    if kind != rhs.dtype:                # a mix: cast up, round once below
        rhs = rhs.float()
    if lhs is not None and kind != lhs.dtype:
        lhs = lhs.float()
    out = torch.empty((E, F // dot_d if op == "dot" else F), dtype=kind,
                      device=dev)
    lib = library()
    LAUNCHES.add(f"{counted('sddmm', kind)}.{site}")
    entry = lib.sddmm_bf16 if kind == torch.bfloat16 else lib.sddmm_f32
    run("sddmm", entry, dev,
        ptr(src), ptr(dst), ptr(lhs), ptr(rhs), ptr(out), OPS[op], E, F,
        dot_d)
    return out.to(want)


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
    y2 = rhs_data.reshape(shape_r[0], -1).contiguous()
    lhs2 = None if op == "copy_rhs" else \
        lhs_data.reshape(lhs_data.shape[0], -1).contiguous()
    dot_d = int(shape_r[-1]) if op == "dot" else 0
    out = GsddmmFn.apply(lhs2, y2, g, op, lhs_target, dot_d)
    E = out.shape[0]
    if op == "dot":
        return out.reshape((E,) + tuple(shape_r[1:-1]) + (1,))
    ref = shape_r if op == "copy_rhs" else lhs_data.shape
    return out.reshape((E,) + tuple(ref[1:]))
