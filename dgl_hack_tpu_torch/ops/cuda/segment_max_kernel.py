"""K4 and K5, the segment max and its fused argmax backward, and the gspmm
max/min they carry.

``segment_max`` wraps K4 and ``segment_max_bwd`` wraps K5, both in
``csrc/segment_max.cu`` (which replaces the TPU kernels
``dgl_hack_tpu/ops/pallas/spmm_kernel.py:_minmax_kernel`` /
``_minmax_kernel_acc`` and the backward ``_gspmm_fused_max_bwd``);
``segment_max_plain`` and ``segment_max_bwd_plain`` are their plain
PyTorch versions, on the same arguments.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``GspmmMax`` is the counterpart of the JAX package's ``_gspmm_fused_max``
custom VJP, and ``gspmm_max`` of ``gspmm_pallas``'s max/min branch: the
forward returns the raw max (``MINMAX_NEG`` on empty rows, saved for the
backward), the caller zero-fills ``raw <= MINMAX_NEG / 2``, and min is
``-max(-x)``.  The backward finds the argmax edges by float equality of
the recomputed message with the saved raw max, so every tied edge gets
the full cotangent, on either device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import LAUNCHES, check, library, ptr, require, stream_ptr
from .spmm_kernel import (_I32_MAX, check_cuda_call, flat_weight,
                          local_rows, rev_gidx, row_chunks)

Tensor = torch.Tensor

MINMAX_NEG = -1e30


def _w_kind(w: Optional[Tensor], E: int, F: int) -> int:
    """0 none, 1 (E,), 2 (E, F); raises on any other weight."""
    if w is None:
        return 0
    if w.dim() == 1 and w.shape[0] == E:
        return 1
    if w.dim() == 2 and tuple(w.shape) == (E, F):
        return 2
    raise ValueError(f"segment max weight of shape {tuple(w.shape)}; "
                     f"expected ({E},) or ({E}, {F})")


def _weighted(m: Tensor, we: Optional[Tensor]) -> Tensor:
    if we is None:
        return m
    return m * (we[:, None] if we.dim() == 1 else we)


# ---------------------------------------------------------------------------
# K4: forward
# ---------------------------------------------------------------------------
def segment_max_plain(indptr: Tensor, x: Tensor, gidx: Tensor,
                      w: Optional[Tensor] = None) -> Tensor:
    """raw[r] = max_{j in [indptr[r], indptr[r+1])} max(x[gidx[j]] * w[j],
    MINMAX_NEG); empty rows give MINMAX_NEG.  w None, (E,) or (E, F), in
    the order of gidx.  Rows go in blocks of ``row_chunks``."""
    if x.is_cuda:
        LAUNCHES.add("plain.segment_max")
    out = x.new_full((indptr.numel() - 1, x.shape[1]), MINMAX_NEG)
    for r0, r1, j0, j1 in row_chunks(indptr, x.shape[1]):
        m = _weighted(x[gidx[j0:j1]], None if w is None else w[j0:j1])
        m = torch.clamp_min(m, MINMAX_NEG)
        rows = local_rows(indptr, r0, r1)[:, None].expand_as(m)
        out[r0:r1].scatter_reduce_(0, rows, m, "amax")
    return out


def segment_max(indptr: Tensor, x: Tensor, gidx: Tensor,
                w: Optional[Tensor] = None) -> Tensor:
    """K4 wrapper; arguments and result as ``segment_max_plain``.  x (rows,
    F) float32; indptr, gidx int32."""
    if x.device.type == "cpu":
        return segment_max_plain(indptr, x, gidx, w)
    if x.device.type != "cuda":
        raise ValueError(f"segment_max: unsupported device {x.device}")
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"segment_max takes x of shape (rows, F), got "
                         f"{tuple(x.shape)}")
    num_rows, F, E = indptr.numel() - 1, x.shape[1], gidx.numel()
    require(x, "x", torch.float32, dev)
    require(indptr, "indptr", torch.int32, dev)
    require(gidx, "gidx", torch.int32, dev)
    w_kind = _w_kind(w, E, F)
    if w is not None:
        require(w, "w", torch.float32, dev)
    if max(num_rows, E, x.shape[0]) > _I32_MAX:
        raise ValueError("segment_max: sizes exceed the int32 index range")
    out = torch.empty((num_rows, F), dtype=torch.float32, device=dev)
    lib = library()
    LAUNCHES.add("segment_max.fwd")
    check("segment_max", lib.segment_max_f32(
        ptr(indptr), ptr(gidx), ptr(x), ptr(w), w_kind, ptr(out), num_rows,
        F, stream_ptr(dev)))
    return out


# ---------------------------------------------------------------------------
# K5: the argmax backward
# ---------------------------------------------------------------------------
def segment_max_bwd_plain(csr_indptr: Tensor, dst_csr: Tensor,
                          csr_eids: Tensor, x: Tensor, w: Optional[Tensor],
                          raw: Tensor, g: Tensor, want_dw: bool = True,
                          acc_dtype: Optional[torch.dtype] = None
                          ) -> Tuple[Tensor, Optional[Tensor]]:
    """Plain version of K5.  Over each src row u's out-edges j (v =
    dst_csr[j], e = csr_eids[j]): m = max(x[u] * w[e], MINMAX_NEG), eq =
    (m == raw[v]);  dx[u] = sum_j eq * g[v] * w[e];  dw[e] = sum_f eq *
    x[u] * g[v] for (E,) weights, elementwise for (E, F).  The comparison
    runs in x's dtype; the products and sums in ``acc_dtype`` (x's when
    None), so a float64 reference can check the float32 kernel.  Returns
    (dx, dw), dw None without w or ``want_dw``."""
    if x.is_cuda:
        LAUNCHES.add("plain.segment_max_bwd")
    acc = acc_dtype or x.dtype
    Ns, F = x.shape
    dx = torch.zeros((Ns, F), dtype=acc, device=x.device)
    dw = None
    if w is not None and want_dw:
        dw = torch.empty(w.shape, dtype=acc, device=x.device)
    for r0, r1, j0, j1 in row_chunks(csr_indptr, F):
        rows = local_rows(csr_indptr, r0, r1)
        v = dst_csr[j0:j1].long()
        e = csr_eids[j0:j1].long()
        xu = x[r0:r1][rows]
        we = None if w is None else w[e]
        eq = torch.clamp_min(_weighted(xu, we), MINMAX_NEG) == raw[v]
        gv = torch.where(eq, g[v].to(acc), 0.0)
        we_acc = None if we is None else we.to(acc)
        dx[r0:r1].index_add_(0, rows, _weighted(gv, we_acc))
        if dw is not None:
            prod = xu.to(acc) * gv
            dw[e] = prod.sum(-1) if w.dim() == 1 else prod
    return dx, dw


def segment_max_bwd(csr_indptr: Tensor, dst_csr: Tensor, csr_eids: Tensor,
                    x: Tensor, w: Optional[Tensor], raw: Tensor, g: Tensor,
                    want_dw: bool = True) -> Tuple[Tensor, Optional[Tensor]]:
    """K5 wrapper; arguments and results as ``segment_max_bwd_plain``.
    x (N_src, F), raw and g (N_dst, F) float32; index arrays int32."""
    if x.device.type == "cpu":
        return segment_max_bwd_plain(csr_indptr, dst_csr, csr_eids, x, w,
                                     raw, g, want_dw)
    if x.device.type != "cuda":
        raise ValueError(f"segment_max_bwd: unsupported device {x.device}")
    dev = x.device
    Ns, F = x.shape
    E = csr_eids.numel()
    require(csr_indptr, "csr_indptr", torch.int32, dev, Ns + 1)
    require(dst_csr, "dst_csr", torch.int32, dev, E)
    require(csr_eids, "csr_eids", torch.int32, dev)
    require(x, "x", torch.float32, dev)
    require(raw, "raw", torch.float32, dev)
    require(g, "g", torch.float32, dev, raw.numel())
    if raw.dim() != 2 or raw.shape[1] != F:
        raise ValueError(f"raw of shape {tuple(raw.shape)} for F={F}")
    w_kind = _w_kind(w, E, F)
    if w is not None:
        require(w, "w", torch.float32, dev)
    if max(Ns, E, raw.shape[0]) > _I32_MAX:
        raise ValueError("segment_max_bwd: sizes exceed the int32 index "
                         "range")
    dx = torch.empty((Ns, F), dtype=torch.float32, device=dev)
    dw = torch.empty(w.shape, dtype=torch.float32, device=dev) \
        if w is not None and want_dw else None
    lib = library()
    LAUNCHES.add("segment_max.bwd")
    check("segment_max_bwd", lib.segment_max_bwd_f32(
        ptr(csr_indptr), ptr(dst_csr), ptr(csr_eids), ptr(x), ptr(w), w_kind,
        ptr(raw), ptr(g), ptr(dx), ptr(dw), Ns, F, stream_ptr(dev)))
    return dx, dw


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class GspmmMax(torch.autograd.Function):
    """raw[v] = max_{e=(u,v)} max(x[u] * w[e], MINMAX_NEG) over the graph's
    CSC direction (K4); the backward walks the CSR direction (K5).

    x (N_src, F); w None, (E,) or (E, F) in internal edge order."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Optional[Tensor], g) -> Tensor:
        raw = segment_max(g.csc_indptr, x, g.src, w)
        ctx.g = g
        ctx.save_for_backward(x, w, raw)
        return raw

    @staticmethod
    def backward(ctx, draw: Tensor):
        x, w, raw = ctx.saved_tensors
        g = ctx.g
        want_dw = w is not None and ctx.needs_input_grad[1]
        dx, dw = segment_max_bwd(g.csr_indptr, rev_gidx(g), g.csr_eids, x,
                                 w, raw, draw.contiguous(), want_dw)
        return dx if ctx.needs_input_grad[0] else None, dw, None


def gspmm_max(g, x: Tensor, w: Optional[Tensor] = None,
              reduce_op: str = "max") -> Tensor:
    """copy_u / u_mul_e max or min through K4 (K5 in the backward).  x (N,
    ...) and w (E,), (E, 1...) or (E, ...) broadcastable to x's feature
    shape.  Zero in-degree rows, and rows whose every message is at or
    below MINMAX_NEG / 2, give 0.  Returns (N_dst, ...)."""
    if reduce_op not in ("max", "min"):
        raise ValueError(f"gspmm_max takes max or min, got {reduce_op!r}")
    check_cuda_call(g, x, f"gspmm {reduce_op}")
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    if reduce_op == "min":
        x2 = -x2
    raw = GspmmMax.apply(x2.contiguous(), flat_weight(w, shape), g)
    val = -raw if reduce_op == "min" else raw
    out = torch.where(raw > MINMAX_NEG * 0.5, val, torch.zeros_like(val))
    return out.reshape((out.shape[0],) + tuple(shape[1:]))
