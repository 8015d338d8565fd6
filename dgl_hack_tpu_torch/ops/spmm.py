"""gSpMM: generalised sparse-dense matmul (fused message + reduce).

Semantics as in ``dgl_hack_tpu.ops.spmm``:

* reduce to **dst** nodes over incoming edges;
* ``mean`` divides by clamp(in_degree, 1);
* zero in-degree rows give 0 for sum/mean/max/min;
* padded edges (``g.edge_mask``) contribute the reducer identity.

Dispatch by device:

* a dst-side ('v') operand with sum/mean/max/min decomposes into a
  copy-reduce of the other operand plus a per-node combine
  (``_v_side_decompose``), on either device, as in the JAX package (not
  on a masked graph, as there);
* copy_u and u_mul_e with max/min go through ``GspmmMax`` on either
  device: K4 and K5 (``ops/cuda/segment_max_kernel.py``) on CUDA, their
  plain versions on the CPU, so ties get the kernel's rule (the full
  cotangent to every tied edge) everywhere, masked graphs included;
* copy_e with sum/mean goes through K1's edge-row mode
  (``SegmentSumRows``): the edge data in internal order are each dst
  row's run of rows.  On CUDA, or on the CPU on an unmasked graph (its
  plain version);
* CUDA tensors: copy_u and u_mul_e with sum/mean go through K1, the
  segment-sum kernel (``ops/cuda/spmm_kernel.py``).  The combinations the
  JAX package also composes without a kernel (an edge-side lhs, u_op_e
  other than mul, prod, div/dot with a dst-side operand and max/min, copy
  of a dst-side operand, a masked graph's dst-side operand) take the
  composed path;
* CPU tensors: otherwise the composed path (gather, combine, segment
  reduce);
* a graph that carries a dense-hub hybrid (``prepare_spmm`` with
  ``dense_hub``) takes ``gspmm_hybrid`` for copy_u sum/mean of floating
  data without a mask, on either device (the JAX package's
  ``_hybrid_eligible``): K1 over the sparse remainder (its plain version
  on the CPU) plus a dense count matrix times x.

Sums and means of floating data narrower than float32 (bf16, float16)
accumulate in float32 and round once to the data's dtype on every route
(copy_u, u_mul_e, copy_e), as K1 does on the card and the JAX package's
``gspmm_pallas`` does on a prepared graph (spmm_kernel.py:1284-1288); mean
then divides that sum by the in-degree in the data's dtype, as
``gspmm_pallas`` does.  The JAX package's bare graph sums bf16 messages in
bf16 (``jax.ops.segment_sum``), so the port departs from it there, by up
to a few bf16 ulps of a row's sum.  ``segment.py`` stays a mirror of
``jax.ops.segment_*``.

A masked graph reaches K1 and K4/K5 through its real-edge view
(``ops/cuda/spmm_kernel.py:real_edges``), and mean divides by the count
of real in-edges (``real_in_degrees``), as the JAX package's masked
reduction does.

With ``DGL_TPU_DEBUG_DISPATCH=1`` each call names its route once
(``utils/env.py:dispatch_log``): ``v-rewrite``, ``hybrid``, ``rows``,
``kernel`` (K1 or K4/K5; the plain versions on the CPU), and for the rest
``composed`` on the card, ``plain`` on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.env import dispatch_log
from . import segment
from .common import apply_binary, gather_edge_operand
from .cuda.build import LAUNCHES
from .cuda.segment_max_kernel import gspmm_max
from .cuda.spmm_kernel import (accumulate_dtype, gspmm_hybrid, gspmm_rows,
                               gspmm_sum, real_in_degrees)

Tensor = torch.Tensor

REDUCERS = ("sum", "mean", "max", "min", "prod")


def _kernel_shaped(op, lhs_data, rhs_data, lhs_target, rhs_target) -> bool:
    """copy_u, or u_mul_e whose weight broadcasts up to x's feature shape
    (the kernel broadcasts w to x, not the other way)."""
    if lhs_target != "u" or op not in ("copy_lhs", "mul"):
        return False
    if op == "mul":
        if rhs_target != "e":
            return False
        xs, ws = tuple(lhs_data.shape[1:]), tuple(rhs_data.shape[1:])
        if len(ws) > len(xs):
            return False
        return all(b in (1, a) for a, b in zip(xs[len(xs) - len(ws):], ws))
    return True


def _expand_like(x: Tensor, ref: Tensor) -> Tensor:
    return x.reshape(x.shape + (1,) * (ref.dim() - 1))


def _hybrid_eligible(g, op: str, reduce_op: str, lhs_data,
                     lhs_target: str) -> bool:
    """copy_u sum/mean of floating data on a graph that carries a hybrid
    and no mask (the JAX package's ``_hybrid_eligible``)."""
    return ("hybrid" in g.derived and g.edge_mask is None
            and op == "copy_lhs" and lhs_target == "u"
            and reduce_op in ("sum", "mean")
            and lhs_data.is_floating_point())


def _on(data: Tensor) -> str:
    """Where a route runs, for the dispatch log: the kernel on the card,
    its plain version on the CPU."""
    return "cuda" if data.is_cuda else "cpu, plain version"


def _view(g) -> str:
    return ", real-edge-view" if g.edge_mask is not None else ""


def _mean(g, out: Tensor) -> Tensor:
    """A sum divided by the in-degree counting real edges (clamped to 1),
    in the sum's dtype."""
    deg = real_in_degrees(g).to(out.dtype).clamp(min=1)
    return out / deg.reshape((-1,) + (1,) * (out.dim() - 1))


def _v_side_decompose(g, op: str, reduce_op: str, lhs_data, rhs_data,
                      lhs_target: str, rhs_target: str) -> Optional[Tensor]:
    """A dst-side ('v') operand: y[v] is constant over v's in-edges, so the
    reduction is a copy-reduce of the other operand plus a per-node
    combine, e.g. ``gspmm(u_add_v, sum)[v] = copy_u_sum(x)[v] +
    deg(v)*y[v]`` and ``gspmm(u_mul_v, max)[v] = y[v] >= 0 ? max(x)*y :
    min(x)*y``.  The copy-reduce of a 'u' operand runs K1 (sum/mean) or K4
    (max/min) on CUDA.  Returns None when the combo does not decompose
    (caller composes)."""
    if g.edge_mask is not None or reduce_op == "prod":
        return None
    deg = g.in_degrees()
    if lhs_target == "v" and rhs_target == "v":      # fully node-local
        m = apply_binary(op, lhs_data, rhs_data)
        out = _expand_like(deg.to(m.dtype), m) * m if reduce_op == "sum" \
            else m
        return torch.where(_expand_like(deg > 0, out), out,
                           torch.zeros_like(out))
    if op in ("copy_lhs", "copy_rhs"):
        return None
    if rhs_target == "v":
        y, z, z_t, v_is_lhs = rhs_data, lhs_data, lhs_target, False
    else:
        y, z, z_t, v_is_lhs = lhs_data, rhs_data, rhs_target, True
    if not (y.is_floating_point() and z.is_floating_point()):
        return None

    def red(kind, data):
        return gspmm(g, "copy_lhs", kind, data, None, z_t, "e")

    if reduce_op in ("max", "min"):
        other = "min" if reduce_op == "max" else "max"
        if op == "add":
            out = red(reduce_op, z) + y
        elif op == "sub":                # y - z flips max and min
            out = y - red(other, z) if v_is_lhs else red(reduce_op, z) - y
        elif op == "mul":                # the sign of y picks the extremum
            hi, lo = torch.broadcast_tensors(red(reduce_op, z) * y,
                                             red(other, z) * y)
            out = torch.where(y >= 0, hi, lo)
        else:                            # div, dot: no clean decomposition
            return None
        return torch.where(_expand_like(deg > 0, out), out,
                           torch.zeros_like(out))

    scale = _expand_like(deg.to(y.dtype), y) if reduce_op == "sum" else 1.0
    if op == "div" and v_is_lhs:                     # y/z: reduce 1/z
        out = y * red(reduce_op, 1.0 / z)
    elif op == "add":
        out = red(reduce_op, z) + scale * y
    elif op == "sub":
        out = scale * y - red(reduce_op, z) if v_is_lhs \
            else red(reduce_op, z) - scale * y
    elif op == "mul":
        out = red(reduce_op, z) * y
    elif op == "div":                                # z/y
        out = red(reduce_op, z) / y
    elif op == "dot":
        out = (red(reduce_op, z) * y).sum(-1, keepdim=True)
    else:
        return None
    return torch.where(_expand_like(deg > 0, out), out, torch.zeros_like(out))


def gspmm(g, op: str, reduce_op: str, lhs_data: Optional[Tensor] = None,
          rhs_data: Optional[Tensor] = None, lhs_target: str = "u",
          rhs_target: str = "e") -> Tensor:
    """out[v] = reduce_{e=(u,v)} op(lhs[lhs_target], rhs[rhs_target]).

    ``lhs_data``/``rhs_data`` live on the target's index space: (num_src,
    ...) for 'u', (num_dst, ...) for 'v', (num_edges, ...) in internal
    order for 'e'.  Returns (num_dst, ...broadcast feature shape...)."""
    if reduce_op not in REDUCERS:
        raise ValueError(f"unknown reducer {reduce_op!r}")
    data = lhs_data if lhs_data is not None else rhs_data
    combo = f"{op}.{reduce_op}"
    if "v" in (lhs_target, rhs_target):
        out = _v_side_decompose(g, op, reduce_op, lhs_data, rhs_data,
                                lhs_target, rhs_target)
        if out is not None:
            dispatch_log("gspmm", "v-rewrite", combo)
            return out
    if _hybrid_eligible(g, op, reduce_op, lhs_data, lhs_target):
        dispatch_log("gspmm", "hybrid", f"{combo}, {_on(data)}")
        out = gspmm_hybrid(g, lhs_data)
        return _mean(g, out) if reduce_op == "mean" else out
    copied = (lhs_target if op == "copy_lhs" else
              rhs_target if op == "copy_rhs" else None)
    if copied == "e" and reduce_op in ("sum", "mean") \
            and data.is_floating_point() \
            and (data.is_cuda or g.edge_mask is None):
        dispatch_log("gspmm", "rows", f"{combo}, K1 over segments, "
                     f"{_on(data)}")
        return gspmm_rows(g, data, reduce_op)
    kernel = data.is_floating_point() and _kernel_shaped(
        op, lhs_data, rhs_data, lhs_target, rhs_target)
    w = rhs_data if op == "mul" else None
    if kernel and reduce_op in ("max", "min"):
        dispatch_log("gspmm", "kernel", f"{combo}, K4/K5{_view(g)}, "
                     f"{_on(data)}")
        return gspmm_max(g, lhs_data, w, reduce_op)
    if kernel and data.is_cuda and reduce_op in ("sum", "mean"):
        dispatch_log("gspmm", "kernel", f"{combo}, K1{_view(g)}, "
                     f"{_on(data)}")
        out = gspmm_sum(g, lhs_data, w)
        return _mean(g, out) if reduce_op == "mean" else out
    if data.is_cuda:
        dispatch_log("gspmm", "composed", combo)
        LAUNCHES.add("plain.gspmm_composed")
    else:
        dispatch_log("gspmm", "plain", combo)
    acc = accumulate_dtype(data.dtype)
    narrow = reduce_op in ("sum", "mean") and acc != data.dtype
    if narrow:
        # narrow floats: the operands are cast up before the gather, so
        # that the message, its sum and the gather's backward (a scatter-
        # add) all run in float32, and the result rounds once
        lhs_data, rhs_data = (
            t.to(acc) if t is not None and t.is_floating_point() else t
            for t in (lhs_data, rhs_data))
    lhs = None if op == "copy_rhs" else gather_edge_operand(g, lhs_data,
                                                            lhs_target)
    rhs = None if op == "copy_lhs" else gather_edge_operand(g, rhs_data,
                                                            rhs_target)
    if narrow:
        out = segment.segment_reduce("sum", apply_binary(op, lhs, rhs),
                                     g.dst, g.num_dst_nodes,
                                     mask=g.edge_mask).to(data.dtype)
        return _mean(g, out) if reduce_op == "mean" else out
    msg = apply_binary(op, lhs, rhs)
    return segment.segment_reduce(reduce_op, msg, g.dst, g.num_dst_nodes,
                                  mask=g.edge_mask)


def copy_u_sum(g, x: Tensor) -> Tensor:
    """out[v] = sum_{u->v} x[u], the GCN/SAGE aggregation."""
    return gspmm(g, "copy_lhs", "sum", x)


def u_mul_e_sum(g, x: Tensor, w: Tensor) -> Tensor:
    """out[v] = sum_{e=(u,v)} x[u] * w[e], the GAT aggregation."""
    return gspmm(g, "mul", "sum", x, w, "u", "e")
