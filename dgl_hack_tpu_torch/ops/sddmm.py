"""gSDDMM: sampled dense-dense ops producing per-edge values.

Dispatch as in ``dgl_hack_tpu.ops.sddmm.gsddmm``:

* a dst-side ('v') lhs is swapped onto the rhs: ``v op u`` becomes ``u op
  v`` for add, mul and dot, ``v - u`` becomes ``-(u - v)``, and copy_lhs
  of 'v' becomes copy_rhs;
* ``op(lhs['u' or 'e'], rhs['v'])`` with equal feature shapes, float
  operands and op in add/sub/mul/div/dot/copy_rhs (dot on 2-D or (N, H,
  D) operands) goes through ``GsddmmFn``: K6 (``ops/cuda/sddmm_kernel.py``)
  on CUDA, its plain version on the CPU;
* everything else composes (gather both operands per edge and combine);
  on CUDA it counts ``plain.gsddmm_composed``.
* ``DGL_TPU_DEBUG_DISPATCH=1`` prints ``kernel`` (on the card with K6's
  route, ``gsddmm_route``) or ``composed`` once per distinct call
  (``utils/env.py:dispatch_log``);
* a masked graph takes the same dispatch over **every** edge, the padded
  ones included, and never reads the mask: the function the JAX package
  computes, whose gsddmm composes on masked graphs without the mask.

Per-edge values come back in internal (CSC) order by default, ready for
gspmm / edge_softmax; ``out_order='eid'`` gives user insertion order.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.env import dispatch_log
from .common import apply_binary, gather_edge_operand
from .cuda.build import LAUNCHES
from .cuda.sddmm_kernel import gsddmm_kernel, gsddmm_route

Tensor = torch.Tensor

_KERNEL_OPS = ("add", "sub", "mul", "div", "dot", "copy_rhs")


def _kernel_eligible(g, op, lhs_data, rhs_data, lhs_target) -> bool:
    """The combinations K6 computes (``_pallas_sddmm_eligible`` without
    the TPU's env switch and message-buffer budget)."""
    if op not in _KERNEL_OPS:
        return False
    if not rhs_data.is_floating_point():
        return False
    if op == "copy_rhs":
        return True
    if lhs_target not in ("u", "e") or not lhs_data.is_floating_point():
        return False
    if lhs_data.shape[1:] != rhs_data.shape[1:]:
        return False          # the kernel combines equal-width operands
    return op != "dot" or lhs_data.dim() in (2, 3)


def gsddmm(g, op: str, lhs_data: Optional[Tensor] = None,
           rhs_data: Optional[Tensor] = None, lhs_target: str = "u",
           rhs_target: str = "v", out_order: str = "internal") -> Tensor:
    """out[e=(u,v)] = op(lhs[lhs_target], rhs[rhs_target]).

    ``lhs_data``/``rhs_data`` live on the target's index space: (num_src,
    ...) for 'u', (num_dst, ...) for 'v', (num_edges, ...) in internal
    order for 'e'.  dot contracts the last dim keeping a trailing 1."""
    data = lhs_data if lhs_data is not None else rhs_data
    swap_sign = False
    if lhs_target == "v" and rhs_target != "v" and op in (
            "add", "mul", "dot", "sub", "copy_lhs"):
        swap_sign = op == "sub"                        # v - u = -(u - v)
        op = "copy_rhs" if op == "copy_lhs" else op
        lhs_data, rhs_data = rhs_data, lhs_data
        lhs_target, rhs_target = rhs_target, "v"
    if rhs_target == "v" and _kernel_eligible(g, op, lhs_data, rhs_data,
                                              lhs_target):
        dispatch_log("gsddmm", "kernel", lambda: (
            f"{op} {lhs_target}-op-v, K6 "
            f"{gsddmm_route(op, lhs_data, rhs_data, g.num_edges())}, cuda"
            if data.is_cuda
            else f"{op} {lhs_target}-op-v, K6, cpu, plain version"))
        out = gsddmm_kernel(g, op, None if op == "copy_rhs" else lhs_data,
                            rhs_data, lhs_target)
        if swap_sign:
            out = -out
    else:
        if swap_sign:            # undo the normalisation for composing
            lhs_data, rhs_data = rhs_data, lhs_data
            lhs_target, rhs_target = "v", lhs_target
        dispatch_log("gsddmm", "composed",
                     f"{op} {lhs_target}-op-{rhs_target}, "
                     f"{data.device.type}")
        if data.is_cuda:
            LAUNCHES.add("plain.gsddmm_composed")
        lhs = None if op == "copy_rhs" else gather_edge_operand(
            g, lhs_data, lhs_target)
        rhs = None if op == "copy_lhs" else gather_edge_operand(
            g, rhs_data, rhs_target)
        out = apply_binary(op, lhs, rhs)
    if out_order == "eid" and g.int2user is not None:
        out = out[g.user2int]
    return out
