"""gSDDMM: sampled dense-dense ops producing per-edge values.

The composed path of ``dgl_hack_tpu.ops.sddmm.gsddmm`` in plain torch:
gather both operands per edge and combine.  (The JAX package's sddmm
kernel is off by default; its port is still to come, ROADMAP Queue 2.)
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import apply_binary, gather_edge_operand

Tensor = torch.Tensor


def gsddmm(g, op: str, lhs_data: Optional[Tensor] = None,
           rhs_data: Optional[Tensor] = None, lhs_target: str = "u",
           rhs_target: str = "v", out_order: str = "internal") -> Tensor:
    """out[e=(u,v)] = op(lhs[lhs_target], rhs[rhs_target]).

    Per-edge values come back in internal (CSC) order by default, ready
    for gspmm / edge_softmax; ``out_order='eid'`` gives user insertion
    order."""
    lhs = None if op == "copy_rhs" else gather_edge_operand(g, lhs_data,
                                                            lhs_target)
    rhs = None if op == "copy_lhs" else gather_edge_operand(g, rhs_data,
                                                            rhs_target)
    out = apply_binary(op, lhs, rhs)
    if out_order == "eid" and g.int2user is not None:
        out = out[g.user2int]
    return out
