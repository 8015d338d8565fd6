"""Shared pieces of the message-passing primitives: the binary-op and
target vocabulary of gspmm/gsddmm, as plain tensor functions."""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

BINARY_OPS = ("add", "sub", "mul", "div", "dot", "copy_lhs", "copy_rhs")
TARGETS = ("u", "v", "e")


def apply_binary(op: str, lhs: Optional[Tensor],
                 rhs: Optional[Tensor]) -> Tensor:
    """Elementwise combine with broadcasting; 'dot' contracts the last dim
    keeping a trailing 1 (the shape of dgl.function.u_dot_v)."""
    if op == "copy_lhs":
        return lhs
    if op == "copy_rhs":
        return rhs
    if op == "add":
        return lhs + rhs
    if op == "sub":
        return lhs - rhs
    if op == "mul":
        return lhs * rhs
    if op == "div":
        return lhs / rhs
    if op == "dot":
        return (lhs * rhs).sum(-1, keepdim=True)
    raise ValueError(f"unknown binary op {op!r}; expected one of {BINARY_OPS}")


def gather_edge_operand(g, data: Tensor, target: str) -> Tensor:
    """Materialise an operand per edge, in internal (CSC) edge order.

    'u' gathers from src nodes, 'v' from dst nodes, 'e' expects edge data
    already in internal order."""
    if target == "u":
        return data[g.src]
    if target == "v":
        return data[g.dst]
    if target == "e":
        return data
    raise ValueError(f"unknown target {target!r}; expected one of {TARGETS}")
