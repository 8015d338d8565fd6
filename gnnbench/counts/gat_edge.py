"""Operations and compulsory bytes of the GAT edge phase (``gat_attention``
with attention dropout): out[v] = sum over v's in-edges of
softmax_v(leaky_relu(el[u] + er[v])) * w[e] * Wh[u], and its backward to
Wh, el and er.  Inputs read once, outputs written once, float32 values
and int32 indices; the dropout's keep mask w at one bit an edge and head
(what the function needs of it, whatever array holds it), read forward
and again backward; the softmax's own terms are left out of the
operations (a lower bound): two (multiply, add) an edge, head and feature
forward, four backward (Wh's sum and the weight's dot)."""
from __future__ import annotations

F32 = 4
I32 = 4


def _mask_bytes(num_edges: int, heads: int) -> float:
    return num_edges * heads / 8


def forward(n: int, num_edges: int, heads: int, width: int):
    HD = heads * width
    ops = 2 * num_edges * HD
    nbytes = (n * HD * F32 + 2 * n * heads * F32        # Wh, el, er
              + _mask_bytes(num_edges, heads)             # w
              + num_edges * I32 + (n + 1) * I32           # the graph
              + n * HD * F32)                             # out
    return ops, nbytes


def backward(n: int, num_edges: int, heads: int, width: int):
    HD = heads * width
    ops = 4 * num_edges * HD
    nbytes = (2 * n * HD * F32 + 2 * n * heads * F32    # dout, Wh, el, er
              + _mask_bytes(num_edges, heads)             # w
              + num_edges * I32 + (n + 1) * I32           # the graph
              + n * HD * F32 + 2 * n * heads * F32)       # dWh, del, der
    return ops, nbytes
