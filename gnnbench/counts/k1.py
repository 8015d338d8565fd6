"""Operations and compulsory bytes of one gspmm copy_u sum or mean over a
graph (K1, or the dense-hub hybrid with K1 over the rest): the function,
whatever implements it.  Inputs read once, outputs written once, float32
features and int32 indices: the features of every source row and the
edge index in the walk's direction (E ids and the N + 1 offsets), the
output rows; one add an edge and feature."""
from __future__ import annotations

F32 = 4
I32 = 4


def gspmm_sum(n_src: int, n_dst: int, num_edges: int, width: int):
    """(operations, bytes) of out (n_dst, width) = sums of x (n_src,
    width) over the edges; the backward dx is the same function on the
    reversed graph."""
    ops = num_edges * width
    nbytes = (n_src * width * F32 + num_edges * I32 + (n_dst + 1) * I32
              + n_dst * width * F32)
    return ops, nbytes
