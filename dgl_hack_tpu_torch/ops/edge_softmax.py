"""edge_softmax: per-destination softmax over incoming-edge logits, as a
composed segment softmax in plain torch (autograd gives the softmax VJP)."""
from __future__ import annotations

import torch

from . import segment

Tensor = torch.Tensor


def edge_softmax(g, logits: Tensor, order: str = "internal") -> Tensor:
    """Softmax of ``logits`` (num_edges, ...) grouped by dst node.

    ``order`` declares the layout of ``logits`` ('internal' CSC order or
    'eid' user order); the result comes back in the same layout.  Padded
    edges (g.edge_mask) get probability 0 and do not count in the
    normaliser."""
    internal = order == "internal" or g.int2user is None
    e = logits if internal else logits[g.int2user]
    if g.edge_mask is not None:
        e = segment.apply_identity_mask("max", e, g.edge_mask)
    out = segment.segment_softmax(e, g.dst, g.num_dst_nodes)
    if g.edge_mask is not None:
        mask = g.edge_mask.reshape(g.edge_mask.shape + (1,) * (out.dim() - 1))
        out = torch.where(mask, out, torch.zeros_like(out))
    if not internal:
        out = out[g.user2int]
    return out
