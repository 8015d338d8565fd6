"""One training step of ``gat`` at a cell's shape: ``gat`` the edge phase
of each layer forward and backward, ``step`` the whole step: the fc
products, the attention scores and the edge phase, against the step's
compulsory bytes (x, the graph once, labels and mask, and the
optimizer's traffic).

The count is of the published function: one feature-dropout draw and one
fc product a layer (the port draws twice and runs two products,
``configs/gat.json`` ``assumed``)."""
from __future__ import annotations

from gnnbench.plugins import load_module

EDGE = load_module("counts", "gat_edge")
DENSE = load_module("counts", "dense")


def step(cfg: dict, shape: dict) -> dict:
    N, E = shape["num_nodes"], shape["num_edges"]
    heads = cfg["heads"]
    width, edge, ops, params = shape["in_feats"], [], 0, 0
    for i, H in enumerate(heads):
        D = cfg["num_hidden"] if i < len(heads) - 1 else shape["num_classes"]
        edge += [EDGE.forward(N, E, H, D), EDGE.backward(N, E, H, D)]
        f, b = DENSE.linear(N, width, H * D, input_grad=i > 0)
        ops += f + b + 2 * 2 * N * H * D * 2     # + el, er and back
        params += width * H * D + 2 * H * D
        width = H * D
    ops += sum(o for o, _ in edge)
    nbytes = (N * shape["in_feats"] * 4 + E * 4 + (N + 1) * 4 + N * 8 + N
              + DENSE.adamw_bytes(params))
    return {"gat": edge, "step": [(ops, nbytes)]}
