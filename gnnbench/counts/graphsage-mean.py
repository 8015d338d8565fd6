"""One training step of ``graphsage-mean`` at a cell's shape, by what it
runs: ``k1`` the gspmm calls (each layer's mean forward, the second's
backward: x needs no gradient), ``step`` the whole step: the dense
products and the gspmm adds, against the step's compulsory bytes (x, the
graph once, labels and mask, and the optimizer's traffic)."""
from __future__ import annotations

from gnnbench.plugins import load_module

K1 = load_module("counts", "k1")
DENSE = load_module("counts", "dense")


def step(cfg: dict, shape: dict) -> dict:
    N, E = shape["num_nodes"], shape["num_edges"]
    widths = [shape["in_feats"]] + [cfg["num_hidden"]] * (
        cfg["num_layers"] - 1) + [shape["num_classes"]]
    k1, ops, params = [], 0, 0
    for i in range(cfg["num_layers"]):
        fin, fout = widths[i], widths[i + 1]
        k1.append(K1.gspmm_sum(N, N, E, fin))
        if i > 0:
            k1.append(K1.gspmm_sum(N, N, E, fin))       # dx
        for _ in ("fc_self", "fc_neigh"):
            f, b = DENSE.linear(N, fin, fout, input_grad=i > 0)
            ops += f + b
            params += fin * fout + fout
    ops += sum(o for o, _ in k1)
    nbytes = (N * widths[0] * 4 + E * 4 + (N + 1) * 4 + N * 8 + N
              + DENSE.adamw_bytes(params))
    return {"k1": k1, "step": [(ops, nbytes)]}
