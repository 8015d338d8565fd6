"""Plain reference of the ``graphsage-mean`` configuration (Hamilton et
al. 2017, full graph): layers of h' = fc_self(h) + fc_neigh(mean of h
over the in-neighbours), ReLU and dropout between layers (one draw of
the hidden layer's shape), nothing after the last.  The mean of a node
without in-neighbours is 0.  The first layer's mean, of x alone, is the
same in every step and is computed once.
"""
from __future__ import annotations

import math

import torch

from gnnbench.reference import dropout, edge_mean


def param_specs(cfg: dict, in_feats: int, num_classes: int):
    """(name, shape, std): ``sage{i}.fc_self`` and ``sage{i}.fc_neigh``,
    weights (out, in) Glorot-normal, biases zero."""
    specs, width = [], in_feats
    for i in range(cfg["num_layers"]):
        out = cfg["num_hidden"] if i < cfg["num_layers"] - 1 else num_classes
        std = math.sqrt(2.0 / (width + out))
        for fc in ("fc_self", "fc_neigh"):
            specs += [(f"sage{i}.{fc}.weight", (out, width), std),
                      (f"sage{i}.{fc}.bias", (out,), 0.0)]
        width = out
    return specs


def forward(cfg, params, g, x, draw, matmul, cache):
    h = x
    L = cfg["num_layers"]
    for i in range(L):
        if i == 0:
            if "neigh0" not in cache:
                with torch.no_grad():
                    cache["neigh0"] = edge_mean(g, x)
            neigh = cache["neigh0"]
        else:
            neigh = edge_mean(g, h)
        p = f"sage{i}."
        h = (matmul.linear(h, params[p + "fc_self.weight"],
                           params[p + "fc_self.bias"])
             + matmul.linear(neigh, params[p + "fc_neigh.weight"],
                             params[p + "fc_neigh.bias"]))
        if i < L - 1:
            h = dropout(torch.relu(h), cfg["dropout"], draw)
    return h
