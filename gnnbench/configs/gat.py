"""Plain reference of the ``gat`` configuration (Velickovic et al. 2018):
GAT layers with concatenated heads and ELU between them, the output
layer's heads averaged.

A layer on h (N, in): feature dropout draws twice, once for the source
side and once for the destination side of the same features (the port's
convention, which its JAX package set: DGL draws once); Wh = fc(h);
el = <Wh_src, a_l>, er = <Wh_dst, a_r> per head; on each edge (u, v)
e = leaky_relu(el[u] + er[v]) (slope 1 at 0), alpha = softmax of e over
v's in-edges, times an attention-dropout mask drawn as a uniform (E, H)
array in the order of the stable sort on dst, kept below 1 - p and scaled
by 1 / (1 - p); out[v] = sum over v's in-edges of alpha * Wh_src[u].
The draws come in the order src features, dst features, attention, layer
by layer.
"""
from __future__ import annotations

import math

import torch

from gnnbench.reference import dropout, edge_softmax, edge_sum


def param_specs(cfg: dict, in_feats: int, num_classes: int):
    """(name, shape, std) of each parameter, the port's names: fc weights
    (out, in) and attention vectors (1, H, D), Glorot-normal."""
    specs, width = [], in_feats
    heads = cfg["heads"]
    for i, H in enumerate(heads):
        D = cfg["num_hidden"] if i < len(heads) - 1 else num_classes
        glorot = math.sqrt(2.0 / (width + H * D))
        attn = math.sqrt(2.0 / (H + D))
        specs += [(f"gat{i}.attn_l", (1, H, D), attn),
                  (f"gat{i}.attn_r", (1, H, D), attn),
                  (f"gat{i}.fc.weight", (H * D, width), glorot)]
        width = H * D
    return specs


def forward(cfg, params, g, x, draw, matmul, cache):
    """Logits (N, num_classes); ``draw(shape)`` gives the dropout's
    uniforms (None: evaluation)."""
    heads = cfg["heads"]
    slope = cfg["negative_slope"]
    h = x
    for i, H in enumerate(heads):
        W = params[f"gat{i}.fc.weight"]
        D = W.shape[0] // H
        h_src = dropout(h, cfg["feat_drop"], draw)
        h_dst = dropout(h, cfg["feat_drop"], draw)
        fsrc = matmul.linear(h_src, W).view(-1, H, D)
        fdst = matmul.linear(h_dst, W).view(-1, H, D)
        el = (fsrc * params[f"gat{i}.attn_l"]).sum(-1)
        er = (fdst * params[f"gat{i}.attn_r"]).sum(-1)
        s = el[g.src] + er[g.dst]
        a = edge_softmax(g, torch.where(s >= 0, s, slope * s))
        if draw is not None and cfg["attn_drop"] > 0:
            p = cfg["attn_drop"]
            keep = draw((g.num_edges, H)) < 1.0 - p
            a = a * (keep.to(a.dtype) / (1.0 - p))
        out = edge_sum(g, fsrc, a)
        if i < len(heads) - 1:
            h = torch.nn.functional.elu(out).reshape(out.shape[0], -1)
        else:
            h = out.mean(1)
    return h
