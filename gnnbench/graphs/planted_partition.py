"""Planted-partition ("homophily SBM") graph with class-signal features:
``dgl_hack_tpu_torch/data/synthetic.py``'s ``planted_partition`` with the
splits of ``synthetic_reddit``, drawn on the device with torch.

Each of ``avg_degree * N`` directed draws picks a node u and a partner v:
of u's class with probability ``homophily``, else any node; self pairs
are dropped, the rest symmetrised, and every node gets a self loop.
Features are the class centre plus ``feat_noise`` Gaussian noise.  The
training mask holds the first ``train_per_class`` nodes of each class in
id order.  (The numpy original draws 2E pairs and keeps the first E: the
same distribution.  Validation and test masks do not enter a training
step and are not made.)
"""
from __future__ import annotations

import torch

from gnnbench.inputs import GraphData, generator


def generate(params: dict, seed: int, device) -> GraphData:
    N = int(params["num_nodes"])
    C = int(params["num_classes"])
    F = int(params["feat_dim"])
    E = int(N * float(params["avg_degree"]))
    gen = generator(seed, "graph", device)
    dev = torch.device(device)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)

    labels = torch.randint(0, C, (N,), generator=gen, device=dev)
    u = torch.randint(0, N, (E,), generator=gen, device=dev)
    same = rand(E) < float(params["homophily"])
    order = torch.sort(labels, stable=True).indices
    class_off = torch.searchsorted(labels[order],
                                   torch.arange(C + 1, device=dev))
    cls_u = labels[u]
    lo, hi = class_off[cls_u], class_off[cls_u + 1]
    partner_same = order[(lo + (rand(E) * (hi - lo)).long()) % N]
    partner_rand = torch.randint(0, N, (E,), generator=gen, device=dev)
    v = torch.where(same, partner_same, partner_rand)
    keep = u != v
    u, v = u[keep], v[keep]
    loops = torch.arange(N, device=dev)
    src = torch.cat([u, v, loops])
    dst = torch.cat([v, u, loops])

    centers = torch.randn(C, F, generator=gen, device=dev)
    x = centers[labels] + float(params["feat_noise"]) * torch.randn(
        N, F, generator=gen, device=dev)

    # rank of each node within its class, in id order
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(N, device=dev) - class_off[labels[order]]
    train_mask = rank < int(params["train_per_class"])
    return GraphData(src=src, dst=dst, x=x, labels=labels,
                     train_mask=train_mask, num_nodes=N, num_classes=C)
