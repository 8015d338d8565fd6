"""Power-law in-degree graph: ``dgl_hack_tpu_torch/data/synthetic.py``'s
``random_power_law_graph`` (bench.py's graph), drawn on the device with
torch, with Gaussian features, uniform random classes and a random
training mask.

Each of ``avg_degree * N`` edges takes its dst from the zipf law p(rank)
~ (rank + 1 + offset)^-alpha over the node ids (inverse CDF in float64)
and its src uniformly.  There are no self loops: most nodes have no
in-edge, a few hubs have 10^5.
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

    ranks = torch.arange(N, dtype=torch.float64, device=dev) + 1.0 \
        + float(params["offset"])
    cdf = torch.cumsum(ranks ** -float(params["alpha"]), 0)
    cdf = cdf / cdf[-1]
    draw = torch.rand(E, dtype=torch.float64, generator=gen, device=dev)
    dst = torch.searchsorted(cdf, draw).clamp_(max=N - 1)
    src = torch.randint(0, N, (E,), generator=gen, device=dev)

    x = torch.randn(N, F, generator=gen, device=dev)
    labels = torch.randint(0, C, (N,), generator=gen, device=dev)
    n_train = int(round(float(params["train_frac"]) * N))
    train_mask = torch.zeros(N, dtype=torch.bool, device=dev)
    train_mask[torch.randperm(N, generator=gen, device=dev)[:n_train]] = True
    return GraphData(src=src, dst=dst, x=x, labels=labels,
                     train_mask=train_mask, num_nodes=N, num_classes=C)
