"""NN utility modules, as ``dgl_hack_tpu.nn.utils``: Sequential,
WeightBasis and Identity."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .init import fans, glorot_uniform_

Tensor = torch.Tensor


class Sequential(nn.Module):
    """Stack GNN modules: each is called as ``layer(g, feat, *args)``, all
    on one graph, or module i on graph i when a list of graphs is given.
    The modules are named ``layers_0``, ``layers_1``, ... as in flax."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.num_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layers_{i}", layer)

    def forward(self, graph, feat, *args):
        graphs = graph if isinstance(graph, (list, tuple)) else \
            [graph] * self.num_layers
        if len(graphs) != self.num_layers:
            raise ValueError("number of graphs != number of modules")
        for i, g in enumerate(graphs):
            feat = getattr(self, f"layers_{i}")(g, feat, *args)
        return feat


class WeightBasis(nn.Module):
    """Basis decomposition W_o = sum_b w_comp[o, b] weight[b]; returns
    (num_outputs, *shape).  Both parameters glorot-uniform with flax's
    fans."""

    def __init__(self, shape: Tuple[int, ...], num_bases: int,
                 num_outputs: int):
        super().__init__()
        if num_outputs <= num_bases:
            raise ValueError("usually #outputs > #bases; got "
                             f"{num_outputs} <= {num_bases}")
        self.shape = tuple(shape)
        basis = (num_bases,) + self.shape
        self.weight = nn.Parameter(torch.empty(basis))
        glorot_uniform_(self.weight, *fans(basis))
        self.w_comp = nn.Parameter(torch.empty(num_outputs, num_bases))
        glorot_uniform_(self.w_comp, num_outputs, num_bases)

    def forward(self) -> Tensor:
        flat = self.weight.reshape(self.weight.shape[0], -1)
        return (self.w_comp @ flat).reshape((self.w_comp.shape[0],)
                                            + self.shape)


class Identity(nn.Module):
    def forward(self, x: Tensor) -> Tensor:
        return x
