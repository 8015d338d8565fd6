"""End-to-end models: GCN, GAT and full-graph GraphSAGE, as in
``dgl_hack_tpu.models``.

Sub-modules carry the JAX package's names (``layer0``, ``gat0``, ``sage0``,
...), so
a flax params tree converts to a ``state_dict`` key for key
(``interop.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import GATConv, GraphConv, SAGEConv, dropout

Tensor = torch.Tensor


class GCN(nn.Module):
    def __init__(self, hidden_feats: int, out_feats: int, num_layers: int = 2,
                 dropout: float = 0.5, activation: Callable = F.relu):
        super().__init__()
        self.dropout = dropout
        self.num_layers = num_layers
        for i in range(num_layers - 1):
            self.add_module(f"layer{i}", GraphConv(hidden_feats,
                                                   activation=activation))
        self.add_module(f"layer{num_layers - 1}", GraphConv(out_feats))

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = (not self.training) if deterministic is None else deterministic
        h = x
        for i in range(self.num_layers - 1):
            if i:
                h = dropout(h, self.dropout, det, generator)
            h = getattr(self, f"layer{i}")(g, h)
        h = dropout(h, self.dropout, det, generator)
        return getattr(self, f"layer{self.num_layers - 1}")(g, h)


class GAT(nn.Module):
    """Multi-head GAT; hidden layers concat heads, the output layer means
    them."""

    def __init__(self, hidden_feats: int, out_feats: int,
                 heads: Sequence[int] = (8, 1), feat_drop: float = 0.6,
                 attn_drop: float = 0.6, negative_slope: float = 0.2,
                 residual: bool = False):
        super().__init__()
        self.num_layers = len(heads)
        L = self.num_layers
        for i in range(L - 1):
            self.add_module(f"gat{i}", GATConv(
                hidden_feats, heads[i], feat_drop=feat_drop,
                attn_drop=attn_drop, negative_slope=negative_slope,
                residual=residual, activation=F.elu))
        self.add_module(f"gat{L - 1}", GATConv(
            out_feats, heads[-1], feat_drop=feat_drop, attn_drop=attn_drop,
            negative_slope=negative_slope, residual=residual))

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = x
        L = self.num_layers
        for i in range(L - 1):
            h = getattr(self, f"gat{i}")(g, h, deterministic, generator)
            h = h.reshape(h.shape[0], -1)         # concat heads
        out = getattr(self, f"gat{L - 1}")(g, h, deterministic, generator)
        return out.mean(1)                        # mean over heads


class GraphSAGE(nn.Module):
    """Full-graph GraphSAGE: ``num_layers`` SAGEConv layers, with the
    activation and dropout between layers and nothing after the last."""

    def __init__(self, hidden_feats: int, out_feats: int, num_layers: int = 2,
                 aggregator_type: str = "mean", dropout: float = 0.5,
                 activation: Callable = F.relu):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.activation = activation
        for i in range(num_layers):
            dims = hidden_feats if i < num_layers - 1 else out_feats
            self.add_module(f"sage{i}", SAGEConv(dims, aggregator_type))

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if isinstance(g, (list, tuple)):
            raise NotImplementedError(
                "GraphSAGE over a list of sampled blocks is not ported yet "
                "(ROADMAP: 'sampling')")
        det = (not self.training) if deterministic is None else deterministic
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"sage{i}")(g, h, det, generator)
            if i < self.num_layers - 1:
                h = dropout(self.activation(h), self.dropout, det, generator)
        return h
