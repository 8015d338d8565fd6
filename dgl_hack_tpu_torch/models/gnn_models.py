"""End-to-end models: GCN, GAT, full-graph GraphSAGE, RGCN, GIN and
MLPPredictor, as in ``dgl_hack_tpu.models``, and the models of the SGC,
APPNP and TAGCN example CLIs.

Sub-modules carry the JAX package's names (``layer0``, ``gat0``, ``sage0``,
``embed``, ``rgcn0``, ``gin0``, ``Dense_0``, ...), so a flax params tree
converts to a ``state_dict`` key for key (``interop.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv import (APPNPConv, GATConv, GINConv, GraphConv, RelGraphConv,
                       SAGEConv, SGConv, TAGConv, dropout)
from ..nn.init import Dense, lecun_normal_
from ..ops import readout

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
    """GraphSAGE: ``num_layers`` SAGEConv layers, with the activation and
    dropout between layers and nothing after the last.  ``g`` is one graph
    for every layer (full-graph training) or a list of sampled blocks,
    outermost first: layer i then runs on block i with the pair (h,
    h[:num_dst]), whose dst nodes are the first of its src nodes."""

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
        blocks = g if isinstance(g, (list, tuple)) else [g] * self.num_layers
        det = (not self.training) if deterministic is None else deterministic
        h = x
        for i in range(self.num_layers):
            block = blocks[i]
            feat = (h, h[:block.num_dst_nodes]) if block.is_block else h
            h = getattr(self, f"sage{i}")(block, feat, det, generator)
            if i < self.num_layers - 1:
                h = dropout(self.activation(h), self.dropout, det, generator)
        return h


class RGCN(nn.Module):
    """Entity-classification R-GCN: a learned embedding of every node as
    the input (``embed``, flax's ``Embed``: an ``nn.Embedding`` whose
    weight is flax's ``embedding``, drawn as flax draws it) unless
    ``feats`` are given, then ``num_layers`` basis ``RelGraphConv``s
    (``rgcn0``, ...), relu and dropout on all but the last.  ``plan``
    (``prepare_rgcn``) routes every layer through the (dst, etype)-pair
    path.  ``embed`` exists whether or not ``feats`` are given (the flax
    model makes it only without them)."""

    def __init__(self, num_nodes: int, hidden_feats: int, out_feats: int,
                 num_rels: int, num_bases: int = -1, num_layers: int = 2,
                 dropout: float = 0.0, self_loop: bool = True):
        super().__init__()
        self.num_layers = num_layers
        nb = None if num_bases <= 0 else num_bases
        self.embed = nn.Embedding(num_nodes, hidden_feats)
        lecun_normal_(self.embed.weight, hidden_feats)
        for i in range(num_layers - 1):
            self.add_module(f"rgcn{i}", RelGraphConv(
                hidden_feats, num_rels, "basis", nb, activation=F.relu,
                self_loop=self_loop, dropout=dropout))
        self.add_module(f"rgcn{num_layers - 1}", RelGraphConv(
            out_feats, num_rels, "basis", nb, self_loop=self_loop))

    def forward(self, g, etypes, norm: Optional[Tensor] = None,
                feats: Optional[Tensor] = None,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                plan=None) -> Tensor:
        h = self.embed.weight if feats is None else feats
        for i in range(self.num_layers):
            h = getattr(self, f"rgcn{i}")(g, h, etypes, norm, deterministic,
                                          generator, plan=plan)
        return h


class _MLP:
    """GIN's ``Dense, relu, Dense``.  Not a module: flax creates the two
    Denses in GIN's own scope (``Dense_{2i}``, ``Dense_{2i+1}``), so GIN
    owns them and GINConv only calls them."""

    def __init__(self, first: nn.Module, second: nn.Module):
        self.first, self.second = first, second

    def __call__(self, h: Tensor) -> Tensor:
        return self.second(F.relu(self.first(h)))


class GIN(nn.Module):
    """GIN for graph classification: per layer GINConv (sum, learned eps)
    with an MLP, LayerNorm (eps 1e-6, flax's) and relu, a sum readout of
    every layer through its own head ``pred{i}``, the heads summed."""

    def __init__(self, hidden_feats: int, out_feats: int,
                 num_layers: int = 5):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            first, second = Dense(hidden_feats), Dense(hidden_feats)
            self.add_module(f"Dense_{2 * i}", first)
            self.add_module(f"Dense_{2 * i + 1}", second)
            self.add_module(f"gin{i}", GINConv(apply_func=_MLP(first, second),
                                               learn_eps=True))
            self.add_module(f"ln{i}", nn.LayerNorm(hidden_feats, eps=1e-6))
        for i in range(num_layers):
            self.add_module(f"pred{i}", Dense(out_feats))

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = x
        score = 0.0
        for i in range(self.num_layers):
            h = getattr(self, f"gin{i}")(g, h)
            h = F.relu(getattr(self, f"ln{i}")(h))
            score = score + getattr(self, f"pred{i}")(readout.sum_nodes(g, h))
        return score


class MLPPredictor(nn.Module):
    """Edge-score MLP head for link prediction: Dense, relu, Dense over the
    concatenated endpoint features."""

    def __init__(self, hidden_feats: int, out_feats: int = 1):
        super().__init__()
        self.Dense_0 = Dense(hidden_feats)
        self.Dense_1 = Dense(out_feats)

    def forward(self, h_src: Tensor, h_dst: Tensor) -> Tensor:
        h = torch.cat([h_src, h_dst], dim=-1)
        return self.Dense_1(F.relu(self.Dense_0(h)))


class SGC(nn.Module):
    """The model of ``examples/train_sgc.py``: one SGConv."""

    def __init__(self, out_feats: int, k: int = 2):
        super().__init__()
        self.SGConv_0 = SGConv(out_feats, k=k)

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        return self.SGConv_0(g, x)


class APPNP(nn.Module):
    """The model of ``examples/train_appnp.py``: dropout, Dense, relu,
    dropout, Dense, then APPNPConv."""

    def __init__(self, hidden: int, out_feats: int, k: int = 10,
                 alpha: float = 0.1, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(hidden)
        self.Dense_1 = Dense(out_feats)
        self.APPNPConv_0 = APPNPConv(k=k, alpha=alpha)

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = (not self.training) if deterministic is None else deterministic
        x = dropout(x, self.dropout, det, generator)
        x = F.relu(self.Dense_0(x))
        x = dropout(x, self.dropout, det, generator)
        x = self.Dense_1(x)
        return self.APPNPConv_0(g, x, det, generator)


class TAGCN(nn.Module):
    """The model of ``examples/train_tagcn.py``: TAGConv with relu,
    dropout, TAGConv."""

    def __init__(self, hidden: int, out_feats: int, k: int = 2,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.TAGConv_0 = TAGConv(hidden, k=k, activation=F.relu)
        self.TAGConv_1 = TAGConv(out_feats, k=k)

    def forward(self, g, x: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = (not self.training) if deterministic is None else deterministic
        h = dropout(self.TAGConv_0(g, x), self.dropout, det, generator)
        return self.TAGConv_1(g, h)
