"""Global (whole-graph) pooling layers, as ``dgl_hack_tpu.nn.glob``, on the
readouts of ``ops/readout.py``: sum and mean reach K1's edge-row mode on
CUDA; max, softmax, broadcast and the sort are torch ops.

Sub-modules carry flax's names (``Dense_0``, ``lstm``, ``pma``, ``sab0``,
``LayerNorm_0``, ``MultiHeadDotProductAttention_0`` with ``query``/``key``/
``value``/``out``), so ``interop.flax_to_state_dict`` converts a params tree
key for key.  The set-transformer attention is plain torch matmuls and a
softmax, masked as flax masks: a masked logit becomes the dtype's least
value.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..core.graph import Graph
from ..ops import readout
from .init import (Dense, bias_keep, fans, glorot_uniform_,
                   lecun_normal_, orthogonal_blocks_)

Tensor = torch.Tensor


class SumPooling(nn.Module):
    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        return readout.sum_nodes(g, feat)


class WeightAndSum(nn.Module):
    """A per-node sigmoid gate, then the weighted sum readout."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(1)

    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        w = torch.sigmoid(self.Dense_0(feat))
        return readout.sum_nodes(g, feat, weight=w[:, 0])


class AvgPooling(nn.Module):
    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        return readout.mean_nodes(g, feat)


class MaxPooling(nn.Module):
    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        return readout.max_nodes(g, feat)


class SortPooling(nn.Module):
    """Sort each node's features, keep the k nodes with the largest last
    feature, flatten: (num_graphs, k * D)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        feat = torch.sort(feat, dim=-1).values
        ret = readout.topk_nodes(g, feat, self.k, idx=-1)
        return ret.reshape(ret.shape[0], -1)


class GlobalAttentionPooling(nn.Module):
    """r = sum_v softmax(gate_nn(x_v)) * feat_nn(x_v) per graph."""

    def __init__(self, gate_nn: Callable,
                 feat_nn: Optional[Callable] = None):
        super().__init__()
        self.gate_nn = gate_nn
        self.feat_nn = feat_nn

    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        gate = self.gate_nn(feat)
        if gate.shape[-1] != 1:
            raise ValueError(f"gate_nn must give one value per node, got "
                             f"{tuple(gate.shape)}")
        feat = self.feat_nn(feat) if self.feat_nn is not None else feat
        alpha = readout.softmax_nodes(g, gate)
        return readout.sum_nodes(g, feat * alpha)


def _flax_lstm(input_size: int, hidden: int) -> nn.LSTMCell:
    """An ``nn.LSTMCell`` initialised as flax's: lecun-normal input
    kernels, orthogonal recurrent kernels, zero biases."""
    cell = nn.LSTMCell(input_size, hidden)
    lecun_normal_(cell.weight_ih, input_size)
    orthogonal_blocks_(cell.weight_hh, hidden)
    nn.init.zeros_(cell.bias_ih)
    nn.init.zeros_(cell.bias_hh)
    return cell


class Set2Set(nn.Module):
    """Set2Set readout: ``n_iters`` of an LSTM query, attention over each
    graph's nodes and the weighted sum; output (num_graphs, 2 * input_dim).
    ``n_layers`` is accepted and, as in the JAX layer, one cell runs."""

    def __init__(self, input_dim: int, n_iters: int, n_layers: int = 1):
        super().__init__()
        self.input_dim = input_dim
        self.n_iters = n_iters
        self.n_layers = n_layers
        self.lstm = _flax_lstm(2 * input_dim, input_dim)
        # flax's input gates have no bias: bias_ih is masked out
        self.register_buffer("ih_bias_keep", bias_keep(
            4 * input_dim, slice(None)), persistent=False)

    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        n_graphs = len(g.batch_num_nodes) if g.batch_num_nodes is not None \
            else 1
        h = feat.new_zeros((n_graphs, self.input_dim))
        c = torch.zeros_like(h)
        q_star = feat.new_zeros((n_graphs, 2 * self.input_dim))
        for _ in range(self.n_iters):
            lstm = self.lstm
            h, c = torch.lstm_cell(q_star, (h, c), lstm.weight_ih,
                                   lstm.weight_hh,
                                   lstm.bias_ih * self.ih_bias_keep,
                                   lstm.bias_hh)
            e = (feat * readout.broadcast_nodes(g, h)).sum(-1, keepdim=True)
            alpha = readout.softmax_nodes(g, e)
            r = readout.sum_nodes(g, feat * alpha)
            q_star = torch.cat([h, r], dim=-1)
        return q_star


def _to_dense_batch(g: Graph, x: Tensor):
    """Each graph's nodes scattered into a (G, max_n, D) buffer of zeros,
    with the (G, max_n) mask of real rows and the (graph, position) index
    of every node."""
    counts = g.batch_num_nodes or (g.num_dst_nodes,)
    gid, pos = readout.dense_positions(counts, x.device)
    dense = x.new_zeros((len(counts), max(counts)) + tuple(x.shape[1:]))
    dense = dense.index_put((gid, pos), x)
    mask = torch.zeros((len(counts), max(counts)), dtype=torch.bool,
                       device=x.device)
    mask[gid, pos] = True
    return dense, mask, (gid, pos)


class _Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` without dropout: ``query``,
    ``key`` and ``value`` project to (H, Dh), logits are scaled by
    1/sqrt(Dh), masked logits take the dtype's least value, and ``out``
    projects the heads back."""

    def __init__(self, num_heads: int, qkv_features: int,
                 out_features: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(qkv_features)
        self.key = Dense(qkv_features)
        self.value = Dense(qkv_features)
        self.out = Dense(out_features)

    def forward(self, q: Tensor, kv: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        H = self.num_heads

        def heads(t: Tensor) -> Tensor:            # (G, L, H, Dh)
            return t.reshape(t.shape[:-1] + (H, -1))
        query, key, value = heads(self.query(q)), heads(self.key(kv)), \
            heads(self.value(kv))
        query = query / math.sqrt(query.shape[-1])
        logits = torch.einsum("gqhd,gkhd->ghqk", query, key)
        if mask is not None:
            logits = torch.where(mask, logits,
                                 torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        x = torch.einsum("ghqk,gkhd->gqhd", w, value)
        return self.out(x.reshape(x.shape[:-2] + (-1,)))


class _MAB(nn.Module):
    """Multihead attention block: h = LN(q + attn(q, kv)), then
    LN(h + Dense_0(relu(Dense_1(h)))).  ``Dense_0`` is the d_model layer:
    flax creates the outer ``Dense`` of ``Dense(d_model)(relu(Dense(d_ff)
    (h)))`` first."""

    def __init__(self, d_model: int, num_heads: int, d_head: int,
                 d_ff: int):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = _Attention(
            num_heads, num_heads * d_head, d_model)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-6)
        self.Dense_0 = Dense(d_model)
        self.Dense_1 = Dense(d_ff)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q: Tensor, kv: Tensor,
                kv_mask: Optional[Tensor] = None) -> Tensor:
        mask = None if kv_mask is None else kv_mask[:, None, None, :]
        a = self.MultiHeadDotProductAttention_0(q, kv, mask)
        h = self.LayerNorm_0(q + a)
        ff = self.Dense_0(torch.relu(self.Dense_1(h)))
        return self.LayerNorm_1(h + ff)


def _seed_param(shape) -> nn.Parameter:
    p = nn.Parameter(torch.empty(shape))
    glorot_uniform_(p, *fans(shape))
    return p


class SetTransformerEncoder(nn.Module):
    """SAB or ISAB self-attention over each graph's node set; returns
    per-node features (num_nodes, d_model)."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, d_ff: int,
                 n_layers: int = 1, block_type: str = "sab",
                 m: Optional[int] = None):
        super().__init__()
        if block_type not in ("sab", "isab"):
            raise ValueError(f"block_type {block_type!r}; expected 'sab' or "
                             "'isab'")
        if block_type == "isab" and m is None:
            raise ValueError("isab blocks need m inducing points")
        self.n_layers = n_layers
        self.block_type = block_type
        self.Dense_0 = Dense(d_model)
        for i in range(n_layers):
            if block_type == "sab":
                self.add_module(f"sab{i}", _MAB(d_model, n_heads, d_head,
                                                d_ff))
            else:
                self.register_parameter(f"induce{i}",
                                        _seed_param((m, d_model)))
                self.add_module(f"isab{i}_a", _MAB(d_model, n_heads,
                                                   d_head, d_ff))
                self.add_module(f"isab{i}_b", _MAB(d_model, n_heads,
                                                   d_head, d_ff))

    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        x, mask, (gid, pos) = _to_dense_batch(g, self.Dense_0(feat))
        for i in range(self.n_layers):
            if self.block_type == "sab":
                x = getattr(self, f"sab{i}")(x, x, mask)
            else:
                ind = getattr(self, f"induce{i}")
                ind = ind.expand((x.shape[0],) + tuple(ind.shape))
                h = getattr(self, f"isab{i}_a")(ind, x, mask)
                x = getattr(self, f"isab{i}_b")(x, h)
        return x[gid, pos]


class SetTransformerDecoder(nn.Module):
    """Pooling by k seed vectors (PMA) and SAB layers; returns
    (num_graphs, k * d_model)."""

    def __init__(self, d_model: int, num_heads: int, d_head: int, d_ff: int,
                 n_layers: int = 1, k: int = 1):
        super().__init__()
        self.d_model = d_model
        self.n_layers = n_layers
        self.k = k
        self.Dense_0 = Dense(d_model)
        self.seeds = _seed_param((k, d_model))
        self.pma = _MAB(d_model, num_heads, d_head, d_ff)
        for i in range(n_layers):
            self.add_module(f"sab{i}", _MAB(d_model, num_heads, d_head,
                                            d_ff))

    def forward(self, g: Graph, feat: Tensor) -> Tensor:
        x, mask, _ = _to_dense_batch(g, self.Dense_0(feat))
        q = self.seeds.expand((x.shape[0],) + tuple(self.seeds.shape))
        out = self.pma(q, x, mask)
        for i in range(self.n_layers):
            out = getattr(self, f"sab{i}")(out, out)
        return out.reshape(out.shape[0], self.k * self.d_model)
