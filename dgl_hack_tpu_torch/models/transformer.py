"""The graph transformer of ``examples/train_transformer.py`` on the port.

An encoder-decoder over one batched graph per attention pattern: encoder
self-attention (complete), decoder self-attention (causal) and
cross-attention (a complete bipartite block from encoder to decoder
nodes).  Every attention is the edge pipeline multi-head ``u_dot_v``
gsddmm (K6 on CUDA) -> edge_softmax -> ``u_mul_e`` gspmm (K1 on CUDA).
Trained on the copy task (the reference's synthetic dataset,
examples/pytorch/transformer) with teacher forcing.

Parameters carry the example's names and layouts (``emb``, ``pos``,
``enc0.q`` (Dm, Dm) used as ``h @ W``, ..., ``f1``, ``f2``, ``out``), so
``interop.flax_to_state_dict`` carries the JAX example's parameter dict
across unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import block, graph
from ..ops.edge_softmax import edge_softmax
from ..ops.sddmm import gsddmm
from ..ops.spmm import gspmm

Tensor = torch.Tensor

ATTENTIONS = ("enc0", "enc1", "dec0", "dec1", "x0", "x1")


def build_graphs(B: int, L: int, device=None):
    """Batched attention graphs over B sequences of length L: (encoder
    self-attention, decoder self-attention, cross-attention block).  Node
    spaces: encoder nodes (B*L) and decoder nodes (B*L)."""

    def batched(src1, dst1, n1):
        src = np.concatenate([src1 + b * n1 for b in range(B)])
        dst = np.concatenate([dst1 + b * n1 for b in range(B)])
        return src.astype(np.int32), dst.astype(np.int32)

    ar = np.arange(L)
    full = np.repeat(ar, L), np.tile(ar, L)                  # complete
    causal_pairs = [(i, j) for j in range(L) for i in range(j + 1)]
    csrc = np.array([p[0] for p in causal_pairs])
    cdst = np.array([p[1] for p in causal_pairs])

    es, ed = batched(*full, L)
    g_enc = graph((es, ed), num_nodes=B * L, device=device)
    ss, sd = batched(csrc, cdst, L)
    g_dec = graph((ss, sd), num_nodes=B * L, device=device)
    # cross: decoder position attends to every encoder position
    xs, xd = batched(*full, L)
    g_x = block((xs, xd), num_src=B * L, num_dst=B * L, device=device)
    return g_enc, g_dec, g_x


def _dense(rng: np.random.Generator, shape, scale: Optional[float] = None):
    scale = scale or (2.0 / sum(shape[-2:])) ** 0.5
    return nn.Parameter(torch.from_numpy(
        rng.normal(0, scale, shape).astype(np.float32)))


class _Attention(nn.Module):
    def __init__(self, rng: np.random.Generator, dim: int):
        super().__init__()
        for name in ("q", "k", "v", "o"):
            setattr(self, name, _dense(rng, (dim, dim)))


def layer_norm(h: Tensor) -> Tensor:
    """The example's ``ln``: no scale or shift, eps 1e-6."""
    mu = h.mean(-1, keepdim=True)
    s = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(s + 1e-6)


class GraphTransformer(nn.Module):
    """Encoder-decoder graph transformer: 2 encoder layers, 2 decoder
    layers with cross-attention, one FFN (Dm -> 2 Dm -> Dm) and the output
    head.  Parameters are drawn from ``rng`` (numpy, default seed 0) in the
    JAX example's order with its scales, so the same seed gives the same
    parameters."""

    def __init__(self, vocab: int = 16, seq_len: int = 10, dim: int = 64,
                 heads: int = 4, rng: Optional[np.random.Generator] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        rng = np.random.default_rng(0) if rng is None else rng
        self.vocab, self.seq_len, self.dim, self.heads = (vocab, seq_len,
                                                          dim, heads)
        self.emb = _dense(rng, (vocab + 1, dim), 0.1)      # +1: BOS token
        self.pos = _dense(rng, (seq_len, dim), 0.1)
        for name in ATTENTIONS:
            self.add_module(name, _Attention(rng, dim))
        self.f1 = _dense(rng, (dim, 2 * dim))
        self.f2 = _dense(rng, (2 * dim, dim))
        self.out = _dense(rng, (dim, vocab))

    def graph_attention(self, g, pa: _Attention, hq: Tensor,
                        hkv: Tensor) -> Tensor:
        """Multi-head attention over g: q from dst nodes, k/v from src
        nodes."""
        H, Dh = self.heads, self.dim // self.heads
        q = (hq @ pa.q).reshape(-1, H, Dh)
        k = (hkv @ pa.k).reshape(-1, H, Dh)
        v = (hkv @ pa.v).reshape(-1, H, Dh)
        logits = gsddmm(g, "dot", k, q, "u", "v") / Dh ** 0.5
        a = edge_softmax(g, logits)                          # (E, H, 1)
        out = gspmm(g, "mul", "sum", v, a, "u", "e")
        return out.reshape(-1, self.dim) @ pa.o

    def forward(self, graphs, src_tok: Tensor, tgt_in: Tensor) -> Tensor:
        """Logits (B, L, vocab) of the decoder fed ``tgt_in`` while the
        encoder reads ``src_tok``; both (B, L) token ids."""
        g_enc, g_dec, g_x = graphs
        B = src_tok.shape[0]
        pos = self.pos.repeat(B, 1)
        he = layer_norm(self.emb[src_tok.reshape(-1)] + pos)
        for name in ("enc0", "enc1"):
            he = layer_norm(he + self.graph_attention(
                g_enc, getattr(self, name), he, he))
        hd = layer_norm(self.emb[tgt_in.reshape(-1)] + pos)
        for s_name, x_name in (("dec0", "x0"), ("dec1", "x1")):
            hd = layer_norm(hd + self.graph_attention(
                g_dec, getattr(self, s_name), hd, hd))
            hd = layer_norm(hd + self.graph_attention(
                g_x, getattr(self, x_name), hd, he))
        hd = layer_norm(hd + F.relu(hd @ self.f1) @ self.f2)
        return (hd @ self.out).reshape(B, -1, self.vocab)


def copy_task_loss(model: GraphTransformer, graphs, src_tok: Tensor,
                   tgt: Tensor) -> Tuple[Tensor, Tensor]:
    """Teacher-forced mean token NLL of ``tgt`` (B, L), the decoder fed
    BOS (id ``vocab``) then tgt[:, :-1]; returns (loss, logits)."""
    B = tgt.shape[0]
    bos = torch.full((B, 1), model.vocab, dtype=tgt.dtype,
                     device=tgt.device)
    tgt_in = torch.cat([bos, tgt[:, :-1]], dim=1)
    logits = model(graphs, src_tok, tgt_in)
    logp = F.log_softmax(logits, -1)
    nll = -logp.gather(-1, tgt[..., None].long())[..., 0]
    return nll.mean(), logits
