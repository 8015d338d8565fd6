"""Graph convolution layers (torch.nn), on gspmm and gat_attention.

The math and parameter layouts are those of ``dgl_hack_tpu.nn.conv``, so
parameters convert one to one (``interop.py``) and outputs compare:

* ``GraphConv.weight`` is (in, out) and used as ``feat @ weight``;
* ``GATConv.fc`` is an ``nn.Linear`` (weight (out, in), no bias);
  ``attn_l``/``attn_r`` are (1, H, D).

The input width is taken from the first call, as flax does: the layers
are lazy modules, so a model is built from its output widths alone.

Dropout draws come from an explicit ``torch.Generator`` passed to
``forward`` (None: torch's default generator).  ``deterministic`` defaults
to ``not self.training``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter

from ..ops.gat import gat_attention
from ..ops.spmm import gspmm

Tensor = torch.Tensor


def dropout(x: Tensor, p: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> Tensor:
    """Inverted dropout (keep with prob 1-p, scale by 1/(1-p)), drawing
    from ``generator``; the identity when deterministic or p == 0."""
    if deterministic or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _glorot_normal_(t: Tensor, fan_in: int, fan_out: int) -> Tensor:
    with torch.no_grad():
        return t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)))


def _is_deterministic(module: nn.Module, deterministic: Optional[bool]):
    return (not module.training) if deterministic is None else deterministic


class GraphConv(LazyModuleMixin, nn.Module):
    """Kipf-Welling GCN layer.

    norm='both' applies D^{-1/2} A D^{-1/2} with clamp(deg, 1); 'right'
    divides by the in-degree; 'none' skips it.  The matmul runs before the
    aggregation when it shrinks the feature width."""

    def __init__(self, out_feats: int, norm: str = "both",
                 weight: bool = True, bias: bool = True,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.out_feats = out_feats
        self.norm = norm
        self.activation = activation
        self.weight = UninitializedParameter() if weight else None
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None

    def initialize_parameters(self, g, feat, *args, **kwargs) -> None:
        if self.has_uninitialized_params():
            in_feats = feat.shape[-1]
            self.weight.materialize((in_feats, self.out_feats),
                                    device=feat.device, dtype=feat.dtype)
            nn.init.xavier_uniform_(self.weight)

    def forward(self, g, feat: Tensor,
                weight: Optional[Tensor] = None) -> Tensor:
        feat_src = feat
        in_feats = feat_src.shape[-1]
        if self.norm == "both":
            degs = g.out_degrees().to(feat_src.dtype).clamp(min=1.0)
            norm = torch.rsqrt(degs)
            feat_src = feat_src * norm.reshape(
                (-1,) + (1,) * (feat_src.dim() - 1))
        if weight is None:
            weight = self.weight
        if in_feats > self.out_feats:
            if weight is not None:
                feat_src = feat_src @ weight
            rst = gspmm(g, "copy_lhs", "sum", feat_src)
        else:
            rst = gspmm(g, "copy_lhs", "sum", feat_src)
            if weight is not None:
                rst = rst @ weight
        if self.norm != "none":
            degs = g.in_degrees().to(rst.dtype).clamp(min=1.0)
            norm = torch.rsqrt(degs) if self.norm == "both" else 1.0 / degs
            rst = rst * norm.reshape((-1,) + (1,) * (rst.dim() - 1))
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class GATConv(LazyModuleMixin, nn.Module):
    """Graph attention layer; output shape (N, num_heads, out_feats).

    Decomposed attention a^T[Wh_i || Wh_j] = a_l.Wh_i + a_r.Wh_j: two dense
    reductions, then the fused edge phase (gat_attention).  Like the JAX
    layer, feature dropout takes two separate draws for the src and the
    dst side of the same features (DGL draws once; ROADMAP Queue 3).
    Attention dropout is an explicit (E, H) post-softmax multiplier."""

    def __init__(self, out_feats: int, num_heads: int, feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2,
                 residual: bool = False,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.residual = residual
        self.activation = activation
        H, D = num_heads, out_feats
        self.fc = nn.LazyLinear(H * D, bias=False)
        self.attn_l = nn.Parameter(torch.empty(1, H, D))
        self.attn_r = nn.Parameter(torch.empty(1, H, D))
        _glorot_normal_(self.attn_l, H, D)
        _glorot_normal_(self.attn_r, H, D)
        self.res_fc = nn.LazyLinear(H * D, bias=False) if residual else None

    def initialize_parameters(self, g, feat, *args, **kwargs) -> None:
        if not self.has_uninitialized_params():
            return
        HD = self.num_heads * self.out_feats
        in_feats = feat.shape[-1]
        lins = [self.fc]
        if self.res_fc is not None:
            if in_feats == HD:
                self.res_fc = None          # identity residual
            else:
                lins.append(self.res_fc)
        for lin in lins:
            lin.weight.materialize((HD, in_feats), device=feat.device,
                                   dtype=feat.dtype)
            lin.in_features = in_feats
            _glorot_normal_(lin.weight, in_feats, HD)

    def forward(self, g, feat: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if isinstance(feat, (tuple, list)):
            raise NotImplementedError(
                "bipartite (src, dst) features are not ported yet "
                "(ROADMAP: 'sampling')")
        det = _is_deterministic(self, deterministic)
        H, D = self.num_heads, self.out_feats
        h_src = dropout(feat, self.feat_drop, det, generator)
        h_dst = dropout(feat, self.feat_drop, det, generator)
        fsrc = self.fc(h_src).view(-1, H, D)
        fdst = fsrc if h_dst is h_src else self.fc(h_dst).view(-1, H, D)
        el = (fsrc * self.attn_l).sum(-1)                 # (N_src, H)
        er = (fdst * self.attn_r).sum(-1)                 # (N_dst, H)
        attn_w = None
        if self.attn_drop > 0.0 and not det:
            keep = torch.rand((g.num_edges(), H), generator=generator,
                              device=feat.device) < 1.0 - self.attn_drop
            attn_w = keep.to(fsrc.dtype) / (1.0 - self.attn_drop)
        rst = gat_attention(g, fsrc, el, er, self.negative_slope, attn_w)
        if self.residual:
            if self.res_fc is not None:
                res = self.res_fc(h_dst).view(-1, H, D)
            else:
                res = h_dst.view(h_dst.shape[0], -1, D)
            rst = rst + res
        if self.activation is not None:
            rst = self.activation(rst)
        return rst

