"""Graph convolution layers (torch.nn), on gspmm, gsddmm and
gat_attention.

The math and parameter layouts are those of ``dgl_hack_tpu.nn.conv``, so
parameters convert one to one (``interop.py``) and outputs compare:

* ``GraphConv.weight`` is (in, out) and used as ``feat @ weight``;
* ``GATConv.fc`` is an ``nn.Linear`` (weight (out, in), no bias);
  ``attn_l``/``attn_r`` are (1, H, D);
* ``SAGEConv``'s flax ``Dense`` layers are ``nn.Linear`` modules of the
  same names (``fc_pool``, ``fc_self``, ``fc_neigh``), its lstm cell
  flax's ``OptimizedLSTMCell_0`` as torch's stacked LSTM weights;
  ``GINConv.eps`` is a () parameter when learned;
* the layers ported from the rest of the JAX ``nn/conv.py`` (SGConv …
  DenseGraphConv) name their flax ``Dense`` layers as it does (``fc``,
  ``lin``, ``theta``, ``phi``, ``res_fc``), as ``init.Dense`` modules
  initialised as flax initialises them; ``GatedGraphConv.gru`` is an
  ``nn.GRUCell`` (``init.GRUCell``; ``interop`` converts flax's gate
  kernels).

The input width is taken from the first call, as flax does: the layers
are lazy modules, so a model is built from its output widths alone.

Every layer that the JAX package feeds through ``_split_feat`` takes a
``(feat_src, feat_dst)`` pair on a bipartite block as well as one
tensor: ``GraphConv``, ``GATConv``, ``SAGEConv``, ``GINConv``,
``AGNNConv``, ``EdgeConv`` and ``NNConv``.  On a pair ``GATConv`` projects
the two sides with separate ``fc_src`` and ``fc_dst`` layers, as the JAX
layer does.

Dropout draws come from an explicit ``torch.Generator`` passed to
``forward`` (None: torch's default generator).  ``deterministic`` defaults
to ``not self.training``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter, is_lazy

from ..ops import segment
from ..ops.edge_softmax import edge_softmax
from ..ops.gat import gat_attention
from ..ops.rgcn import (rgcn_aggregate_pairs, rgcn_basis_message,
                        rgcn_reduce_pairs)
from ..ops.sddmm import gsddmm
from ..ops.spmm import gspmm
from ..utils.profiling import span, spanned
from .init import (Dense, GRUCell, fans, glorot_uniform_, lecun_normal_,
                   orthogonal_blocks_)

Tensor = torch.Tensor


def dropout(x: Tensor, p: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> Tensor:
    """Inverted dropout (keep with prob 1-p, scale by 1/(1-p)), drawing
    from ``generator``; the identity when deterministic or p == 0."""
    if deterministic or p == 0.0:
        return x
    with span("nn.dropout"):
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _glorot_normal_(t: Tensor, fan_in: int, fan_out: int) -> Tensor:
    with torch.no_grad():
        return t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)))


def _is_deterministic(module: nn.Module, deterministic: Optional[bool]):
    return (not module.training) if deterministic is None else deterministic


def _has_lazy(module: nn.Module) -> bool:
    """Whether any parameter of ``module`` or of its sub-modules is still
    uninitialised (``has_uninitialized_params`` sees only its own)."""
    return any(is_lazy(p) for p in module.parameters())


def _split_feat(feat):
    """(feat_src, feat_dst) of a pair, or the one tensor twice."""
    if isinstance(feat, (tuple, list)):
        return feat[0], feat[1]
    return feat, feat


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
            feat, _ = _split_feat(feat)
            in_feats = feat.shape[-1]
            self.weight.materialize((in_feats, self.out_feats),
                                    device=feat.device, dtype=feat.dtype)
            nn.init.xavier_uniform_(self.weight)

    def forward(self, g, feat, weight: Optional[Tensor] = None) -> Tensor:
        feat_src, _ = _split_feat(feat)
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
    Attention dropout is an explicit (E, H) post-softmax multiplier.

    On a ``(feat_src, feat_dst)`` pair the layer projects the sides with
    ``fc_src`` and ``fc_dst`` in place of ``fc`` (the JAX layer's names).
    It takes that layout at its first call on a pair, or when it loads a
    state dict that holds ``fc_src``; a call whose input does not match
    the layout (a pair to ``fc``, one tensor to ``fc_src``/``fc_dst``)
    raises."""

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
        self.fc_src = self.fc_dst = None
        self.attn_l = nn.Parameter(torch.empty(1, H, D))
        self.attn_r = nn.Parameter(torch.empty(1, H, D))
        _glorot_normal_(self.attn_l, H, D)
        _glorot_normal_(self.attn_r, H, D)
        self.res_fc = nn.LazyLinear(H * D, bias=False) if residual else None
        self._register_load_state_dict_pre_hook(self._layout_of_state)

    def _bipartite_layout(self) -> None:
        """Take ``fc_src`` and ``fc_dst`` (lazy) in place of ``fc``."""
        if self.fc_src is None:
            HD = self.num_heads * self.out_feats
            self.fc = None
            self.fc_src = nn.LazyLinear(HD, bias=False)
            self.fc_dst = nn.LazyLinear(HD, bias=False)

    def _layout_of_state(self, state_dict, prefix, *args) -> None:
        if prefix + "fc_src.weight" in state_dict:
            self._bipartite_layout()

    def initialize_parameters(self, g, feat, *args, **kwargs) -> None:
        if isinstance(feat, (tuple, list)):
            self._bipartite_layout()
        if not _has_lazy(self):
            return
        feat_src, feat_dst = _split_feat(feat)
        HD = self.num_heads * self.out_feats
        lins = [(self.fc_src, feat_src), (self.fc_dst, feat_dst)] \
            if self.fc is None else [(self.fc, feat_src)]
        if self.res_fc is not None:
            if feat_dst.shape[-1] == HD:
                self.res_fc = None          # identity residual
            else:
                lins.append((self.res_fc, feat_dst))
        for lin, f in lins:
            in_feats = f.shape[-1]
            lin.weight.materialize((HD, in_feats), device=f.device,
                                   dtype=f.dtype)
            lin.in_features = in_feats
            _glorot_normal_(lin.weight, in_feats, HD)

    @spanned("nn.GATConv")
    def forward(self, g, feat, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = _is_deterministic(self, deterministic)
        H, D = self.num_heads, self.out_feats
        if isinstance(feat, (tuple, list)) != (self.fc is None):
            have = "fc" if self.fc is not None else "fc_src/fc_dst"
            raise ValueError(f"GATConv: the layer holds {have}, which does "
                             "not take this input; a layer takes either "
                             "one feature tensor or (src, dst) pairs")
        feat_src, feat_dst = _split_feat(feat)
        h_src = dropout(feat_src, self.feat_drop, det, generator)
        h_dst = dropout(feat_dst, self.feat_drop, det, generator)
        if self.fc is None:
            fsrc = self.fc_src(h_src).view(-1, H, D)
            fdst = self.fc_dst(h_dst).view(-1, H, D)
        else:
            fsrc = self.fc(h_src).view(-1, H, D)
            fdst = fsrc if h_dst is h_src else self.fc(h_dst).view(-1, H, D)
        el = (fsrc * self.attn_l).sum(-1)                 # (N_src, H)
        er = (fdst * self.attn_r).sum(-1)                 # (N_dst, H)
        attn_w = None
        if self.attn_drop > 0.0 and not det:
            with span("nn.GATConv.attn_drop"):
                keep = torch.rand((g.num_edges(), H), generator=generator,
                                  device=fsrc.device) < 1.0 - self.attn_drop
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


def _init_linear(lin: nn.Module, in_feats: int, ref: Tensor) -> None:
    """Materialise a lazy ``nn.Linear`` at ``in_feats`` inputs with flax
    Dense's initialisation: xavier-uniform weight, zero bias."""
    lin.weight.materialize((lin.out_features, in_feats), device=ref.device,
                           dtype=ref.dtype)
    lin.in_features = in_feats
    nn.init.xavier_uniform_(lin.weight)
    if lin.bias is not None:
        lin.bias.materialize((lin.out_features,), device=ref.device,
                             dtype=ref.dtype)
        nn.init.zeros_(lin.bias)


_SAGE_AGGREGATORS = ("mean", "gcn", "pool", "lstm")


class _LazyLSTMCell(LazyModuleMixin, nn.Module):
    """flax's ``OptimizedLSTMCell`` at the width of its first input (hidden
    = input width), as torch stacks an LSTM cell's weights (gates i, f, g,
    o): ``weight_ih``/``weight_hh`` (4F, F) lecun-normal and orthogonal
    per gate, ``bias_hh`` zero; ``bias_ih`` exists for ``interop``'s layout
    and is held at 0 (flax's input gates have no bias).  Its forward is
    the input projection, ``step`` one step of the recurrence."""

    def __init__(self):
        super().__init__()
        self.weight_ih = UninitializedParameter()
        self.weight_hh = UninitializedParameter()
        self.bias_ih = UninitializedParameter()
        self.bias_hh = UninitializedParameter()

    def initialize_parameters(self, x, *args, **kwargs) -> None:
        if not self.has_uninitialized_params():
            return
        F_ = x.shape[-1]
        with torch.no_grad():
            for p, shape in ((self.weight_ih, (4 * F_, F_)),
                             (self.weight_hh, (4 * F_, F_)),
                             (self.bias_ih, (4 * F_,)),
                             (self.bias_hh, (4 * F_,))):
                p.materialize(shape, device=x.device, dtype=x.dtype)
            lecun_normal_(self.weight_ih, F_)
            orthogonal_blocks_(self.weight_hh, F_)
            self.bias_ih.zero_()
            self.bias_hh.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, self.weight_ih, self.bias_ih * 0.0)

    def step(self, xw: Tensor, h: Tensor, c: Tensor):
        """One step from the projected input ``xw`` (N, 4F)."""
        gates = xw + F.linear(h, self.weight_hh, self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


def _zero_input_carry(cell: _LazyLSTMCell, width: int, like: Tensor
                      ) -> Tensor:
    """(1, F) hidden state after ``width`` steps over zero inputs from a
    zero carry."""
    xw = cell(like.new_zeros((1, like.shape[-1])))
    h = like.new_zeros((1, xw.shape[-1] // 4))
    c = torch.zeros_like(h)
    for _ in range(width):
        h, c = cell.step(xw, h, c)
    return h


def mailbox_lstm(cell: _LazyLSTMCell, g, feat_src: Tensor,
                 width: int) -> Tensor:
    """flax's ``nn.RNN(cell, return_carry=True)`` over each dst node's
    padded mailbox of ``width`` slots (``build_mailbox``'s, padded edges
    zero), as the JAX ``SAGEConv('lstm')`` runs it: the final hidden state
    of each row at its length min(in-degree, width).

    Only live rows step: the rows sorted by length, step t runs the
    prefix of rows longer than t, and a row's carry is kept once its
    length is reached (the JAX scan's later steps leave it unused), so
    the work is the mailbox's real slots, not rows x width (one host
    sync, for the rows live at each step).  The mailbox is built in that
    order, time-major.  A row of length 0 takes what flax's carry
    selection gives it: index -1, the carry after ``width`` steps over
    zero inputs, the same for every such row, computed once.  As in
    ``build_mailbox``, a row of in-degree above ``width`` has several
    edges in its last slot, and which is left there is the scatter's
    choice."""
    from ..core.message import _box_rows, _slots
    N = g.num_dst_nodes
    lens = g.in_degrees().long().clamp(max=width)
    per_len = torch.bincount(lens, minlength=width + 1).tolist()
    live = [N - sum(per_len[:t + 1]) for t in range(width)]   # lens > t
    longest = max([t + 1 for t in range(width) if live[t]], default=0)
    order = torch.argsort(lens, descending=True, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=order.device)
    steps = ()
    if longest:
        slot = _slots(g.csc_indptr, g.dst, width)
        box = _box_rows(feat_src[g.src.long()], longest, N, slot,
                        rank[g.dst.long()], g.edge_mask)
        steps = box.unbind(0)                    # (N, F) per step, sorted
    h = feat_src.new_zeros((live[0] if width else 0, feat_src.shape[-1]))
    c = torch.zeros_like(h)
    done = []                    # rows whose length is reached, by length
    for t in range(longest):
        n = live[t]
        if n < h.shape[0]:
            done.append(h[n:])
            h, c = h[:n], c[:n]
        h, c = cell.step(cell(steps[t][:n]), h, c)
    done.append(h)
    n_empty = N - (live[0] if width else 0)
    if n_empty:
        done.insert(0, _zero_input_carry(cell, width, feat_src).expand(
            n_empty, -1))
    return torch.cat(done[::-1])[rank]


class SAGEConv(LazyModuleMixin, nn.Module):
    """GraphSAGE layer with the 'mean', 'gcn', 'pool' and 'lstm'
    aggregators.

    mean: h_neigh = mean of the in-neighbours (K1 on CUDA); gcn: (sum of
    the in-neighbours + h_dst) / (in_degree + 1), then ``fc_neigh`` alone;
    pool: ``relu(fc_pool(h_src))`` (in -> in) and its max over the
    in-neighbours (K4, with K5 in the backward, on CUDA); lstm: the
    in-neighbours' rows in the padded mailbox (``build_mailbox``, at most
    ``lstm_max_degree`` slots), an LSTM over them (``OptimizedLSTMCell_0``,
    hidden = input width, in torch: ``mailbox_lstm``) and its final hidden state at min(in-degree,
    lstm_max_degree), as the JAX layer's flax ``nn.RNN``.  For all but gcn
    the output is ``fc_self(h_dst) + fc_neigh(h_neigh)``.  Like the JAX
    layer, feature dropout takes two separate draws for the src and the
    dst side of the same features.  On a block the dst side is the pair's
    second tensor, and mean and pool count the block's real edges (gspmm),
    gcn and lstm its in-degree, padding included (``Graph.in_degrees``;
    padded slots hold zeros), as the JAX layer does."""

    def __init__(self, out_feats: int, aggregator_type: str = "mean",
                 feat_drop: float = 0.0, use_bias: bool = True,
                 activation: Optional[Callable] = None,
                 lstm_max_degree: int = 32):
        super().__init__()
        if aggregator_type not in _SAGE_AGGREGATORS:
            raise KeyError(f"Aggregator type {aggregator_type} not "
                           "recognized.")
        self.out_feats = out_feats
        self.aggregator_type = aggregator_type
        self.feat_drop = feat_drop
        self.activation = activation
        self.lstm_max_degree = lstm_max_degree
        self.fc_pool = nn.LazyLinear(0) if aggregator_type == "pool" \
            else None
        if aggregator_type == "lstm":     # flax's name for the cell
            self.OptimizedLSTMCell_0 = _LazyLSTMCell()
        self.fc_self = nn.LazyLinear(out_feats, bias=use_bias) \
            if aggregator_type != "gcn" else None
        self.fc_neigh = nn.LazyLinear(out_feats, bias=use_bias)

    def initialize_parameters(self, g, feat, *args, **kwargs) -> None:
        if not _has_lazy(self):
            return
        feat_src, feat_dst = _split_feat(feat)
        in_feats = feat_src.shape[-1]
        if self.fc_pool is not None:
            self.fc_pool.out_features = in_feats
            _init_linear(self.fc_pool, in_feats, feat_src)
        if self.aggregator_type == "lstm":
            self.OptimizedLSTMCell_0.initialize_parameters(feat_src)
        if self.fc_self is not None:
            _init_linear(self.fc_self, feat_dst.shape[-1], feat_dst)
        _init_linear(self.fc_neigh, in_feats, feat_src)

    @spanned("nn.SAGEConv")
    def forward(self, g, feat, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = _is_deterministic(self, deterministic)
        feat_src, feat_dst = _split_feat(feat)
        h_src = dropout(feat_src, self.feat_drop, det, generator)
        h_dst = dropout(feat_dst, self.feat_drop, det, generator)
        if self.aggregator_type == "mean":
            h_neigh = gspmm(g, "copy_lhs", "mean", h_src)
        elif self.aggregator_type == "gcn":
            s = gspmm(g, "copy_lhs", "sum", h_src)
            degs = g.in_degrees().to(h_dst.dtype)
            h_neigh = (s + h_dst) / (degs[:, None] + 1)
        elif self.aggregator_type == "pool":
            p = torch.relu(self.fc_pool(h_src))
            h_neigh = gspmm(g, "copy_lhs", "max", p)
        else:
            h_neigh = mailbox_lstm(self.OptimizedLSTMCell_0, g, h_src,
                                   self.lstm_max_degree)
        if self.aggregator_type == "gcn":
            rst = self.fc_neigh(h_neigh)
        else:
            rst = self.fc_self(h_dst) + self.fc_neigh(h_neigh)
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


_REGULARIZERS = ("basis", "bdd")


class RelGraphConv(LazyModuleMixin, nn.Module):
    """Relational GCN layer with the 'basis' or 'bdd' (block-diagonal)
    regularizer; ``etypes`` and ``norm`` come per edge in user order and
    are permuted to internal order once.

    Given a pair plan (``ops.rgcn.prepare_rgcn``), 'basis' runs the
    two-level (dst, etype)-pair aggregation: K1 over the pair graph, each
    pair's projection by its relation's weight, K1's edge-row mode per
    dst node.  Without
    one, and for 'bdd' always, it composes the per-edge messages in torch
    and sums them per dst node over the CSC rows (``gspmm`` copy_e: K1's
    edge-row mode on the card, a masked graph through its real-edge view).

    Parameters keep the flax layer's names and layouts, glorot-uniform
    with flax's fans: ``weight`` (B, in, out) for 'basis' and (R,
    B * in/B * out/B) for 'bdd', ``w_comp`` (R, B) where B < R, ``h_bias``
    (zero) and ``loop_weight`` (in, out), used as ``x @ loop_weight``.
    ``low_mem`` is accepted and unused, as in the JAX layer."""

    def __init__(self, out_feats: int, num_rels: int,
                 regularizer: str = "basis", num_bases: Optional[int] = None,
                 use_bias: bool = True,
                 activation: Optional[Callable] = None,
                 self_loop: bool = False, dropout: float = 0.0,
                 low_mem: bool = False):
        super().__init__()
        if regularizer not in _REGULARIZERS:
            raise ValueError("Regularizer must be either 'basis' or 'bdd'")
        self.out_feats = out_feats
        self.num_rels = num_rels
        self.regularizer = regularizer
        B = num_bases
        if B is None or B > num_rels or B <= 0:
            B = num_rels
        self.num_bases = B
        self.activation = activation
        self.dropout = dropout
        self.low_mem = low_mem
        self.weight = UninitializedParameter()
        self.w_comp = None
        if regularizer == "basis" and B < num_rels:
            self.w_comp = nn.Parameter(torch.empty(num_rels, B))
            glorot_uniform_(self.w_comp, num_rels, B)
        self.h_bias = nn.Parameter(torch.zeros(out_feats)) if use_bias \
            else None
        self.loop_weight = UninitializedParameter() if self_loop else None

    def initialize_parameters(self, g, x, *args, **kwargs) -> None:
        if not self.has_uninitialized_params():
            return
        in_feats, out, B = x.shape[-1], self.out_feats, self.num_bases
        if self.regularizer == "basis":
            shape = (B, in_feats, out)
        else:
            if in_feats % B or out % B:
                raise ValueError("Feature size must be a multiplier of "
                                 f"num_bases ({B}).")
            shape = (self.num_rels, B * (in_feats // B) * (out // B))
        for p, sh in ((self.weight, shape),
                      (self.loop_weight, (in_feats, out))):
            if p is not None:
                p.materialize(sh, device=x.device, dtype=x.dtype)
                glorot_uniform_(p, *fans(sh))

    def _edge_messages(self, g, x: Tensor, etypes: Tensor) -> Tensor:
        """(E, out) per-edge messages in internal order, composed."""
        if self.regularizer == "basis":
            z = torch.einsum("ni,bio->nbo", x, self.weight)
            if self.w_comp is not None:
                coef = self.w_comp[etypes]                    # (E, B)
                return torch.einsum("eb,ebo->eo", coef, z[g.src])
            return z[g.src, etypes]                           # (E, out)
        B = self.num_bases
        si, so = x.shape[-1] // B, self.out_feats // B
        w = self.weight[etypes].reshape(-1, B, si, so)        # (E, B, si, so)
        node = x[g.src].reshape(-1, B, 1, si)
        return torch.einsum("ebki,ebio->ebko", node, w).reshape(
            -1, self.out_feats)

    def forward(self, g, x: Tensor, etypes, norm: Optional[Tensor] = None,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                plan=None) -> Tensor:
        det = _is_deterministic(self, deterministic)
        if norm is not None:
            norm = torch.as_tensor(norm, device=x.device)
            if g.int2user is not None:
                norm = norm[g.int2user]
        if plan is not None and self.regularizer == "basis":
            agg = rgcn_aggregate_pairs(plan, x, norm)
            msg = rgcn_basis_message(plan, agg, self.weight, self.w_comp)
            h = rgcn_reduce_pairs(plan, msg, g.num_dst_nodes)
        else:
            etypes = torch.as_tensor(etypes, device=x.device).long()
            if g.int2user is not None:
                etypes = etypes[g.int2user]
            msg = self._edge_messages(g, x, etypes)
            if norm is not None:
                msg = msg * norm
            h = gspmm(g, "copy_lhs", "sum", msg, None, "e")
        if self.h_bias is not None:
            h = h + self.h_bias
        if self.loop_weight is not None:
            h = h + x @ self.loop_weight
        if self.activation is not None:
            h = self.activation(h)
        return dropout(h, self.dropout, det, generator)


class GINConv(nn.Module):
    """Graph isomorphism layer: apply_func((1 + eps) * h + aggregate(h))
    with aggregator_type in sum, mean, max, min (the gspmm reducers); a
    ``nn.Module`` apply_func is a sub-module named ``apply_func``, as in
    flax."""

    def __init__(self, apply_func: Optional[Callable] = None,
                 aggregator_type: str = "sum", init_eps: float = 0.0,
                 learn_eps: bool = False):
        super().__init__()
        self.apply_func = apply_func
        self.aggregator_type = aggregator_type
        if learn_eps:
            self.eps = nn.Parameter(torch.tensor(float(init_eps)))
        else:
            self.eps = float(init_eps)

    def forward(self, g, feat) -> Tensor:
        feat_src, feat_dst = _split_feat(feat)
        agg = gspmm(g, "copy_lhs", self.aggregator_type, feat_src)
        rst = (1 + self.eps) * feat_dst + agg
        if self.apply_func is not None:
            rst = self.apply_func(rst)
        return rst


# ---------------------------------------------------------------------------
# Propagation layers: repeated copy_u-sum (K1 on CUDA)
# ---------------------------------------------------------------------------
def _sym_norm(g, feat: Tensor) -> Tensor:
    """(N, 1) rsqrt(clamp(in_degree, 1)), the D^-1/2 of D^-1/2 A D^-1/2."""
    degs = g.in_degrees().to(feat.dtype).clamp(min=1.0)
    return torch.rsqrt(degs)[:, None]


def _propagate(g, h: Tensor, norm: Tensor,
               w: Optional[Tensor] = None) -> Tensor:
    """D^-1/2 A D^-1/2 h, with an optional (E, 1) edge weight."""
    if w is None:
        return norm * gspmm(g, "copy_lhs", "sum", h * norm)
    return norm * gspmm(g, "mul", "sum", h * norm, w, "u", "e")


class SGConv(nn.Module):
    """Simplified GCN: (D^-1/2 A D^-1/2)^k X W, then a dense layer ``fc``
    (glorot-uniform)."""

    def __init__(self, out_feats: int, k: int = 1, use_bias: bool = True):
        super().__init__()
        self.k = k
        self.fc = Dense(out_feats, bias=use_bias, kernel_init="xavier")

    def forward(self, g, feat: Tensor) -> Tensor:
        norm = _sym_norm(g, feat)
        h = feat
        for _ in range(self.k):
            h = _propagate(g, h, norm)
        return self.fc(h)


class APPNPConv(nn.Module):
    """Approximate personalised propagation:
    h <- (1 - alpha) D^-1/2 A D^-1/2 h + alpha h0, k times.  With
    ``edge_drop`` each step drops edges through an (E, 1) weight, which K1
    takes as one scalar per edge; without it the step is a copy_u sum."""

    def __init__(self, k: int, alpha: float, edge_drop: float = 0.0):
        super().__init__()
        self.k = k
        self.alpha = alpha
        self.edge_drop = edge_drop

    def forward(self, g, feat: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = _is_deterministic(self, deterministic)
        norm = _sym_norm(g, feat)
        h = feat
        for _ in range(self.k):
            w = None
            if self.edge_drop > 0.0 and not det:
                w = dropout(feat.new_ones((g.num_edges(), 1)),
                            self.edge_drop, det, generator)
            h = _propagate(g, h, norm, w)
            h = (1 - self.alpha) * h + self.alpha * feat
        return h


class TAGConv(nn.Module):
    """Topology-adaptive GCN: the concatenation of the 0..k-hop normalised
    propagations through one dense layer ``lin`` (glorot-uniform)."""

    def __init__(self, out_feats: int, k: int = 2, use_bias: bool = True,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.k = k
        self.activation = activation
        self.lin = Dense(out_feats, bias=use_bias, kernel_init="xavier")

    def forward(self, g, feat: Tensor) -> Tensor:
        norm = _sym_norm(g, feat)
        fstack = [feat]
        for _ in range(self.k):
            fstack.append(_propagate(g, fstack[-1], norm))
        rst = self.lin(torch.cat(fstack, dim=-1))
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class ChebConv(nn.Module):
    """Chebyshev spectral GCN of order k with the scaled Laplacian
    L~ = (2 / lambda_max) (I - D^-1/2 A D^-1/2) - I, then ``fc``."""

    def __init__(self, out_feats: int, k: int, use_bias: bool = True):
        super().__init__()
        self.k = k
        self.fc = Dense(out_feats, bias=use_bias, kernel_init="xavier")

    def forward(self, g, feat: Tensor, lambda_max: float = 2.0) -> Tensor:
        norm = _sym_norm(g, feat)

        def laplacian(h):
            return (2.0 / lambda_max) * (h - _propagate(g, h, norm)) - h

        xs = [feat]
        if self.k > 1:
            xs.append(laplacian(feat))
        for _ in range(2, self.k):
            xs.append(2 * laplacian(xs[-1]) - xs[-2])
        return self.fc(torch.cat(xs, dim=-1))


# ---------------------------------------------------------------------------
# Edge layers: gsddmm (K6 on CUDA), then a reduction
# ---------------------------------------------------------------------------
class AGNNConv(nn.Module):
    """Attention-based GNN: softmax over in-edges of beta * cos(x_u, x_v)
    (K6's dot over the normalised features), then u_mul_e sum with that
    (E, 1) weight (K1)."""

    def __init__(self, init_beta: float = 1.0, learn_beta: bool = True):
        super().__init__()
        if learn_beta:
            self.beta = nn.Parameter(torch.tensor(float(init_beta)))
        else:
            self.beta = float(init_beta)

    def forward(self, g, feat) -> Tensor:
        feat_src, feat_dst = _split_feat(feat)
        nsrc = feat_src / feat_src.norm(dim=-1, keepdim=True).clamp(
            min=1e-12)
        ndst = nsrc if feat_dst is feat_src else feat_dst / feat_dst.norm(
            dim=-1, keepdim=True).clamp(min=1e-12)
        cos = gsddmm(g, "dot", nsrc, ndst, "u", "v")          # (E, 1)
        a = edge_softmax(g, self.beta * cos)
        return gspmm(g, "mul", "sum", feat_src, a, "u", "e")


class EdgeConv(nn.Module):
    """EdgeConv (DGCNN): out_v = max over in-edges of theta(x_u - x_v) +
    phi(x_v).  x_u - x_v is K6's u_sub_v; the max is torch's scatter, as
    the JAX layer's is XLA's (ties split the cotangent evenly)."""

    def __init__(self, out_feats: int):
        super().__init__()
        self.theta = Dense(out_feats, kernel_init="xavier")
        self.phi = Dense(out_feats, kernel_init="xavier")

    def forward(self, g, feat) -> Tensor:
        feat_src, feat_dst = _split_feat(feat)
        diff = gsddmm(g, "sub", feat_src, feat_dst, "u", "v")
        msg = self.theta(diff) + self.phi(feat_dst)[g.dst]
        return segment.segment_reduce("max", msg, g.dst, g.num_dst_nodes,
                                      mask=g.edge_mask)


class GatedGraphConv(nn.Module):
    """Gated graph conv (GGNN): ``n_steps`` of per-etype linear messages,
    summed per dst node over the CSC-ordered messages (K1's edge-row mode),
    then a GRU update with the node state as the carry.  ``etypes`` come
    in user edge order.  ``gru`` is flax's GRU cell (``init.GRUCell``, an
    ``nn.GRUCell``); ``weight`` is (n_etypes, out, out), glorot-uniform."""

    def __init__(self, out_feats: int, n_steps: int, n_etypes: int = 1):
        super().__init__()
        self.out_feats = out_feats
        self.n_steps = n_steps
        self.n_etypes = n_etypes
        shape = (n_etypes, out_feats, out_feats)
        self.weight = nn.Parameter(torch.empty(shape))
        glorot_uniform_(self.weight, *fans(shape))
        self.gru = GRUCell(out_feats, out_feats)

    def forward(self, g, feat: Tensor,
                etypes: Optional[Tensor] = None) -> Tensor:
        in_feats = feat.shape[1]
        if in_feats < self.out_feats:
            feat = F.pad(feat, (0, self.out_feats - in_feats))
        if etypes is None:
            etypes = torch.zeros(g.num_edges(), dtype=torch.long,
                                 device=feat.device)
        else:
            etypes = torch.as_tensor(etypes, device=feat.device).long()
            if g.int2user is not None:
                etypes = etypes[g.int2user]
        h = feat
        for _ in range(self.n_steps):
            zh = torch.einsum("ni,rio->nro", h, self.weight)
            msg = zh[g.src, etypes]                        # (E, out)
            a = gspmm(g, "copy_lhs", "sum", msg, None, "e")
            h = self.gru(a, h)
        return h


_NN_AGGREGATORS = ("sum", "mean", "max")


class NNConv(nn.Module):
    """Edge-network conv (MPNN): ``edge_func`` maps each edge's features
    (user order) to an (in, out) matrix, the message is x_u times it, and
    the messages are reduced per dst node: sum and mean by K1's edge-row
    mode, max by torch's scatter (XLA in the JAX layer)."""

    def __init__(self, out_feats: int, edge_func: Callable,
                 aggregator_type: str = "mean", residual: bool = False,
                 use_bias: bool = True):
        super().__init__()
        if aggregator_type not in _NN_AGGREGATORS:
            raise KeyError(f"Aggregator type {aggregator_type} not "
                           "recognized.")
        self.out_feats = out_feats
        self.edge_func = edge_func
        self.aggregator_type = aggregator_type
        self.res_fc = Dense(out_feats, bias=False, kernel_init="xavier") \
            if residual else None
        self.bias = nn.Parameter(torch.zeros(out_feats)) if use_bias \
            else None

    def forward(self, g, feat, efeat: Tensor) -> Tensor:
        feat_src, feat_dst = _split_feat(feat)
        if g.int2user is not None:
            efeat = efeat[g.int2user]
        ew = self.edge_func(efeat).reshape(-1, feat_src.shape[-1],
                                           self.out_feats)
        msg = torch.einsum("ei,eio->eo", feat_src[g.src], ew)
        if self.aggregator_type == "max":
            rst = segment.segment_reduce("max", msg, g.dst, g.num_dst_nodes,
                                         mask=g.edge_mask)
        else:
            rst = gspmm(g, "copy_lhs", self.aggregator_type, msg, None, "e")
        if self.res_fc is not None:
            rst = rst + self.res_fc(feat_dst)
        if self.bias is not None:
            rst = rst + self.bias
        return rst


class DenseGraphConv(LazyModuleMixin, nn.Module):
    """GraphConv on a dense (N, N) adjacency (rows dst, columns src), with
    dense matmuls; ``weight`` (in, out) glorot-uniform, ``bias`` zero."""

    def __init__(self, out_feats: int, norm: str = "both",
                 use_bias: bool = True,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.out_feats = out_feats
        self.norm = norm
        self.activation = activation
        self.weight = UninitializedParameter()
        self.bias = nn.Parameter(torch.zeros(out_feats)) if use_bias \
            else None

    def initialize_parameters(self, adj, feat, *args, **kwargs) -> None:
        if self.has_uninitialized_params():
            shape = (feat.shape[-1], self.out_feats)
            self.weight.materialize(shape, device=feat.device,
                                    dtype=feat.dtype)
            glorot_uniform_(self.weight, *fans(shape))

    def forward(self, adj: Tensor, feat: Tensor) -> Tensor:
        in_feats = feat.shape[-1]
        if self.norm == "both":
            out_degs = adj.sum(0).clamp(min=1.0)
            feat = feat * torch.rsqrt(out_degs)[:, None]
        if in_feats > self.out_feats:
            rst = adj @ (feat @ self.weight)
        else:
            rst = (adj @ feat) @ self.weight
        if self.norm != "none":
            in_degs = adj.sum(1).clamp(min=1.0)
            norm = torch.rsqrt(in_degs) if self.norm == "both" \
                else 1.0 / in_degs
            rst = rst * norm[:, None]
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst
