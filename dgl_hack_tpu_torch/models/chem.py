"""The molecular property-prediction model zoo, as
``dgl_hack_tpu.models.chem`` (reference: python/dgl/model_zoo/chem/ —
classifiers.py, gnn.py, schnet.py, mgcn.py, mpnn.py, attentive_fp.py,
layers.py, acnn.py; Weave and WLN from dgllife).

Sub-modules carry the flax modules' names (``Dense_0`` ..., ``CFConv_0``,
``GRUCell_0``, ``Embed_0``, ``LayerNorm_0``), in the order flax names them
(in ``Dense(a)(act(Dense(b)(x)))`` the outer Dense is built first, so it is
``Dense_0``), so ``interop.flax_to_state_dict`` of a JAX model's
parameters loads into the port's model.  The defaults are the JAX classes'
(DGL 0.4's model-zoo widths).

On the card each model reaches the hand-written kernels through the ops it
calls: CFConv and VEConv's u_mul_e sums with an (E, F) filter, WLN's, and
AttentiveGRU2's with an (E, 1) weight run K1; the copy_e sums (VEConv,
AttentiveGRU1, Weave, WLN, NNConv in MPNN, AtomicConv) and the sum
readouts (SumPooling, WeightAndSum, Set2Set, AttentiveFP's readout) run
K1's edge-row mode; GATConv's edge phase runs K2 and K3; the dst-side
copies of AttentiveFP and Weave's u_add_v run K6.  Gathers of a src-side
operand onto edges compose, as in the JAX package.  max readouts, softmax
and edge_softmax are torch ops.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import Graph
from ..nn.conv import GATConv, GraphConv, NNConv, _is_deterministic, dropout
from ..nn.conv_extra import WLN, AtomicConv, WeaveGNN
from ..nn.glob import Set2Set, SumPooling, WeightAndSum
from ..nn.init import Dense, GRUCell
from ..ops import readout
from ..ops.edge_softmax import edge_softmax
from ..ops.sddmm import gsddmm
from ..ops.spmm import gspmm

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared small pieces (reference: model_zoo/chem/layers.py)
# ---------------------------------------------------------------------------
def softplus_beta(x: Tensor, beta: float = 1.0) -> Tensor:
    """1/beta * log(1 + exp(beta x))."""
    return torch.logaddexp(beta * x, torch.zeros_like(x)) / beta


def shifted_softplus(x: Tensor, beta: float = 1.0,
                     shift: float = 2.0) -> Tensor:
    """softplus(x; beta) - log(shift) (reference: ShiftSoftplus)."""
    return softplus_beta(x, beta) - float(np.log(shift))


def _softplus_half(x: Tensor) -> Tensor:
    return softplus_beta(x, 0.5)


def _leaky(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.01)


class RBFExpansion(nn.Module):
    """Radial basis expansion of scalar edge distances (reference:
    RBFLayer): e_k(d) = exp(-(d - mu_k)^2 / gap)."""

    def __init__(self, low: float = 0.0, high: float = 30.0,
                 gap: float = 0.1):
        super().__init__()
        self.low, self.high, self.gap = low, high, gap

    @property
    def fan_out(self) -> int:
        return int(np.ceil((self.high - self.low) / self.gap))

    def forward(self, dist: Tensor) -> Tensor:
        centers = np.linspace(self.low, self.high, self.fan_out)
        gap = centers[1] - centers[0] if self.fan_out > 1 else self.gap
        radial = dist.reshape(-1, 1) - torch.as_tensor(
            centers, dtype=dist.dtype, device=dist.device)
        return torch.exp((-1.0 / float(gap)) * radial ** 2)


def _embed(num: int, dim: int) -> nn.Embedding:
    """flax's ``Embed``: normal with variance 1/dim."""
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0 / math.sqrt(dim))
    return emb


class AtomEmbedding(nn.Module):
    """Atomic-number embedding table (reference: AtomEmbedding)."""

    def __init__(self, dim: int = 128, type_num: int = 100):
        super().__init__()
        self.Embed_0 = _embed(type_num, dim)

    def forward(self, atom_types: Tensor) -> Tensor:
        return self.Embed_0(atom_types.long())


def pair_edge_types(g: Graph, atom_types: Tensor) -> Tensor:
    """Unordered pairing of the endpoints' atomic numbers into one edge
    type id, x*y + (|x-y| - 1)^2 // 4 (reference:
    EdgeEmbedding.generate_edge_type), internal edge order."""
    t = atom_types.long()
    x, y = t[g.src.long()], t[g.dst.long()]
    return x * y + torch.div((torch.abs(x - y) - 1) ** 2, 4,
                             rounding_mode="floor")


class EdgeEmbedding(nn.Module):
    """Edge-type embedding keyed on the unordered endpoint-type pair
    (reference: EdgeEmbedding)."""

    def __init__(self, dim: int = 128, edge_num: int = 3000):
        super().__init__()
        self.Embed_0 = _embed(edge_num, dim)

    def forward(self, g: Graph, atom_types: Tensor) -> Tensor:
        return self.Embed_0(pair_edge_types(g, atom_types))


# ---------------------------------------------------------------------------
# SchNet (reference: schnet.py, layers.py CFConv/Interaction)
# ---------------------------------------------------------------------------
class CFConv(nn.Module):
    """Continuous-filter convolution: per-edge filters from an MLP over the
    RBF expansion, then a u_mul_e sum (K1 with an (E, F) weight)."""

    def __init__(self, dim: int = 64, act: Callable = _softplus_half):
        super().__init__()
        self.act = act
        self.Dense_0 = Dense(dim)       # outer
        self.Dense_1 = Dense(dim)       # on the RBF expansion

    def forward(self, g: Graph, node_weight: Tensor,
                rbf_out: Tensor) -> Tensor:
        e = self.Dense_0(self.act(self.Dense_1(rbf_out)))
        return gspmm(g, "mul", "sum", node_weight, e)


class SchNetInteraction(nn.Module):
    """Residual interaction block (reference: Interaction)."""

    def __init__(self, rbf_dim: int, dim: int):
        super().__init__()
        self.Dense_0 = Dense(dim, bias=False)
        self.CFConv_0 = CFConv(dim, _softplus_half)
        self.Dense_1 = Dense(dim)       # outer
        self.Dense_2 = Dense(dim)

    def forward(self, g: Graph, n_feat: Tensor, rbf_out: Tensor) -> Tensor:
        h = self.CFConv_0(g, self.Dense_0(n_feat), rbf_out)
        h = self.Dense_1(_softplus_half(self.Dense_2(h)))
        return n_feat + h


class SchNet(nn.Module):
    """SchNet for molecular property regression (reference: schnet.py).

    forward(g, atom_types (N,) int, edge_distances (E,) or (E, 1) in
    internal edge order) -> (num_graphs, output_dim)."""

    def __init__(self, dim: int = 64, cutoff: float = 5.0,
                 output_dim: int = 1, width: float = 1.0, n_conv: int = 3,
                 norm: bool = False, mean: float = 0.0, std: float = 1.0):
        super().__init__()
        self.n_conv, self.norm = n_conv, norm
        self.mean, self.std = mean, std
        self.rbf = RBFExpansion(0.0, cutoff, width)
        self.AtomEmbedding_0 = AtomEmbedding(dim)
        for i in range(n_conv):
            self.add_module(f"SchNetInteraction_{i}",
                            SchNetInteraction(self.rbf.fan_out, dim))
        self.Dense_0 = Dense(output_dim)    # outer
        self.Dense_1 = Dense(64)
        self.SumPooling_0 = SumPooling()

    def forward(self, g: Graph, atom_types: Tensor,
                edge_distances: Tensor) -> Tensor:
        h = self.AtomEmbedding_0(atom_types)
        rbf_out = self.rbf(edge_distances)
        for i in range(self.n_conv):
            h = getattr(self, f"SchNetInteraction_{i}")(g, h, rbf_out)
        h = self.Dense_0(shifted_softplus(self.Dense_1(h)))
        if self.norm:
            h = h * self.std + self.mean
        return self.SumPooling_0(g, h)


# ---------------------------------------------------------------------------
# MGCN (reference: mgcn.py, layers.py VEConv/MultiLevelInteraction)
# ---------------------------------------------------------------------------
class VEConv(nn.Module):
    """Vertex-edge convolution: summed u_mul_e messages under an RBF filter
    (K1, (E, F) weight) plus the summed edge features (K1's edge rows)."""

    def __init__(self, dim: int = 64, update_edge: bool = True):
        super().__init__()
        self.Dense_0 = Dense(dim)       # outer
        self.Dense_1 = Dense(dim)       # on the RBF expansion
        self.Dense_2 = Dense(dim) if update_edge else None

    def forward(self, g: Graph, n_feat: Tensor, e_feat: Tensor,
                rbf_out: Tensor):
        rbf_out = self.Dense_0(_softplus_half(self.Dense_1(rbf_out)))
        if self.Dense_2 is not None:
            e_feat = self.Dense_2(e_feat)
        m0 = gspmm(g, "mul", "sum", n_feat, rbf_out)
        m1 = gspmm(g, "copy_rhs", "sum", None, e_feat)
        return m0 + m1, e_feat


class MultiLevelInteraction(nn.Module):
    """Multilevel interaction block (reference: MultiLevelInteraction)."""

    def __init__(self, rbf_dim: int, dim: int):
        super().__init__()
        self.Dense_0 = Dense(dim)
        self.VEConv_0 = VEConv(dim)
        self.Dense_1 = Dense(dim)       # outer
        self.Dense_2 = Dense(dim)
        self.Dense_3 = Dense(dim)

    def forward(self, g: Graph, n_feat: Tensor, e_feat: Tensor,
                rbf_out: Tensor):
        h, e_feat = self.VEConv_0(g, self.Dense_0(n_feat), e_feat, rbf_out)
        h = self.Dense_1(_softplus_half(self.Dense_2(h)))
        n_feat = n_feat + h
        e_feat = _softplus_half(self.Dense_3(e_feat))
        return n_feat, e_feat


class MGCN(nn.Module):
    """Multilevel graph conv net (reference: mgcn.py MGCNModel): the
    per-level atom representations concatenated, then the head."""

    def __init__(self, dim: int = 128, width: float = 1.0,
                 cutoff: float = 5.0, edge_dim: int = 128,
                 output_dim: int = 1, n_conv: int = 3, norm: bool = False,
                 mean: float = 0.0, std: float = 1.0):
        super().__init__()
        self.n_conv, self.norm = n_conv, norm
        self.mean, self.std = mean, std
        self.rbf = RBFExpansion(0.0, cutoff, width)
        self.AtomEmbedding_0 = AtomEmbedding(dim)
        self.EdgeEmbedding_0 = EdgeEmbedding(edge_dim)
        for i in range(n_conv):
            self.add_module(f"MultiLevelInteraction_{i}",
                            MultiLevelInteraction(self.rbf.fan_out, dim))
        self.Dense_0 = Dense(output_dim)    # outer
        self.Dense_1 = Dense(64)
        self.SumPooling_0 = SumPooling()

    def forward(self, g: Graph, atom_types: Tensor,
                edge_distances: Tensor) -> Tensor:
        h = self.AtomEmbedding_0(atom_types)
        e = self.EdgeEmbedding_0(g, atom_types)
        rbf_out = self.rbf(edge_distances)
        levels = [h]
        for i in range(self.n_conv):
            h, e = getattr(self, f"MultiLevelInteraction_{i}")(g, h, e,
                                                               rbf_out)
            levels.append(h)
        h = self.Dense_0(softplus_beta(self.Dense_1(torch.cat(levels, 1))))
        if self.norm:
            h = h * self.std + self.mean
        return self.SumPooling_0(g, h)


# ---------------------------------------------------------------------------
# MPNN (reference: mpnn.py MPNNModel)
# ---------------------------------------------------------------------------
class MPNN(nn.Module):
    """Neural message passing for quantum chemistry: NNConv edge-network
    message passing (its per-edge (in, out) matrices from ``Dense_1``,
    relu, ``Dense_2``: flax builds the Sequential's Denses in the model's
    scope), unrolled with a GRU, and a Set2Set readout (reference:
    mpnn.py).  The edge features are user order (NNConv puts them in
    internal order)."""

    def __init__(self, node_input_dim: int = 15, edge_input_dim: int = 5,
                 output_dim: int = 12, node_hidden_dim: int = 64,
                 edge_hidden_dim: int = 128,
                 num_step_message_passing: int = 6,
                 num_step_set2set: int = 6):
        super().__init__()
        nh = node_hidden_dim
        self.num_step_message_passing = num_step_message_passing
        self.Dense_0 = Dense(nh)
        self.Dense_1 = Dense(edge_hidden_dim)
        self.Dense_2 = Dense(nh * nh)
        self.NNConv_0 = NNConv(nh, edge_func=self._edge_net,
                               aggregator_type="sum")
        self.GRUCell_0 = GRUCell(nh, nh)
        self.Set2Set_0 = Set2Set(nh, n_iters=num_step_set2set)
        self.Dense_3 = Dense(nh)
        self.Dense_4 = Dense(output_dim)

    def _edge_net(self, efeat: Tensor) -> Tensor:
        return self.Dense_2(F.relu(self.Dense_1(efeat)))

    def forward(self, g: Graph, n_feat: Tensor, e_feat: Tensor) -> Tensor:
        h = F.relu(self.Dense_0(n_feat))
        state = h
        for _ in range(self.num_step_message_passing):
            m = F.relu(self.NNConv_0(g, h, e_feat))
            state = h = self.GRUCell_0(m, state)
        out = self.Set2Set_0(g, h)
        return self.Dense_4(F.relu(self.Dense_3(out)))


# ---------------------------------------------------------------------------
# GCN / GAT property classifiers (reference: classifiers.py, gnn.py)
# ---------------------------------------------------------------------------
class MLPBinaryClassifier(nn.Module):
    """Two-layer MLP head; LayerNorm (eps 1e-6, flax's) where the
    reference has BatchNorm1d, as in the JAX class."""

    def __init__(self, hidden_feats: int, n_tasks: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = nn.LayerNorm(hidden_feats, eps=1e-6)
        self.Dense_0 = Dense(hidden_feats)
        self.Dense_1 = Dense(n_tasks)

    def forward(self, h: Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = dropout(h, self.dropout, _is_deterministic(self, deterministic),
                    generator)
        return self.Dense_1(self.LayerNorm_0(F.relu(self.Dense_0(h))))


class GCNLayer(nn.Module):
    """GraphConv (norm 'none', relu) + a relu Dense residual, dropout,
    LayerNorm (reference: gnn.py GCNLayer)."""

    def __init__(self, out_feats: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.GraphConv_0 = GraphConv(out_feats, norm="none",
                                     activation=F.relu)
        self.Dense_0 = Dense(out_feats)
        self.LayerNorm_0 = nn.LayerNorm(out_feats, eps=1e-6)

    def forward(self, g: Graph, feats: Tensor,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.GraphConv_0(g, feats) + F.relu(self.Dense_0(feats))
        h = dropout(h, self.dropout, _is_deterministic(self, deterministic),
                    generator)
        return self.LayerNorm_0(h)


class GATLayer(nn.Module):
    """GATConv (residual, feature and attention dropout ``dropout``) with
    the heads flattened or averaged (reference: gnn.py GATLayer)."""

    def __init__(self, out_feats: int, num_heads: int, dropout: float = 0.0,
                 agg_mode: str = "flatten",
                 activation: Optional[Callable] = None):
        super().__init__()
        self.agg_mode = agg_mode
        self.activation = activation
        self.GATConv_0 = GATConv(out_feats, num_heads, feat_drop=dropout,
                                 attn_drop=dropout, residual=True)

    def forward(self, g: Graph, feats: Tensor,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.GATConv_0(g, feats, deterministic=deterministic,
                           generator=generator)
        h = h.reshape(h.shape[0], -1) if self.agg_mode == "flatten" \
            else h.mean(1)
        return self.activation(h) if self.activation is not None else h


class _GNNClassifier(nn.Module):
    """WeightAndSum ++ max readout -> MLP (reference: classifiers.py
    BaseGNNClassifier.forward); subclasses add the layers ``gnn`` runs."""

    def __init__(self, n_tasks: int, classifier_hidden_feats: int = 128,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = []
        self.WeightAndSum_0 = WeightAndSum()
        self.MLPBinaryClassifier_0 = MLPBinaryClassifier(
            classifier_hidden_feats, n_tasks, dropout)

    def forward(self, g: Graph, feats: Tensor,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        for name in self.layers:
            feats = getattr(self, name)(g, feats, deterministic, generator)
        h_g = torch.cat([self.WeightAndSum_0(g, feats),
                         readout.max_nodes(g, feats)], dim=1)
        return self.MLPBinaryClassifier_0(h_g, deterministic, generator)


class GCNClassifier(_GNNClassifier):
    """Multi-task molecular classifier over stacked GCN layers (reference:
    classifiers.py GCNClassifier)."""

    def __init__(self, n_tasks: int, classifier_hidden_feats: int = 128,
                 dropout: float = 0.0,
                 gcn_hidden_feats: Sequence[int] = (64, 64)):
        super().__init__(n_tasks, classifier_hidden_feats, dropout)
        for i, out_feats in enumerate(gcn_hidden_feats):
            self.add_module(f"GCNLayer_{i}", GCNLayer(out_feats, dropout))
            self.layers.append(f"GCNLayer_{i}")


class GATClassifier(_GNNClassifier):
    """Multi-task molecular classifier over stacked GAT layers, the last
    averaging its heads (reference: classifiers.py GATClassifier)."""

    def __init__(self, n_tasks: int, classifier_hidden_feats: int = 128,
                 dropout: float = 0.0,
                 gat_hidden_feats: Sequence[int] = (32, 32),
                 num_heads: Sequence[int] = (4, 4)):
        super().__init__(n_tasks, classifier_hidden_feats, dropout)
        n = len(num_heads)
        for i in range(n):
            last = i == n - 1
            self.add_module(f"GATLayer_{i}", GATLayer(
                gat_hidden_feats[i], num_heads[i], dropout,
                agg_mode="mean" if last else "flatten",
                activation=None if last else F.elu))
            self.layers.append(f"GATLayer_{i}")


# ---------------------------------------------------------------------------
# AttentiveFP (reference: attentive_fp.py)
# ---------------------------------------------------------------------------
class AttentiveGRU1(nn.Module):
    """Edge-attention context + GRU node update (reference:
    AttentiveGRU1)."""

    def __init__(self, node_feat_size: int, edge_hidden_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(edge_hidden_size)
        self.GRUCell_0 = GRUCell(edge_hidden_size, node_feat_size)

    def forward(self, g: Graph, edge_logits: Tensor, edge_feats: Tensor,
                node_feats: Tensor, det: bool, generator=None) -> Tensor:
        e = self.Dense_0(dropout(edge_feats, self.dropout, det, generator))
        e = edge_softmax(g, edge_logits) * e
        context = F.elu(gspmm(g, "copy_rhs", "sum", None, e))
        return F.relu(self.GRUCell_0(context, node_feats))


class AttentiveGRU2(nn.Module):
    """Node-projection attention context + GRU node update (reference:
    AttentiveGRU2)."""

    def __init__(self, node_feat_size: int, edge_hidden_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(edge_hidden_size)
        self.GRUCell_0 = GRUCell(edge_hidden_size, node_feat_size)

    def forward(self, g: Graph, edge_logits: Tensor, node_feats: Tensor,
                det: bool, generator=None) -> Tensor:
        a = edge_softmax(g, edge_logits)
        hv = self.Dense_0(dropout(node_feats, self.dropout, det, generator))
        context = F.elu(gspmm(g, "mul", "sum", hv, a))
        return F.relu(self.GRUCell_0(context, node_feats))


class GetContext(nn.Module):
    """Initial context layer mixing the raw node and edge features
    (reference: GetContext)."""

    def __init__(self, graph_feat_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(graph_feat_size)
        self.Dense_1 = Dense(graph_feat_size)
        self.Dense_2 = Dense(1)
        self.AttentiveGRU1_0 = AttentiveGRU1(graph_feat_size,
                                             graph_feat_size, dropout)

    def forward(self, g: Graph, node_feats: Tensor, edge_feats: Tensor,
                det: bool, generator=None) -> Tensor:
        hv_new = _leaky(self.Dense_0(node_feats))
        he1 = torch.cat([gsddmm(g, "copy_lhs", node_feats, None, "u"),
                         edge_feats], dim=1)
        he1 = _leaky(self.Dense_1(he1))
        he2 = torch.cat([gsddmm(g, "copy_lhs", hv_new, None, "v"), he1],
                        dim=1)
        he2 = dropout(he2, self.dropout, det, generator)
        logits = _leaky(self.Dense_2(he2))
        return self.AttentiveGRU1_0(g, logits, he1, hv_new, det, generator)


class AttentiveGNNLayer(nn.Module):
    """One AttentiveFP message-passing layer (reference: GNNLayer)."""

    def __init__(self, graph_feat_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(1)
        self.AttentiveGRU2_0 = AttentiveGRU2(graph_feat_size,
                                             graph_feat_size, dropout)

    def forward(self, g: Graph, node_feats: Tensor, det: bool,
                generator=None) -> Tensor:
        he = torch.cat([gsddmm(g, "copy_lhs", node_feats, None, "v"),
                        gsddmm(g, "copy_lhs", node_feats, None, "u")], dim=1)
        he = dropout(he, self.dropout, det, generator)
        logits = _leaky(self.Dense_0(he))
        return self.AttentiveGRU2_0(g, logits, node_feats, det, generator)


class AttentiveFPReadout(nn.Module):
    """One super-node attention timestep over each molecule (reference:
    GlobalPool)."""

    def __init__(self, graph_feat_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(1)
        self.Dense_1 = Dense(graph_feat_size)
        self.GRUCell_0 = GRUCell(graph_feat_size, graph_feat_size)

    def forward(self, g: Graph, node_feats: Tensor, g_feats: Tensor,
                det: bool, generator=None):
        z = torch.cat([readout.broadcast_nodes(g, F.relu(g_feats)),
                       node_feats], dim=1)
        a = readout.softmax_nodes(g, _leaky(self.Dense_0(z)))
        hv = self.Dense_1(dropout(node_feats, self.dropout, det, generator))
        context = F.elu(readout.sum_nodes(g, hv, weight=a[:, 0]))
        return self.GRUCell_0(context, g_feats), a


class AttentiveFP(nn.Module):
    """AttentiveFP molecular fingerprint model (reference:
    attentive_fp.py).  Edge features in internal order."""

    def __init__(self, num_layers: int = 2, num_timesteps: int = 2,
                 graph_feat_size: int = 200, output_size: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers, self.num_timesteps = num_layers, num_timesteps
        self.dropout = dropout
        self.GetContext_0 = GetContext(graph_feat_size, dropout)
        for i in range(num_layers - 1):
            self.add_module(f"AttentiveGNNLayer_{i}",
                            AttentiveGNNLayer(graph_feat_size, dropout))
        for i in range(num_timesteps):
            self.add_module(f"AttentiveFPReadout_{i}",
                            AttentiveFPReadout(graph_feat_size, dropout))
        self.Dense_0 = Dense(output_size)

    def forward(self, g: Graph, node_feats: Tensor, edge_feats: Tensor,
                deterministic: Optional[bool] = None,
                get_node_weight: bool = False,
                generator: Optional[torch.Generator] = None):
        det = _is_deterministic(self, deterministic)
        node_feats = self.GetContext_0(g, node_feats, edge_feats, det,
                                       generator)
        for i in range(self.num_layers - 1):
            node_feats = getattr(self, f"AttentiveGNNLayer_{i}")(
                g, node_feats, det, generator)
        g_feats = readout.sum_nodes(g, node_feats)
        weights = []
        for i in range(self.num_timesteps):
            g_feats, a = getattr(self, f"AttentiveFPReadout_{i}")(
                g, node_feats, g_feats, det, generator)
            weights.append(a)
        out = self.Dense_0(dropout(g_feats, self.dropout, det, generator))
        return (out, weights) if get_node_weight else out


# ---------------------------------------------------------------------------
# ACNN (reference: acnn.py, atomicconv.py)
# ---------------------------------------------------------------------------
class ACNNPredictor(nn.Module):
    """Shared per-atom energy MLP (reference: ACNNPredictor)."""

    def __init__(self, hidden_sizes: Sequence[int] = (32, 16),
                 dropouts: Sequence[float] = (0.0, 0.0), num_tasks: int = 1):
        super().__init__()
        self.dropouts = tuple(dropouts)
        for i, size in enumerate(hidden_sizes):
            self.add_module(f"Dense_{i}", Dense(size))
        self.add_module(f"Dense_{len(hidden_sizes)}", Dense(num_tasks))

    def forward(self, feats: Tensor, det: bool, generator=None) -> Tensor:
        h = feats
        for i, p in enumerate(self.dropouts):
            h = dropout(F.relu(getattr(self, f"Dense_{i}")(h)), p, det,
                        generator)
        return getattr(self, f"Dense_{len(self.dropouts)}")(h)


class ACNN(nn.Module):
    """Atomic convolutional network for protein-ligand binding affinity
    (reference: acnn.py): AtomicConv towers for the ligand, the protein and
    the complex, and one energy head; the output is E(complex) -
    E(ligand) - E(protein) per pair in the batch.  The graphs carry ndata
    ``atomic_number`` and edata ``distance``; ``complex_ligand_mask``
    (V_complex,) marks the ligand atoms of the batched complex."""

    def __init__(self, hidden_sizes: Sequence[int] = (32, 16),
                 dropouts: Sequence[float] = (0.0, 0.0),
                 features_to_use: Optional[Sequence[float]] = None,
                 interaction_cutoffs: Sequence[float] = (12.0,),
                 rbf_kernel_means: Sequence[float] = (0.0, 2.0, 4.0, 6.0,
                                                      8.0),
                 rbf_kernel_scaling: Sequence[float] = (4.0,),
                 num_tasks: int = 1):
        super().__init__()
        self.ACNNPredictor_0 = ACNNPredictor(hidden_sizes, dropouts,
                                             num_tasks)
        for name in ("ligand_conv", "protein_conv", "complex_conv"):
            self.add_module(name, AtomicConv(
                interaction_cutoffs, rbf_kernel_means, rbf_kernel_scaling,
                features_to_use))

    def forward(self, ligand_g: Graph, protein_g: Graph, complex_g: Graph,
                complex_ligand_mask: Tensor,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        det = _is_deterministic(self, deterministic)

        def atom_energy(g, tower):
            feats = tower(g, g.ndata["atomic_number"],
                          g.edata_internal["distance"])
            return self.ACNNPredictor_0(feats, det, generator)

        lig = readout.sum_nodes(ligand_g,
                                atom_energy(ligand_g, self.ligand_conv))
        prot = readout.sum_nodes(protein_g,
                                 atom_energy(protein_g, self.protein_conv))
        mask = complex_ligand_mask.float()
        c_lig = readout.sum_nodes(
            complex_g, atom_energy(complex_g, self.complex_conv),
            weight=mask)
        # the same complex tower again for the protein part, as the JAX
        # model runs it
        c_prot = readout.sum_nodes(
            complex_g, atom_energy(complex_g, self.complex_conv),
            weight=1.0 - mask)
        return (c_lig + c_prot) - (lig + prot)


class WeavePredictor(nn.Module):
    """Weave property predictor: WeaveGNN node/edge updates, WeightAndSum
    ++ max readout, the MLP head (reference: dgllife
    weave_predictor.py).  Edge features in user order."""

    def __init__(self, n_tasks: int, num_layers: int = 2,
                 hidden_feats: int = 32, classifier_hidden_feats: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.WeaveGNN_0 = WeaveGNN(num_layers=num_layers,
                                   hidden_feats=hidden_feats)
        self.WeightAndSum_0 = WeightAndSum()
        self.MLPBinaryClassifier_0 = MLPBinaryClassifier(
            classifier_hidden_feats, n_tasks, dropout)

    def forward(self, g: Graph, node_feats: Tensor, edge_feats: Tensor,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.WeaveGNN_0(g, node_feats, edge_feats, node_only=True)
        h_g = torch.cat([self.WeightAndSum_0(g, h), readout.max_nodes(g, h)],
                        dim=1)
        return self.MLPBinaryClassifier_0(h_g, deterministic, generator)


class WLNPredictor(nn.Module):
    """WLN property predictor: the shared-parameter WLN encoder and the
    same readout head (reference: dgllife wln.py:75).  Edge features in
    user order."""

    def __init__(self, n_tasks: int, node_out_feats: int = 32,
                 n_layers: int = 2, classifier_hidden_feats: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.WLN_0 = WLN(node_out_feats=node_out_feats, n_layers=n_layers)
        self.WeightAndSum_0 = WeightAndSum()
        self.MLPBinaryClassifier_0 = MLPBinaryClassifier(
            classifier_hidden_feats, n_tasks, dropout)

    def forward(self, g: Graph, node_feats: Tensor, edge_feats: Tensor,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.WLN_0(g, node_feats, edge_feats)
        h_g = torch.cat([self.WeightAndSum_0(g, h), readout.max_nodes(g, h)],
                        dim=1)
        return self.MLPBinaryClassifier_0(h_g, deterministic, generator)
