"""The rest of the conv layer zoo, as ``dgl_hack_tpu.nn.conv_extra``
(reference: python/dgl/nn/pytorch/conv/__init__.py): GMMConv (MoNet),
the dense-adjacency DenseSAGEConv and DenseChebConv, the kNN graph
factories, AtomicConv, the Weave layers and the WLN encoder.

Parameters carry the JAX layers' names and layouts (flax ``Dense`` layers
are ``init.Dense`` modules of the same names, ``mu``/``inv_sigma`` and
AtomicConv's radial parameters are (K, dim) and (K,) tensors), so
``interop.flax_to_state_dict`` loads a JAX layer's parameters key for key.
Input widths are taken from the first call.

On the card:

* GMMConv's sum and mean, and the copy_e sums of AtomicConv, WeaveLayer
  and WLN, run K1's edge-row mode (``gspmm`` copy of an edge operand);
  WLN's final u_mul_e sum runs K1 with an (E, F) weight;
* WeaveLayer's u_add_v runs K6;
* the gathers of a src-side operand onto edges (AtomicConv's atom types,
  WLN's h_src) compose, as the JAX dispatch composes them;
* DenseSAGEConv and DenseChebConv are dense matmuls, as in the JAX layers,
  which run no Pallas kernel.

GMMConv, WeaveLayer and WLN take edge features in user order and put them
in internal order with ``int2user``; WeaveLayer's edge outputs come back in
user order.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import Graph
from ..core.transform import knn_graph, segmented_knn_graph
from ..ops import segment
from ..ops.sddmm import gsddmm
from ..ops.spmm import gspmm
from .conv import _split_feat
from .init import Dense

Tensor = torch.Tensor


def _internal(g: Graph, efeat: Tensor) -> Tensor:
    """User-order edge features in internal (CSC) order."""
    return efeat if g.int2user is None else efeat[g.int2user.long()]


class GMMConv(nn.Module):
    """Gaussian mixture model conv (MoNet; reference: gmmconv.py): edge
    pseudo-coordinates are scored under ``n_kernels`` learned gaussians
    (``mu``, normal(0.1); ``inv_sigma``, ones; both (K, dim)) and the
    messages ``fc(x_u)`` are weighted by the kernel responsibilities.
    sum and mean reduce through K1's edge-row mode, max through torch's
    scatter."""

    def __init__(self, out_feats: int, dim: int, n_kernels: int,
                 aggregator_type: str = "sum", residual: bool = False,
                 use_bias: bool = True):
        super().__init__()
        if aggregator_type not in ("sum", "mean", "max"):
            raise KeyError(f"Aggregator type {aggregator_type} not "
                           "recognized.")
        self.out_feats = out_feats
        self.n_kernels = n_kernels
        self.aggregator_type = aggregator_type
        self.mu = nn.Parameter(torch.randn(n_kernels, dim) * 0.1)
        self.inv_sigma = nn.Parameter(torch.ones(n_kernels, dim))
        self.fc = Dense(n_kernels * out_feats, bias=False,
                        kernel_init="xavier")
        self.res_fc = Dense(out_feats, bias=False, kernel_init="xavier") \
            if residual else None
        self.bias = nn.Parameter(torch.zeros(out_feats)) if use_bias \
            else None

    def forward(self, g: Graph, feat, pseudo: Tensor) -> Tensor:
        """pseudo: (E, dim) edge pseudo-coordinates (user order)."""
        feat_src, feat_dst = _split_feat(feat)
        pseudo = _internal(g, torch.as_tensor(pseudo, device=feat_src.device))
        proj = self.fc(feat_src).reshape(-1, self.n_kernels, self.out_feats)
        diff = pseudo[:, None, :] - self.mu[None]            # (E, K, dim)
        w = torch.exp(-0.5 * ((diff * self.inv_sigma[None]) ** 2).sum(-1))
        msg = (proj[g.src.long()] * w[..., None]).sum(1)     # (E, out)
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


class DenseSAGEConv(nn.Module):
    """SAGE on a dense adjacency (reference: densesageconv.py); ``adj``
    (..., N, N) may carry a batch dimension (DiffPool's (B, N, N))."""

    def __init__(self, out_feats: int, use_bias: bool = True):
        super().__init__()
        self.fc = Dense(out_feats, bias=use_bias, kernel_init="xavier")

    def forward(self, adj: Tensor, feat: Tensor) -> Tensor:
        in_deg = adj.sum(-1, keepdim=True).clamp(min=1.0)
        h_neigh = (adj @ feat + feat) / (in_deg + 1)
        return self.fc(h_neigh)


class DenseChebConv(nn.Module):
    """Chebyshev conv on a dense (N, N) adjacency (reference:
    densechebconv.py)."""

    def __init__(self, out_feats: int, k: int, use_bias: bool = True):
        super().__init__()
        self.k = k
        self.fc = Dense(out_feats, bias=use_bias, kernel_init="xavier")

    def forward(self, adj: Tensor, feat: Tensor,
                lambda_max: float = 2.0) -> Tensor:
        n = adj.shape[0]
        dnorm = torch.rsqrt(adj.sum(1).clamp(min=1.0))
        a_hat = adj * dnorm[:, None] * dnorm[None, :]
        eye = torch.eye(n, dtype=feat.dtype, device=feat.device)
        lt = (2.0 / lambda_max) * (eye - a_hat) - eye
        xs = [feat]
        if self.k > 1:
            xs.append(lt @ feat)
        for _ in range(2, self.k):
            xs.append(2 * (lt @ xs[-1]) - xs[-2])
        return self.fc(torch.cat(xs, dim=-1))


class KNNGraph(nn.Module):
    """Layer-style kNN graph factory (reference: factory.py KNNGraph),
    built on the host: a graph on the CPU."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, x) -> Graph:
        return knn_graph(x, self.k)


class SegmentedKNNGraph(nn.Module):
    """kNN within each segment of ``segs`` points (reference: factory.py
    SegmentedKNNGraph), built on the host as the JAX layer builds it:
    ``np.argsort`` of the squared distances (not a stable sort, so ties
    fall as numpy puts them), each point its own neighbour at distance
    0."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, x, segs) -> Graph:
        return segmented_knn_graph(x, self.k, segs)


class AtomicConv(nn.Module):
    """Atomic convolution (reference: atomicconv.py; ACNN's towers).

    e^k_ij = exp(-gamma_k (r_ij - r_k)^2) * cutoff_k(r_ij) with the
    cosine cutoff; each atom pools e^k over the neighbours of each atom
    type t: out[i, k*T + t] = sum_{j in N(i), z_j = t} e^k_ij.  The
    cutoffs, means and scalings are learned (K,) parameters initialised
    from the options, one entry per (cutoff, mean, scaling) triple."""

    def __init__(self, interaction_cutoffs: Sequence[float] = (12.0,),
                 rbf_kernel_means: Sequence[float] = (0.0, 2.0, 4.0, 6.0,
                                                      8.0),
                 rbf_kernel_scaling: Sequence[float] = (4.0,),
                 features_to_use: Optional[Sequence[float]] = None):
        super().__init__()
        radial = list(itertools.product(interaction_cutoffs,
                                        rbf_kernel_means,
                                        rbf_kernel_scaling))
        for col, name in enumerate(("interaction_cutoffs",
                                    "rbf_kernel_means",
                                    "rbf_kernel_scaling")):
            self.register_parameter(name, nn.Parameter(torch.tensor(
                [r[col] for r in radial], dtype=torch.float32)))
        self.features_to_use = None if features_to_use is None \
            else tuple(features_to_use)

    def forward(self, g: Graph, feat: Tensor, distances: Tensor) -> Tensor:
        """feat (V,) or (V, 1) atomic numbers; distances (E, 1) in
        internal order; returns (V, K*T) float32."""
        cut = self.interaction_cutoffs
        d = distances.reshape(-1, 1).float()                   # (E, 1)
        rbf = torch.exp(-self.rbf_kernel_scaling[None, :]
                        * (d - self.rbf_kernel_means[None, :]) ** 2)
        cos = 0.5 * (torch.cos(math.pi * d / cut[None, :]) + 1.0)
        e = rbf * torch.where(d <= cut[None, :], cos,
                              torch.zeros_like(cos))           # (E, K)
        if self.features_to_use is not None:
            types = torch.tensor(self.features_to_use, dtype=feat.dtype,
                                 device=feat.device)
            hv = (feat.reshape(-1, 1) == types[None, :]).float()  # (V, T)
        else:
            hv = torch.ones((g.num_src_nodes, 1), device=feat.device)
        hsrc = gsddmm(g, "copy_lhs", hv, None, "u")               # (E, T)
        m = (e[:, :, None] * hsrc[:, None, :]).reshape(e.shape[0], -1)
        return gspmm(g, "copy_rhs", "sum", None, m)               # (V, K*T)


class WeaveLayer(nn.Module):
    """One Weave layer ("Molecular Graph Convolutions", Kearnes et al.
    2016; reference: dgllife weave.py:11).

    Node update: [act(W_nn h_v) || sum_{e->v} act(W_en h_e)] -> W_u; edge
    update: [act(W_l h_u + W_r h_v) || act(W_r h_u + W_l h_v) ||
    act(W_ee h_e)] -> W_ue.  The edge Denses exist only when the first
    call updates the edges, as flax creates them."""

    _EDGE = ("left_node_to_edge", "right_node_to_edge", "edge_to_edge",
             "update_edge")

    def __init__(self, node_out_feats: int = 50, edge_out_feats: int = 50,
                 node_node_hidden_feats: int = 50,
                 edge_node_hidden_feats: int = 50,
                 node_edge_hidden_feats: int = 50,
                 edge_edge_hidden_feats: int = 50,
                 activation: Callable = F.relu):
        super().__init__()
        self.activation = activation
        self.node_to_node = Dense(node_node_hidden_feats,
                                  kernel_init="xavier")
        self.edge_to_node = Dense(edge_node_hidden_feats,
                                  kernel_init="xavier")
        self.update_node = Dense(node_out_feats, kernel_init="xavier")
        self.left_node_to_edge = Dense(node_edge_hidden_feats,
                                       kernel_init="xavier")
        self.right_node_to_edge = Dense(node_edge_hidden_feats,
                                        kernel_init="xavier")
        self.edge_to_edge = Dense(edge_edge_hidden_feats,
                                  kernel_init="xavier")
        self.update_edge = Dense(edge_out_feats, kernel_init="xavier")
        self._called = False

    def forward(self, g: Graph, node_feats: Tensor, edge_feats: Tensor,
                node_only: bool = False):
        if not self._called:
            self._called = True
            if node_only:
                for name in self._EDGE:
                    setattr(self, name, None)
        act = self.activation
        nn_feats = act(self.node_to_node(node_feats))
        e2n = act(self.edge_to_node(_internal(g, edge_feats)))
        en_feats = gspmm(g, "copy_rhs", "sum", None, e2n, "u", "e")
        new_node = act(self.update_node(torch.cat([nn_feats, en_feats],
                                                  dim=-1)))
        if node_only:
            return new_node
        left = self.left_node_to_edge(node_feats)
        right = self.right_node_to_edge(node_feats)
        first = act(gsddmm(g, "add", left, right, "u", "v",
                           out_order="eid"))
        second = act(gsddmm(g, "add", right, left, "u", "v",
                            out_order="eid"))
        third = act(self.edge_to_edge(edge_feats))
        new_edge = act(self.update_edge(torch.cat([first, second, third],
                                                  dim=-1)))
        return new_node, new_edge


class WeaveGNN(nn.Module):
    """Stacked Weave layers ``layer0`` ... (reference: weave.py
    WeaveGNN); the last updates the nodes alone when ``node_only``."""

    def __init__(self, num_layers: int = 2, hidden_feats: int = 50,
                 activation: Callable = F.relu):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", WeaveLayer(
                *(hidden_feats,) * 6, activation=activation))

    def forward(self, g: Graph, node_feats: Tensor, edge_feats: Tensor,
                node_only: bool = True):
        for i in range(self.num_layers - 1):
            node_feats, edge_feats = getattr(self, f"layer{i}")(
                g, node_feats, edge_feats)
        return getattr(self, f"layer{self.num_layers - 1}")(
            g, node_feats, edge_feats, node_only=node_only)


class _WLNDense(Dense):
    """A Dense whose kernel is normal with std min(1/sqrt(in), 0.1)
    (reference: wln.py WLNLinear.reset_parameters); bias zero."""

    def reset_parameters(self) -> None:
        if self.has_uninitialized_params() or self.in_features == 0:
            return
        std = min(1.0 / math.sqrt(self.in_features), 0.1)
        with torch.no_grad():
            self.weight.normal_(0.0, std)
            if self.bias is not None:
                self.bias.zero_()


class WLN(nn.Module):
    """Weisfeiler-Lehman Network encoder (Jin et al. 2017; reference:
    dgllife wln.py:75): ``n_layers`` of message passing with parameters
    SHARED across the layers, he = relu(W_m [h_src || e]), h_v' =
    relu(W_n [h_v || sum he]); then h_nbr(v) * W_s h_v with h_nbr =
    sum_{e->v} (W_nm h_src) * (W_em e)."""

    def __init__(self, node_out_feats: int = 300, n_layers: int = 3):
        super().__init__()
        H = node_out_feats
        self.n_layers = n_layers
        self.project_node_in_feats = _WLNDense(H, bias=False)
        self.project_concatenated_messages = _WLNDense(H)
        self.get_new_node_feats = _WLNDense(H)
        self.project_node_messages = _WLNDense(H, bias=False)
        self.project_edge_messages = _WLNDense(H, bias=False)
        self.project_self = _WLNDense(H, bias=False)

    def forward(self, g: Graph, node_feats: Tensor,
                edge_feats: Tensor) -> Tensor:
        ef_int = _internal(g, edge_feats)
        h = F.relu(self.project_node_in_feats(node_feats))
        for _ in range(self.n_layers):          # SHARED params across layers
            h_src = gsddmm(g, "copy_lhs", h, None, "u", "e")
            he = F.relu(self.project_concatenated_messages(
                torch.cat([h_src, ef_int], dim=-1)))
            agg = gspmm(g, "copy_rhs", "sum", None, he, "u", "e")
            h = F.relu(self.get_new_node_feats(torch.cat([h, agg], dim=-1)))
        hv = self.project_node_messages(h)
        he = self.project_edge_messages(ef_int)
        h_nbr = gspmm(g, "mul", "sum", hv, he, "u", "e")
        return h_nbr * self.project_self(h)
