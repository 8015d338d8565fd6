"""DGMG, the deep generative model of graphs (Li et al. 2018), as
``dgl_hack_tpu.models.dgmg`` (reference: python/dgl/model_zoo/chem/
dgmg.py: GraphEmbed:168, GraphProp:211, AddNode:308, AddEdge:413,
ChooseDestAndUpdate:490, DGMG:630).

The reference grows a graph node by node with one network call per
decision.  The JAX package re-derives the same probabilistic model on
static shapes, and the port keeps its form:

* a molecule is a padded action trace (``build_action_trace``): step
  kinds ADD_NODE / ADD_EDGE / CHOOSE_DEST / PAD with teacher labels;
* the graph state has fixed capacity: node states (V, H), the edge
  endpoints and one-hot bond features of 2 * max_edges directed slots,
  live masks and counts;
* every step evaluates the three decision heads, adds the labelled
  action's log-likelihood, and applies each transition masked: the
  state after the transition is computed on every step and kept where
  the step's kind asks for it; message passing (GraphProp: a Linear over
  [h_v, h_u, x_uv] per edge, summed per node, then a GRU) runs over the
  padded edge slots after each CHOOSE_DEST.

The port runs a batch of traces at once (state (B, V, H), the step kinds
a (B,) tensor; the JAX package vmaps one trace's scan), one step of the
batch after another.  Writes into the state are one-hot masks over the
slots, so a write at ``n_nodes == V`` or ``n_edges + 1 == 2E`` (a full
graph, on a step whose result is then discarded) is dropped, and every
gather index is clamped, as JAX drops and clamps them; the label reads
of the heads are clamped too.  Message sums go through
``ops.segment.segment_sum``.  ``generate`` samples with an explicit
``torch.Generator`` (Gumbel-max over the logits, the law of
``jax.random.categorical``), a batch of graphs at once; its draws are
not JAX's.

Parameters: the flax module's names, one torch module each
(``add_node_mlp_0``, ``msg_fns_1``, ``upd_fns_0`` ...), drawn as flax
draws them (lecun-normal kernels and embeddings, zero biases, flax's
GRU cells: ``nn.init``), so that ``interop.flax_to_state_dict`` of the
JAX model's params loads directly (flax's ``GRUCell`` has no ``hr``/
``hz`` biases: the port's cell masks them out).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.init import GRUCell, lecun_normal_
from ..ops.segment import segment_sum

Tensor = torch.Tensor

ADD_NODE, ADD_EDGE, CHOOSE_DEST, PAD = 0, 1, 2, 3


def build_action_trace(node_types: np.ndarray, src: np.ndarray,
                       dst: np.ndarray, bond_types: np.ndarray,
                       max_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a molecule into DGMG's canonical decision sequence
    (reference: DGMG.forward's teacher forcing, dgmg.py:791): for each
    node v, ADD_NODE(type); then for each bond (u < v) in increasing u,
    ADD_EDGE(bond), CHOOSE_DEST(u); then ADD_EDGE(stop); finally
    ADD_NODE(stop).

    src/dst/bond_types list each undirected bond once.  Returns
    (step_types (S,), labels (S,)) int32, padded with PAD."""
    n = len(node_types)
    by_new: Dict[int, List[Tuple[int, int]]] = {}
    for u, v, b in zip(src, dst, bond_types):
        u, v = (int(u), int(v)) if u < v else (int(v), int(u))
        by_new.setdefault(v, []).append((u, int(b)))
    steps, labels = [], []
    for v in range(n):
        steps.append(ADD_NODE)
        labels.append(int(node_types[v]))
        for u, b in sorted(by_new.get(v, [])):
            steps.append(ADD_EDGE)
            labels.append(b)
            steps.append(CHOOSE_DEST)
            labels.append(u)
        steps.append(ADD_EDGE)
        labels.append(-1)        # stop sentinel, mapped to n_bonds
    steps.append(ADD_NODE)
    labels.append(-1)            # stop sentinel, mapped to n_types
    if len(steps) > max_steps:
        raise ValueError(f"trace needs {len(steps)} steps > {max_steps}")
    st = np.full(max_steps, PAD, np.int32)
    lb = np.zeros(max_steps, np.int32)
    st[:len(steps)] = steps
    lb[:len(labels)] = labels
    return st, lb


class _State:
    """The batched graph state: hv (B, V, H), esrc/edst (B, 2E) long,
    he (B, 2E, nb), edge_mask (B, 2E), node_mask (B, V), n_nodes and
    n_edges (B,) long."""
    __slots__ = ("hv", "esrc", "edst", "he", "edge_mask", "node_mask",
                 "n_nodes", "n_edges")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _dense(n_in: int, n_out: int) -> nn.Linear:
    """flax's ``Dense(n_out)`` on ``n_in`` features: lecun-normal kernel,
    zero bias."""
    lin = nn.Linear(n_in, n_out)
    lecun_normal_(lin.weight, n_in)
    nn.init.zeros_(lin.bias)
    return lin


def _one_hot(idx: Tensor, n: int, dtype: torch.dtype) -> Tensor:
    """One-hot rows of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row (``jax.nn.one_hot``)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _slot(idx: Tensor, n: int, ok: Tensor) -> Tensor:
    """(B, n) bool: slot ``idx[b]`` of row b where ``ok[b]``; an index at
    n or beyond selects nothing (the write is dropped)."""
    return (torch.arange(n, device=idx.device)[None, :] == idx[:, None]) \
        & ok[:, None]


class DGMG(nn.Module):
    """The reference's chem DGMG (dgmg.py:630) on static shapes.

    ``forward(step_types (B, S), labels (B, S)) -> (B,)`` negative
    log-likelihoods of B action traces; ``generate(generator,
    num_samples)`` samples graphs."""

    def __init__(self, n_node_types: int, n_bond_types: int,
                 node_hidden_size: int = 128, num_prop_rounds: int = 2,
                 max_nodes: int = 32, max_edges: int = 64):
        super().__init__()
        self.n_node_types = n_node_types
        self.n_bond_types = n_bond_types
        self.node_hidden_size = H = node_hidden_size
        self.num_prop_rounds = num_prop_rounds
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        G = 2 * H                             # graph embedding size (paper)
        nt, nb = n_node_types, n_bond_types
        self.node_gating = _dense(H, 1)
        self.node_to_graph = _dense(H, G)
        self.add_node_mlp_0 = _dense(G, G)
        self.add_node_mlp_1 = _dense(G, nt + 1)
        self.node_type_embed = nn.Embedding(nt, H)
        lecun_normal_(self.node_type_embed.weight, H)
        self.initialize_hv = _dense(H + G, H)
        self.add_edge_mlp_0 = _dense(G + H, G + H)
        self.add_edge_mlp_1 = _dense(G + H, nb + 1)
        self.choose_dest_mlp_0 = _dense(2 * H + nb, 2 * H + nb)
        self.choose_dest_mlp_1 = _dense(2 * H + nb, 1)
        for t in range(num_prop_rounds):
            setattr(self, f"msg_fns_{t}", _dense(2 * H + nb, 2 * H))
            setattr(self, f"upd_fns_{t}", GRUCell(2 * H, H))

    # -- pieces -----------------------------------------------------------
    def _graph_embed(self, hv: Tensor, node_mask: Tensor) -> Tensor:
        """Gated sum over live nodes (reference: GraphEmbed.forward)."""
        gate = torch.sigmoid(self.node_gating(hv))
        return (gate * self.node_to_graph(hv) * node_mask[..., None]).sum(1)

    def _prop(self, hv, esrc, edst, he, edge_mask):
        """num_prop_rounds of [h_v, h_u, x_uv] -> Linear -> sum per v ->
        GRU (reference: GraphProp.forward), over every edge slot of every
        graph of the batch, padded slots masked out."""
        B, V, H = hv.shape
        E2 = esrc.shape[1]
        seg = (edst + V * torch.arange(B, device=hv.device)[:, None])
        seg = seg.reshape(-1)
        for t in range(self.num_prop_rounds):
            h_u = hv.gather(1, esrc[..., None].expand(B, E2, H))
            h_v = hv.gather(1, edst[..., None].expand(B, E2, H))
            m = torch.cat([h_v, h_u, he], dim=2)
            act = getattr(self, f"msg_fns_{t}")(m) * edge_mask[..., None]
            a = segment_sum(act.reshape(B * E2, -1), seg, B * V)
            hv = getattr(self, f"upd_fns_{t}")(a, hv.reshape(B * V, H)) \
                .reshape(B, V, H)
        return hv

    def _heads(self, s: _State, bond_label: Tensor):
        """Logits of the three decision heads on the current states."""
        V = self.max_nodes
        g_embed = self._graph_embed(s.hv, s.node_mask)
        h = self.add_node_mlp_1(F.relu(self.add_node_mlp_0(g_embed)))
        src_idx = (s.n_nodes - 1).clamp(0, V - 1)
        h_src = s.hv.gather(1, src_idx[:, None, None].expand(
            -1, 1, s.hv.shape[2]))[:, 0]
        e = self.add_edge_mlp_1(F.relu(self.add_edge_mlp_0(
            torch.cat([g_embed, h_src], dim=1))))
        bond_1h = _one_hot(bond_label, self.n_bond_types, s.hv.dtype)
        B = s.hv.shape[0]
        feats = torch.cat([s.hv, h_src[:, None].expand(B, V, -1),
                           bond_1h[:, None].expand(B, V, -1)], dim=2)
        d = self.choose_dest_mlp_1(F.relu(self.choose_dest_mlp_0(
            feats)))[..., 0]
        dest_ok = torch.arange(V, device=d.device)[None, :] < src_idx[:, None]
        d = torch.where(dest_ok, d, torch.full_like(d, -1e9))
        return h, e, d, src_idx, bond_1h, g_embed

    def _add_node(self, s: _State, label: Tensor, g_embed: Tensor,
                  do: Tensor) -> None:
        """ADD_NODE(label) where ``do``: node ``n_nodes`` gets its initial
        state; at a full graph the write is dropped."""
        emb = self.node_type_embed(label.clamp(0, self.n_node_types - 1))
        hv_init = self.initialize_hv(torch.cat([emb, g_embed], dim=1))
        w = _slot(s.n_nodes, self.max_nodes, do)
        s.hv = torch.where(w[..., None], hv_init[:, None, :], s.hv)
        s.node_mask = torch.where(w, torch.ones_like(s.node_mask),
                                  s.node_mask)
        s.n_nodes = s.n_nodes + do.long()

    def _choose_dest(self, s: _State, dest: Tensor, bond_1h: Tensor,
                     do: Tensor) -> None:
        """CHOOSE_DEST(dest) where ``do``: the edge (src, dest) in both
        directions (reference: ChooseDestAndUpdate), then message
        passing; the slots past 2E are dropped."""
        E2 = 2 * self.max_edges
        src = (s.n_nodes - 1).clamp(min=0)
        w0 = _slot(s.n_edges, E2, do)
        w1 = _slot(s.n_edges + 1, E2, do)
        esrc = torch.where(w0, src[:, None],
                           torch.where(w1, dest[:, None], s.esrc))
        edst = torch.where(w0, dest[:, None],
                           torch.where(w1, src[:, None], s.edst))
        w = (w0 | w1)
        he = torch.where(w[..., None], bond_1h[:, None, :], s.he)
        edge_mask = torch.where(w, torch.ones_like(s.edge_mask),
                                s.edge_mask)
        hv = self._prop(s.hv, esrc, edst, he, edge_mask)
        s.hv = torch.where(do[:, None, None], hv, s.hv)
        s.esrc, s.edst, s.he, s.edge_mask = esrc, edst, he, edge_mask
        s.n_edges = s.n_edges + 2 * do.long()

    def _init_state(self, B: int, device) -> _State:
        V, E2, H = self.max_nodes, 2 * self.max_edges, self.node_hidden_size
        zl = torch.zeros(B, dtype=torch.long, device=device)
        f = dict(dtype=self.node_gating.weight.dtype, device=device)
        return _State(hv=torch.zeros(B, V, H, **f),
                      esrc=torch.zeros(B, E2, dtype=torch.long,
                                       device=device),
                      edst=torch.zeros(B, E2, dtype=torch.long,
                                       device=device),
                      he=torch.zeros(B, E2, self.n_bond_types, **f),
                      edge_mask=torch.zeros(B, E2, **f),
                      node_mask=torch.zeros(B, V, **f),
                      n_nodes=zl, n_edges=zl.clone())

    # -- teacher-forced NLL ------------------------------------------------
    def forward(self, step_types: Tensor, labels: Tensor) -> Tensor:
        """Negative log-likelihoods (B,) of B action traces (B, S), each
        the sum over its steps.  PAD steps change nothing."""
        st_all, lb_all = step_types.long(), labels.long()
        if st_all.dim() == 1:
            return self.forward(st_all[None], lb_all[None])[0]
        B, S = st_all.shape
        V, nt, nb = self.max_nodes, self.n_node_types, self.n_bond_types
        s = self._init_state(B, st_all.device)
        nll = s.hv.new_zeros(B)
        pending = torch.zeros(B, dtype=torch.long, device=st_all.device)
        rows = torch.arange(B, device=st_all.device)
        for k in range(S):
            st, lb = st_all[:, k], lb_all[:, k]
            h, e, d, src_idx, bond_1h, g_embed = self._heads(s, pending)
            # labelled log-probs; the stop sentinel -1 is the last class,
            # and a label of another step's kind is clamped, as JAX reads
            an = torch.where(lb < 0, nt, lb).clamp(0, nt)
            ae = torch.where(lb < 0, nb, lb).clamp(0, nb)
            logp_an = torch.log_softmax(h, -1)[rows, an]
            logp_ae = torch.log_softmax(e, -1)[rows, ae]
            # choose-dest over the dests < src; one candidate: logp = 0
            # (the reference skips it when nelement <= 1)
            logp_cd = torch.log_softmax(d, -1)[rows, lb.clamp(0, V - 1)]
            logp_cd = torch.where(src_idx > 1, logp_cd,
                                  torch.zeros_like(logp_cd))
            zero = torch.zeros_like(logp_an)
            nll = nll - torch.where(
                st == ADD_NODE, logp_an,
                torch.where(st == ADD_EDGE, logp_ae,
                            torch.where(st == CHOOSE_DEST, logp_cd, zero)))
            # masked state transitions
            self._add_node(s, lb, g_embed, (st == ADD_NODE) & (lb >= 0))
            self._choose_dest(s, lb.clamp(0, V - 1), bond_1h,
                              st == CHOOSE_DEST)
            # the bond type of an ADD_EDGE decision, for the following
            # CHOOSE_DEST step's features and edge
            pending = torch.where((st == ADD_EDGE) & (lb >= 0), lb, pending)
        return nll

    # -- ancestral sampling ------------------------------------------------
    @torch.no_grad()
    def generate(self, generator: torch.Generator, num_samples: int = 1,
                 max_steps: Optional[int] = None) -> Dict[str, Tensor]:
        """Sample ``num_samples`` graphs at once; the decision-kind
        register replaces the reference's Python loops (DGMG.rollout).
        ``generator`` lives on the module's device.  Returns node_types
        (B, V), src/dst/bond_types/edge_mask (B, 2E), num_nodes and
        num_edges (B,)."""
        dev = self.node_gating.weight.device
        S = max_steps or (2 * self.max_nodes + 2 * self.max_edges + 2)
        B, V, E2 = num_samples, self.max_nodes, 2 * self.max_edges
        nt, nb = self.n_node_types, self.n_bond_types
        s = self._init_state(B, dev)
        mode = torch.full((B,), ADD_NODE, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        types = torch.zeros(B, V, dtype=torch.long, device=dev)
        bonds = torch.zeros(B, E2, dtype=torch.long, device=dev)
        pending = torch.zeros(B, dtype=torch.long, device=dev)

        def categorical(logits):
            u = torch.rand(logits.shape, generator=generator, device=dev)
            u = u.clamp(torch.finfo(u.dtype).tiny, 1.0)
            return (logits - torch.log(-torch.log(u))).argmax(-1)

        for _ in range(S):
            h, e, d, src_idx, _, g_embed = self._heads(s, pending)
            an, ae, cd = categorical(h), categorical(e), categorical(d)
            full = s.n_nodes >= V
            add_ok = (mode == ADD_NODE) & (an < nt) & ~done & ~full
            types = torch.where(_slot(s.n_nodes, V, add_ok), an[:, None],
                                types)
            self._add_node(s, an, g_embed, add_ok)
            done = done | ((mode == ADD_NODE) & ((an >= nt) | full))
            # ADD_EDGE: stop -> back to ADD_NODE, else keep the bond type
            # and move to CHOOSE_DEST
            efull = s.n_edges + 2 > E2
            e_go = (mode == ADD_EDGE) & (ae < nb) & (src_idx >= 1) & ~efull
            pending = torch.where(e_go, ae, pending)
            do_dest = mode == CHOOSE_DEST
            w = _slot(s.n_edges, E2, do_dest) \
                | _slot(s.n_edges + 1, E2, do_dest)
            bonds = torch.where(w, pending[:, None], bonds)
            self._choose_dest(s, cd, _one_hot(pending, nb, s.hv.dtype),
                              do_dest)
            mode = torch.where(
                done, PAD,
                torch.where(mode == ADD_NODE,
                            torch.where(add_ok, ADD_EDGE, PAD),
                            torch.where(mode == ADD_EDGE,
                                        torch.where(e_go, CHOOSE_DEST,
                                                    ADD_NODE),
                                        ADD_EDGE)))
        return {"node_types": types, "src": s.esrc, "dst": s.edst,
                "bond_types": bonds, "num_nodes": s.n_nodes,
                "num_edges": s.n_edges, "edge_mask": s.edge_mask}
