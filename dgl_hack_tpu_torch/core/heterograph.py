"""Heterogeneous graphs: typed nodes and edges over relation-wise Graphs,
as ``dgl_hack_tpu.core.heterograph``.

A HeteroGraph is a metagraph (the canonical (srctype, etype, dsttype)
triples) with one ``Graph`` per relation (a bipartite block where the two
types differ) and one feature frame per node type.  ``multi_update_all``
reduces per relation, then combines the relations that share a dst type
with a cross-type reducer.

On the card a builtin (message, reduce) pair is one ``gspmm`` per
relation (K1 for sum/mean, K4/K5 for max/min), and a UDF message with a
builtin sum or mean reducer sums its messages over the relation's CSC
rows (K1's edge-row mode); a reduce UDF runs over each relation's padded
mailbox in torch; the cross-type reducers are torch.  The JAX class is a pytree; this one moves with ``to(device)``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..function import BuiltinReduce
from .graph import Graph, _build, _FrameView

Tensor = torch.Tensor
CanonicalEtype = Tuple[str, str, str]


def _host(t) -> np.ndarray:
    """A tensor or array-like as a host numpy array."""
    if isinstance(t, Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class HeteroGraph:
    """metagraph + {canonical_etype: relation Graph} + per-ntype frames."""

    def __init__(self, relations: Dict[CanonicalEtype, Graph],
                 num_nodes: Dict[str, int],
                 node_frames: Optional[Dict[str, Dict[str, Tensor]]] = None,
                 batch_info: Optional[Tuple] = None):
        self.relations = dict(relations)
        self._num_nodes = dict(num_nodes)
        if node_frames is None:
            node_frames = {nt: {} for nt in num_nodes}
        self._node_frames = node_frames
        # (per-ntype node counts, per-cetype edge counts) of a batched
        # heterograph
        self._batch_info = batch_info

    # -- schema -------------------------------------------------------------
    @property
    def ntypes(self) -> Tuple[str, ...]:
        return tuple(sorted(self._num_nodes))

    @property
    def canonical_etypes(self) -> Tuple[CanonicalEtype, ...]:
        return tuple(self.relations.keys())

    @property
    def etypes(self) -> Tuple[str, ...]:
        return tuple(et for _, et, _ in self.canonical_etypes)

    def num_nodes(self, ntype: Optional[str] = None) -> int:
        if ntype is None:
            if len(self._num_nodes) != 1:
                return sum(self._num_nodes.values())
            ntype = next(iter(self._num_nodes))
        return self._num_nodes[ntype]

    def num_edges(self, etype: Optional[Union[str, CanonicalEtype]] = None
                  ) -> int:
        if etype is None:
            return sum(g.num_edges() for g in self.relations.values())
        return self._rel(etype).num_edges()

    number_of_nodes = num_nodes
    number_of_edges = num_edges

    def to_canonical_etype(self, etype: Union[str, CanonicalEtype]
                           ) -> CanonicalEtype:
        if isinstance(etype, tuple):
            return etype
        cands = [c for c in self.canonical_etypes if c[1] == etype]
        if len(cands) != 1:
            raise KeyError(f"etype {etype!r} is absent or ambiguous "
                           f"({len(cands)} matches)")
        return cands[0]

    def _rel(self, etype) -> Graph:
        return self.relations[self.to_canonical_etype(etype)]

    @property
    def device(self) -> torch.device:
        return next(iter(self.relations.values())).device

    def to(self, device) -> "HeteroGraph":
        """Copy with every relation and node feature on ``device``."""
        return HeteroGraph(
            {c: g.to(device) for c, g in self.relations.items()},
            self._num_nodes,
            {nt: {k: v.to(device) for k, v in f.items()}
             for nt, f in self._node_frames.items()}, self._batch_info)

    # -- batching -------------------------------------------------------------
    @property
    def batch_size(self) -> int:
        if self._batch_info is None:
            return 1
        return len(next(iter(self._batch_info[0].values())))

    def batch_num_nodes(self, ntype: Optional[str] = None):
        """Per-component node counts of a batched heterograph."""
        if self._batch_info is None:
            nts = self.ntypes
            if ntype is None and len(nts) != 1:
                raise ValueError("pass ntype for multi-ntype graphs")
            return (self.num_nodes(ntype or nts[0]),)
        bnn = self._batch_info[0]
        if ntype is None:
            if len(bnn) != 1:
                raise ValueError("pass ntype for multi-ntype graphs")
            ntype = next(iter(bnn))
        return bnn[ntype]

    def batch_num_edges(self, etype=None):
        """Per-component edge counts of a batched heterograph."""
        if self._batch_info is None:
            return (self.num_edges(etype),)
        bne = self._batch_info[1]
        if etype is None:
            if len(bne) != 1:
                raise ValueError("pass etype for multi-etype graphs")
            return next(iter(bne.values()))
        return bne[self.to_canonical_etype(etype)]

    def __getitem__(self, etype) -> Graph:
        """The relation's Graph with its src and dst frames bound to the
        node-type frames (writes show on the heterograph).  It shares the
        relation's cache of derived tensors (K1's row plans), so these are
        built once per relation."""
        st, et, dt = self.to_canonical_etype(etype)
        rel = self.relations[(st, et, dt)]
        g = rel.replace(node_frames=(self._node_frames[st],
                                     self._node_frames[dt]))
        g.derived = rel.derived
        return g

    # -- frames -------------------------------------------------------------
    def nodes_data(self, ntype: str) -> _FrameView:
        return _FrameView(self._node_frames[ntype])

    @property
    def ndata(self) -> _FrameView:
        if len(self._num_nodes) != 1:
            raise ValueError("ndata requires a single node type; use "
                             "nodes_data(ntype)")
        return _FrameView(next(iter(self._node_frames.values())))

    def edges_data(self, etype) -> _FrameView:
        return self._rel(etype).edata

    # -- message passing ----------------------------------------------------
    def update_all(self, message_func, reduce_func, etype=None) -> None:
        """update_all over one relation (the only one when ``etype`` is
        None)."""
        if etype is None:
            if len(self.relations) != 1:
                raise ValueError("multiple etypes; pass etype= or use "
                                 "multi_update_all")
            etype = self.canonical_etypes[0]
        from .message import update_all as _ua
        _ua(self[etype], message_func, reduce_func)

    def multi_update_all(self, etype_dict: Dict[Any, Tuple],
                         cross_reducer: str, apply_node_func=None,
                         max_degree: Optional[int] = None) -> None:
        """Per-relation message and reduce, then a cross-type combination
        (sum, mean, max, min or stack) per dst node type, written into its
        frame.  A builtin pair is one ``gspmm``; a UDF message with a
        builtin reducer reduces its messages as edge data (``gspmm``
        copy_e); a reduce UDF runs per relation over the padded mailbox
        (``core/message.py:build_mailbox``, sized by ``max_degree``, the
        largest in-degree over the relations, when given), and each field
        it returns joins the cross-type reduction."""
        from .message import (NodeBatch, _reduce_udf, compute_messages,
                              reduce_messages)

        partials: Dict[str, Dict[str, list]] = {}
        for etype, spec in etype_dict.items():
            mf, rf = spec[0], spec[1]
            st, et, dt = self.to_canonical_etype(etype)
            rel = self[(st, et, dt)]
            if isinstance(rf, BuiltinReduce):
                outs = {rf.out_field: reduce_messages(rel, mf, rf)}
            else:
                outs = _reduce_udf(rel, compute_messages(rel, mf), rf,
                                   max_degree, self._node_frames[dt])
            for field, out in outs.items():
                partials.setdefault(dt, {}).setdefault(field, []).append(out)

        for dt, fields in partials.items():
            for field, outs in fields.items():
                self._node_frames[dt][field] = cross_reduce(cross_reducer,
                                                            outs)
        if apply_node_func is not None:
            for dt in partials:
                res = apply_node_func(NodeBatch(dict(self._node_frames[dt])))
                if not isinstance(res, dict):
                    raise TypeError("node UDF must return a dict")
                self._node_frames[dt].update(res)

    def apply_edges(self, func, etype=None) -> None:
        from .message import apply_edges as _ae
        if etype is None:
            if len(self.relations) != 1:
                raise ValueError("multiple etypes; pass etype=")
            etype = self.canonical_etypes[0]
        _ae(self[etype], func)

    def apply_nodes(self, func, ntype=None) -> None:
        """A node UDF over one node type's frame."""
        from .message import NodeBatch
        if ntype is None:
            if len(self._num_nodes) != 1:
                raise ValueError("pass ntype for multi-ntype graphs")
            ntype = self.ntypes[0]
        res = func(NodeBatch(dict(self._node_frames[ntype])))
        if not isinstance(res, dict):
            raise TypeError("node UDF must return a dict")
        self._node_frames[ntype].update(res)

    # -- subgraphs and scopes -------------------------------------------------
    def node_type_subgraph(self, ntypes) -> "HeteroGraph":
        """The given node types and the relations among them."""
        keep = set(ntypes)
        rels = {c: g for c, g in self.relations.items()
                if c[0] in keep and c[2] in keep}
        return self._with(rels, keep)

    def edge_type_subgraph(self, etypes) -> "HeteroGraph":
        """The given relations and their endpoint node types."""
        cets = [self.to_canonical_etype(et) for et in etypes]
        rels = {c: self.relations[c] for c in cets}
        return self._with(rels, {c[0] for c in cets} | {c[2] for c in cets})

    def _with(self, rels, ntypes) -> "HeteroGraph":
        return HeteroGraph(rels, {nt: self._num_nodes[nt] for nt in ntypes},
                           {nt: dict(self._node_frames[nt])
                            for nt in ntypes})

    def local_var(self) -> "HeteroGraph":
        """The same graph with copies of the frame dicts: writes to it do
        not show on this one."""
        return HeteroGraph(self.relations, self._num_nodes,
                           {nt: dict(f)
                            for nt, f in self._node_frames.items()},
                           self._batch_info)

    @contextlib.contextmanager
    def local_scope(self):
        """Frame writes inside the block are undone at its end."""
        saved = {nt: dict(f) for nt, f in self._node_frames.items()}
        try:
            yield self
        finally:
            for nt, f in self._node_frames.items():
                f.clear()
                f.update(saved[nt])

    def __repr__(self):
        return (f"HeteroGraph(num_nodes={self._num_nodes}, etypes="
                f"{list(self.canonical_etypes)})")


def cross_reduce(reducer: str, outs: Sequence[Tensor]) -> Tensor:
    """Combine per-relation results of one dst type: sum, mean, max, min
    (elementwise) or stack (along a new axis 1)."""
    if reducer == "sum":
        return sum(outs[1:], outs[0])
    if reducer == "mean":
        return sum(outs[1:], outs[0]) / len(outs)
    if reducer == "max":
        return torch.stack(list(outs)).amax(0)
    if reducer == "min":
        return torch.stack(list(outs)).amin(0)
    if reducer == "stack":
        return torch.stack(list(outs), dim=1)
    raise ValueError(f"unknown cross reducer {reducer!r}")


def heterograph(data_dict: Dict[CanonicalEtype, Tuple[Any, Any]],
                num_nodes_dict: Optional[Dict[str, int]] = None,
                build_csr: bool = True) -> HeteroGraph:
    """Build a heterograph from {(srctype, etype, dsttype): (src, dst)}; a
    type's node count is ``num_nodes_dict``'s or one more than its
    largest id."""
    nn: Dict[str, int] = dict(num_nodes_dict or {})
    edges = {c: (np.asarray(_host(s), dtype=np.int32),
                 np.asarray(_host(d), dtype=np.int32))
             for c, (s, d) in data_dict.items()}
    for (st, _, dt), (src, dst) in edges.items():
        nn.setdefault(st, 0)
        nn.setdefault(dt, 0)
        if num_nodes_dict is None:
            nn[st] = max(nn[st], int(src.max(initial=-1)) + 1)
            nn[dt] = max(nn[dt], int(dst.max(initial=-1)) + 1)
    rels = {(st, et, dt): _build(src, dst, nn[st], nn[dt],
                                 is_block=(st != dt), build_csr=build_csr)
            for (st, et, dt), (src, dst) in edges.items()}
    return HeteroGraph(rels, nn)


def bipartite(edges, utype="_U", etype="_E", vtype="_V",
              num_nodes=None) -> HeteroGraph:
    """A heterograph of one relation from utype to vtype."""
    nn = None
    if num_nodes is not None:
        nn = {utype: num_nodes[0], vtype: num_nodes[1]}
    return heterograph({(utype, etype, vtype): edges}, nn)


def to_heterogeneous(g: Graph, ntypes: Sequence[str],
                     etypes: Sequence[str],
                     node_type: Any = None, edge_type: Any = None,
                     metagraph: Optional[Sequence[CanonicalEtype]] = None
                     ) -> HeteroGraph:
    """Split a homogeneous graph into a heterograph, the inverse of
    :func:`to_homogeneous`.

    ``node_type``/``edge_type`` are per-node / per-edge (user order) type
    ids into ``ntypes``/``etypes``; they default to ``g.ndata['_TYPE']`` /
    ``g.edata['_TYPE']``.  Each edge type must connect one (srctype,
    dsttype) pair unless ``metagraph`` pins the canonical triples.  The
    original node and edge ids are stored as ``'_ID'`` in the node frames
    and each relation's ``edata``; the other node features of ``g.ndata``
    are split by type."""
    nt = _host(node_type if node_type is not None
               else g.ndata["_TYPE"]).astype(np.int64)
    et = _host(edge_type if edge_type is not None
               else g.edata["_TYPE"]).astype(np.int64)
    if nt.shape[0] != g.num_nodes():
        raise ValueError("node_type length != num_nodes")
    if et.shape[0] != g.num_edges():
        raise ValueError("edge_type length != num_edges")
    src, dst = g.host_edges()  # user edge order
    # local ids: nodes of each type keep their relative order
    local = np.zeros(nt.shape[0], np.int64)
    num_nodes: Dict[str, int] = {}
    orig_ids: Dict[str, np.ndarray] = {}
    for i, name in enumerate(ntypes):
        m = nt == i
        local[m] = np.arange(int(m.sum()))
        num_nodes[name] = int(m.sum())
        orig_ids[name] = np.nonzero(m)[0].astype(np.int32)
    pinned = {c[1]: c for c in (metagraph or ())}
    rels: Dict[CanonicalEtype, Graph] = {}
    rel_eids: Dict[CanonicalEtype, np.ndarray] = {}
    for j, ename in enumerate(etypes):
        m = et == j
        if not m.any() and ename not in pinned:
            continue
        s, d = src[m], dst[m]
        st_ids = np.unique(nt[s]) if s.size else np.zeros(0, np.int64)
        dt_ids = np.unique(nt[d]) if d.size else np.zeros(0, np.int64)
        if ename in pinned:
            cet = pinned[ename]
        else:
            if st_ids.size > 1 or dt_ids.size > 1:
                raise ValueError(
                    f"edge type {ename!r} spans multiple src/dst node "
                    f"types; pass metagraph= to disambiguate")
            cet = (ntypes[int(st_ids[0])], ename, ntypes[int(dt_ids[0])])
        rels[cet] = _build(local[s].astype(np.int32),
                           local[d].astype(np.int32),
                           num_nodes[cet[0]], num_nodes[cet[2]],
                           is_block=(cet[0] != cet[2])).to(g.device)
        rel_eids[cet] = np.nonzero(m)[0].astype(np.int32)
    node_frames: Dict[str, Dict[str, Tensor]] = {n: {} for n in num_nodes}
    for name in num_nodes:
        ids = torch.from_numpy(orig_ids[name]).to(g.device)
        node_frames[name]["_ID"] = ids
        for key in g.ndata:
            if key != "_TYPE":
                node_frames[name][key] = g.ndata[key][ids.long()]
    hg = HeteroGraph(rels, num_nodes, node_frames)
    for cet, ids in rel_eids.items():
        hg.edges_data(cet)["_ID"] = torch.from_numpy(ids).to(g.device)
    return hg


def to_homogeneous(hg: HeteroGraph) -> Tuple[Graph, Dict[str, Any]]:
    """Flatten a heterograph to a homogeneous graph, node types in
    ``ntypes`` order and edges relation by relation (each in user order).

    Returns (graph, info): info holds 'ntype_offsets', 'node_types' (per
    node), 'edge_types' (per edge, user order), 'ntypes' and 'etypes'."""
    ntypes = hg.ntypes
    offs = {nt: 0 for nt in ntypes}
    total = 0
    for nt in ntypes:
        offs[nt] = total
        total += hg.num_nodes(nt)
    node_types = np.concatenate([
        np.full(hg.num_nodes(nt), i, np.int32) for i, nt in enumerate(ntypes)])
    srcs, dsts, etys = [], [], []
    for i, c in enumerate(hg.canonical_etypes):
        st, _, dt = c
        rel = hg.relations[c]
        s, d = rel.host_edges()
        srcs.append(s.astype(np.int64) + offs[st])
        dsts.append(d.astype(np.int64) + offs[dt])
        etys.append(np.full(rel.num_edges(), i, np.int32))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    g = _build(src.astype(np.int32), dst.astype(np.int32), total, total,
               is_block=False)
    info = {"ntype_offsets": offs,
            "node_types": node_types,
            "edge_types": (np.concatenate(etys) if etys
                           else np.zeros(0, np.int32)),
            "ntypes": ntypes, "etypes": hg.canonical_etypes}
    return g, info


def hetero_from_relations(rel_graphs: Sequence[HeteroGraph]) -> HeteroGraph:
    """Union single-relation heterographs into one."""
    rels: Dict[CanonicalEtype, Graph] = {}
    num_nodes: Dict[str, int] = {}
    frames: Dict[str, Dict[str, Tensor]] = {}
    for rg in rel_graphs:
        for cet in rg.canonical_etypes:
            rels[cet] = rg.relations[cet]
        for nt in rg.ntypes:
            num_nodes[nt] = max(num_nodes.get(nt, 0), rg.num_nodes(nt))
            for key in rg.nodes_data(nt):
                frames.setdefault(nt, {})[key] = rg.nodes_data(nt)[key]
    hg = HeteroGraph(rels, num_nodes)
    for nt, fr in frames.items():
        for key, val in fr.items():
            hg.nodes_data(nt)[key] = val
    return hg


def metapath_reachable_graph(hg: HeteroGraph,
                             metapath: Sequence[Any]) -> Graph:
    """Reachability graph over a metapath: an edge (u, v) iff v is
    reachable from u through the chain of relations.  Host-side boolean
    sparse products (scipy)."""
    import scipy.sparse as sp
    mats = []
    for et in metapath:
        rel = hg.relations[hg.to_canonical_etype(et)]
        s, d = rel.host_edges()
        mats.append(sp.coo_matrix(
            (np.ones(len(s), bool), (s, d)),
            shape=(rel.num_src_nodes, rel.num_dst_nodes)).tocsr())
    acc = mats[0]
    for m in mats[1:]:
        acc = (acc @ m).astype(bool)
    coo = acc.tocoo()
    return _build(coo.row.astype(np.int32), coo.col.astype(np.int32),
                  acc.shape[0], acc.shape[1],
                  is_block=acc.shape[0] != acc.shape[1])
