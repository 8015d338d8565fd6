"""Graph structure for the PyTorch port.

The same design as ``dgl_hack_tpu.core.graph``: a graph is an immutable
set of int32 index tensors built on the host with numpy.

* Internal edge order is **dst-sorted** (CSC order), a stable argsort on
  dst.  ``int2user``/``user2int`` map between internal and user (insertion)
  edge order, and are None when the input was already dst-sorted.
* CSR (out-edges) is an explicit permutation ``csr_eids`` of internal edge
  ids, a stable argsort of the sorted src, with its ``csr_indptr``.
* ``edge_mask`` marks padded edges (False = padding).
* Every index is int32; graphs beyond 2^31-1 nodes or edges are refused.

``Graph.to(device)`` returns a copy whose tensors live on ``device``; the
host-side numpy arrays stay cached, so host code never copies back.
``Graph.replace`` keeps the cached arrays of the fields it does not
replace; the others are read anew from the new tensors.

Host-side constructors (``from_scipy``, ``from_networkx``/``to_networkx``,
``reverse``), the structure queries (``in_edges`` ... ``filter_edges``)
and DGL's method surface (``local_var``, ``subgraph``,
``adjacency_matrix`` ...) follow the JAX module's, on numpy.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span, spanned

Tensor = torch.Tensor
IdType = torch.int32

_STRUCT = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids",
           "int2user", "user2int", "edge_mask")
# fields whose change makes ``derived`` (views, row plans, batch
# segments) stale
_DERIVED_FROM = set(_STRUCT) | {"num_src", "num_dst", "is_block",
                         "batch_num_nodes", "batch_num_edges"}


class _FrameView:
    """dict-like view over a feature frame, with an optional permutation
    applied on get/set (edata: user order outside, internal inside)."""

    __slots__ = ("_frame", "_get_perm", "_set_perm")

    def __init__(self, frame: Dict[str, Tensor], get_perm=None,
                 set_perm=None):
        self._frame = frame
        self._get_perm = get_perm
        self._set_perm = set_perm

    def __getitem__(self, key: str) -> Tensor:
        v = self._frame[key]
        if self._get_perm is not None:
            v = v[self._get_perm.to(v.device)]
        return v

    def __setitem__(self, key: str, value) -> None:
        value = torch.as_tensor(value)
        if self._set_perm is not None:
            value = value[self._set_perm.to(value.device)]
        self._frame[key] = value

    def __delitem__(self, key: str) -> None:
        del self._frame[key]

    def __contains__(self, key: str) -> bool:
        return key in self._frame

    def __iter__(self):
        return iter(self._frame)

    def __len__(self):
        return len(self._frame)

    def keys(self):
        return self._frame.keys()

    def pop(self, key: str) -> Tensor:
        v = self[key]
        del self._frame[key]
        return v

    def update(self, other) -> None:
        for k in other:
            self[k] = other[k]

    def internal(self, key: str) -> Tensor:
        """The stored (internal-order) tensor, without the permutation."""
        return self._frame[key]


class Graph:
    """Immutable (bi)graph over int32 index tensors.

    Structure tensors:
      src, dst            (E,)  endpoints in internal (dst-sorted) order
      csc_indptr          (num_dst+1,)  in-edge offsets per dst node
      csr_indptr          (num_src+1,)  out-edge offsets per src node
      csr_eids            (E,)  internal edge ids in src-sorted order
      int2user / user2int (E,)  internal <-> user edge order (or None)
      edge_mask           (E,) bool or None; False rows are padding

    A graph made by ``core.batch.batch`` also carries ``batch_num_nodes``
    and ``batch_num_edges``, tuples of per-graph counts (None otherwise),
    which the readouts take their segments from.
    """

    def __init__(self, *, num_src: int, num_dst: int, src: Tensor,
                 dst: Tensor, csc_indptr: Tensor,
                 csr_indptr: Optional[Tensor] = None,
                 csr_eids: Optional[Tensor] = None,
                 int2user: Optional[Tensor] = None,
                 user2int: Optional[Tensor] = None,
                 edge_mask: Optional[Tensor] = None,
                 is_block: bool = False,
                 node_frames: Optional[Tuple[Dict[str, Tensor], ...]] = None,
                 edge_frame: Optional[Dict[str, Tensor]] = None,
                 batch_num_nodes: Optional[Tuple[int, ...]] = None,
                 batch_num_edges: Optional[Tuple[int, ...]] = None,
                 host_cache: Optional[Dict[str, np.ndarray]] = None):
        self._num_src = int(num_src)
        self._num_dst = int(num_dst)
        self.src = src
        self.dst = dst
        self.csc_indptr = csc_indptr
        self.csr_indptr = csr_indptr
        self.csr_eids = csr_eids
        self.int2user = int2user
        self.user2int = user2int
        self.edge_mask = edge_mask
        self.is_block = bool(is_block)
        if node_frames is None:
            node_frames = ({}, {}) if is_block else ({},)
        self._node_frames = node_frames
        self._edge_frame = {} if edge_frame is None else edge_frame
        self.batch_num_nodes = batch_num_nodes
        self.batch_num_edges = batch_num_edges
        self._np_cache = {} if host_cache is None else host_cache
        # device tensors derived from the structure, and K1's row plans
        # (tuples of them with a .to); ops/cuda fills it
        self.derived: Dict[str, Any] = {}

    # -- basic properties ---------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_src_nodes(self) -> int:
        return self._num_src

    @property
    def num_dst_nodes(self) -> int:
        return self._num_dst

    def number_of_nodes(self) -> int:
        if self.is_block:
            raise ValueError("block has distinct src/dst node sets; use "
                             "num_src_nodes/num_dst_nodes")
        return self._num_dst

    num_nodes = number_of_nodes

    def number_of_edges(self) -> int:
        return int(self.src.shape[0])

    num_edges = number_of_edges

    @property
    def num_edges_static(self) -> int:
        return int(self.src.shape[0])

    # -- frames -------------------------------------------------------------
    @property
    def srcdata(self) -> _FrameView:
        return _FrameView(self._node_frames[0])

    @property
    def dstdata(self) -> _FrameView:
        return _FrameView(self._node_frames[-1])

    @property
    def ndata(self) -> _FrameView:
        if self.is_block:
            raise ValueError("block graphs use srcdata/dstdata")
        return _FrameView(self._node_frames[0])

    @property
    def edata(self) -> _FrameView:
        """Edge features in user (insertion) order; stored internally in
        CSC order."""
        return _FrameView(self._edge_frame, get_perm=self.user2int,
                          set_perm=self.int2user)

    @property
    def edata_internal(self) -> _FrameView:
        """Edge features in internal (CSC) order, as the ops take them."""
        return _FrameView(self._edge_frame)

    # -- structure queries --------------------------------------------------
    def edges(self, order: str = "eid") -> Tuple[Tensor, Tensor]:
        """(src, dst); order='eid' is user order, 'internal' CSC order."""
        if order == "internal" or self.int2user is None:
            return self.src, self.dst
        if order == "eid":
            return self.src[self.user2int], self.dst[self.user2int]
        raise ValueError(order)

    def in_degrees(self) -> Tensor:
        return (self.csc_indptr[1:] - self.csc_indptr[:-1]).to(IdType)

    def out_degrees(self) -> Tensor:
        if self.csr_indptr is None:
            raise ValueError("graph was built without the CSR format")
        return (self.csr_indptr[1:] - self.csr_indptr[:-1]).to(IdType)

    @property
    def dst_sorted(self) -> bool:
        return True  # the internal order is always CSC

    # -- host cache and devices ---------------------------------------------
    def host(self, name: str) -> Optional[np.ndarray]:
        """numpy copy of a structure array, cached (None for a field the
        graph lacks); graphs built on the host never copy back from the
        device."""
        if name not in self._np_cache:
            t = getattr(self, name)
            if t is None:
                return None
            self._np_cache[name] = t.cpu().numpy()
        return self._np_cache[name]

    def host_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) in user order, host-side."""
        s, d = self.host("src"), self.host("dst")
        if self.int2user is None:
            return s, d
        u2i = self.host("user2int")
        return s[u2i], d[u2i]

    def replace(self, **kw) -> "Graph":
        """A new graph with the given fields replaced; the frames (and, for
        an unchanged structure, ``derived``) are shared.  The host cache
        keeps the arrays of the fields not replaced: the rest are read
        from the new tensors when asked for."""
        fields = dict(num_src=self._num_src, num_dst=self._num_dst,
                      is_block=self.is_block, node_frames=self._node_frames,
                      edge_frame=self._edge_frame,
                      batch_num_nodes=self.batch_num_nodes,
                      batch_num_edges=self.batch_num_edges,
                      host_cache={k: v for k, v in self._np_cache.items()
                                  if k not in kw})
        fields.update({n: getattr(self, n) for n in _STRUCT})
        fields.update(kw)
        out = Graph(**fields)
        if not set(kw) & _DERIVED_FROM:
            out.derived = self.derived
        return out

    def structure_only(self) -> "Graph":
        """Copy without feature frames (cheap; tensors are shared)."""
        return self.replace(node_frames=None, edge_frame=None)

    def to(self, device, non_blocking: bool = False) -> "Graph":
        """Copy with every structure tensor and feature on ``device``.
        ``non_blocking`` copies host tensors to the card through pinned
        memory on the current stream without waiting for the copies: the
        caller synchronises that stream before the graph is read."""
        device = torch.device(device)
        pin = non_blocking and device.type == "cuda"

        def mv(t):
            if t is None:
                return None
            if pin and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)

        out = self.replace(
            node_frames=tuple({k: mv(v) for k, v in f.items()}
                              for f in self._node_frames),
            edge_frame={k: mv(v) for k, v in self._edge_frame.items()},
            host_cache=self._np_cache,
            **{n: mv(getattr(self, n)) for n in _STRUCT})
        out.derived = {k: None if v is None else v.to(device)
                       for k, v in self.derived.items()}
        return out

    def __repr__(self):
        kind = "Block" if self.is_block else "Graph"
        return (f"{kind}(num_src={self._num_src}, num_dst={self._num_dst}, "
                f"num_edges={self.src.shape[0]}, device={self.device})")


# ---------------------------------------------------------------------------
# Builders (host-side, numpy)
# ---------------------------------------------------------------------------
@spanned("graph.build")
def _build(src: np.ndarray, dst: np.ndarray, num_src: int, num_dst: int,
           *, is_block: bool, build_csr: bool = True,
           edge_mask: Optional[np.ndarray] = None,
           force_perm: bool = False) -> Graph:
    """Same edge order as the JAX package's builder: a stable argsort on
    dst, then a stable CSR permutation over the sorted src.
    ``force_perm`` keeps ``int2user``/``user2int`` even where the input was
    already dst-sorted, as that builder does for padded blocks."""
    E = src.shape[0]
    i32_max = np.iinfo(np.int32).max
    if E > i32_max or num_src > i32_max or num_dst > i32_max:
        raise ValueError(
            f"graph exceeds the int32 id ceiling (num_src={num_src}, "
            f"num_dst={num_dst}, num_edges={E} vs 2^31-1); partition the "
            "graph before building device arrays")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if E and (src.min(initial=0) < 0 or src.max(initial=-1) >= num_src):
        raise ValueError("src ids out of range")
    if E and (dst.min(initial=0) < 0 or dst.max(initial=-1) >= num_dst):
        raise ValueError("dst ids out of range")

    with span("graph.build.sort"):
        perm = np.argsort(dst, kind="stable").astype(np.int32)
    already_sorted = (not force_perm) and \
        bool(np.all(perm == np.arange(E, dtype=np.int32)))
    s_src, s_dst = src[perm], dst[perm]
    csc_indptr = np.zeros(num_dst + 1, dtype=np.int32)
    np.cumsum(np.bincount(s_dst, minlength=num_dst), out=csc_indptr[1:])

    arrays: Dict[str, np.ndarray] = {"src": s_src, "dst": s_dst,
                                     "csc_indptr": csc_indptr}
    if not already_sorted:
        inv = np.empty(E, dtype=np.int32)
        inv[perm] = np.arange(E, dtype=np.int32)
        arrays["int2user"] = perm       # internal i -> user id perm[i]
        arrays["user2int"] = inv        # user u -> internal position
    if build_csr:
        with span("graph.build.sort"):
            arrays["csr_eids"] = np.argsort(s_src, kind="stable").astype(
                np.int32)
        csr_indptr = np.zeros(num_src + 1, dtype=np.int32)
        np.cumsum(np.bincount(s_src, minlength=num_src), out=csr_indptr[1:])
        arrays["csr_indptr"] = csr_indptr
    if edge_mask is not None:
        arrays["edge_mask"] = np.asarray(edge_mask, dtype=bool)[perm]
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return Graph(num_src=num_src, num_dst=num_dst, is_block=is_block,
                 host_cache=arrays, **tensors)


def graph(edges, num_nodes: Optional[int] = None, build_csr: bool = True,
          edge_mask=None, device=None) -> Graph:
    """Build a homogeneous graph from an edge list ``(src, dst)``.

    Host-side numpy preprocessing; tensors land on ``device`` (CPU when
    None)."""
    src = np.asarray(edges[0])
    dst = np.asarray(edges[1])
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if edge_mask is not None:
        edge_mask = np.asarray(edge_mask, dtype=bool)
    g = _build(src, dst, num_nodes, num_nodes, is_block=False,
               build_csr=build_csr, edge_mask=edge_mask)
    return g if device is None else g.to(device)


def block(edges, num_src: int, num_dst: int, build_csr: bool = True,
          edge_mask=None, device=None) -> Graph:
    """Build a bipartite block from an edge list ``(src, dst)`` over
    ``num_src`` source and ``num_dst`` destination nodes, with separate
    src and dst frames (``srcdata``/``dstdata``).  Tensors land on
    ``device`` (CPU when None)."""
    src = np.asarray(edges[0])
    dst = np.asarray(edges[1])
    if edge_mask is not None:
        edge_mask = np.asarray(edge_mask, dtype=bool)
    g = _build(src, dst, int(num_src), int(num_dst), is_block=True,
               build_csr=build_csr, edge_mask=edge_mask)
    return g if device is None else g.to(device)


def from_scipy(spmat, build_csr: bool = True) -> Graph:
    """Graph from a scipy sparse matrix (row = src, col = dst), on the
    CPU."""
    coo = spmat.tocoo()
    n = max(coo.shape)
    return _build(coo.row.astype(np.int32), coo.col.astype(np.int32),
                  n, n, is_block=False, build_csr=build_csr)


def from_networkx(nx_graph, node_attrs: Optional[Sequence[str]] = None,
                  edge_attrs: Optional[Sequence[str]] = None,
                  build_csr: bool = True) -> Graph:
    """Graph from a networkx graph, on the CPU.  Nodes are relabelled
    0..N-1 in sorted node order; an undirected graph gives both
    directions of each edge.  ``node_attrs``/``edge_attrs`` name the
    attributes stacked into ``ndata``/``edata`` (edges in user order)."""
    nodes = sorted(nx_graph.nodes())
    relabel = {n: i for i, n in enumerate(nodes)}
    n = len(nodes)
    directed = nx_graph.is_directed()
    us, vs, edge_rows = [], [], []
    for u, v, data in nx_graph.edges(data=True):
        us.append(relabel[u])
        vs.append(relabel[v])
        edge_rows.append(data)
        if not directed:
            us.append(relabel[v])
            vs.append(relabel[u])
            edge_rows.append(data)
    g = _build(np.asarray(us, dtype=np.int32), np.asarray(vs, dtype=np.int32),
               n, n, is_block=False, build_csr=build_csr)
    for key in node_attrs or ():
        g.ndata[key] = torch.from_numpy(np.stack(
            [np.asarray(nx_graph.nodes[nd][key]) for nd in nodes]))
    for key in edge_attrs or ():
        g.edata[key] = torch.from_numpy(np.stack(
            [np.asarray(row[key]) for row in edge_rows]))
    return g


def to_networkx(g: Graph, node_attrs: Optional[Sequence[str]] = None,
                edge_attrs: Optional[Sequence[str]] = None):
    """A networkx MultiDiGraph of g, edges in user order with an ``id``
    attribute, features as numpy rows."""
    import networkx as nx
    nxg = nx.MultiDiGraph()
    nxg.add_nodes_from(range(g.num_nodes()))
    src, dst = g.host("src"), g.host("dst")
    eid = (g.host("int2user") if g.int2user is not None
           else np.arange(src.shape[0]))
    nfeat = {k: g.ndata[k].detach().cpu().numpy() for k in node_attrs or ()}
    efeat = {k: g.edata[k].detach().cpu().numpy() for k in edge_attrs or ()}
    for i in np.argsort(eid, kind="stable"):
        attrs = {"id": int(eid[i])}
        for k, v in efeat.items():
            attrs[k] = v[int(eid[i])]
        nxg.add_edge(int(src[i]), int(dst[i]), **attrs)
    for k, v in nfeat.items():
        for nd in range(g.num_nodes()):
            nxg.nodes[nd][k] = v[nd]
    return nxg


def reverse(g: Graph) -> Graph:
    """The edge-reversed graph on g's device; its user edge order is g's
    internal order, as in the JAX package.  Features are not carried."""
    return _build(g.host("dst"), g.host("src"), g.num_dst_nodes,
                  g.num_src_nodes, is_block=g.is_block, build_csr=True,
                  edge_mask=g.host("edge_mask")).to(g.device)


# ---------------------------------------------------------------------------
# Structure queries (host-side numpy; ids in user order)
# ---------------------------------------------------------------------------
def _user_eids(g: Graph) -> np.ndarray:
    """User edge id of each internal position."""
    return (g.host("int2user") if g.int2user is not None
            else np.arange(g.num_edges(), dtype=np.int32))


def _rows(indptr: np.ndarray, nodes) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, owners): the index ranges of ``nodes`` in ``indptr``
    concatenated, and the node each position belongs to."""
    nodes = np.atleast_1d(np.asarray(nodes, np.int64))
    pos = np.concatenate([np.arange(indptr[n], indptr[n + 1])
                          for n in nodes]) if len(nodes) else \
        np.zeros(0, np.int64)
    return pos, np.repeat(nodes, indptr[nodes + 1] - indptr[nodes])


def in_edges(self, v):
    """(src, dst, eid) of the in-edges of nodes ``v``."""
    pos, dsts = _rows(self.host("csc_indptr"), v)
    return self.host("src")[pos], dsts.astype(np.int32), \
        _user_eids(self)[pos]


def out_edges(self, u):
    """(src, dst, eid) of the out-edges of nodes ``u``."""
    if self.csr_indptr is None:
        raise ValueError("graph was built without the CSR format")
    pos, srcs = _rows(self.host("csr_indptr"), u)
    e_int = self.host("csr_eids")[pos]
    return srcs.astype(np.int32), self.host("dst")[e_int], \
        _user_eids(self)[e_int]


def predecessors(self, v):
    return np.unique(self.in_edges(v)[0])


def successors(self, u):
    return np.unique(self.out_edges(u)[1])


def _pair_index(self):
    """Sorted (src << 32 | dst) keys of the user-order edges and the
    order that sorts them, built once per graph."""
    cache = getattr(self, "_pair_lut", None)
    if cache is None:
        s, d = self.host_edges()
        keys = s.astype(np.int64) << 32 | d.astype(np.int64)
        order = np.argsort(keys, kind="stable")
        cache = (keys[order], order.astype(np.int32))
        self._pair_lut = cache
    return cache


def _pair_lookup(self, u, v):
    """(hit, position in the sorted keys) of each (u, v) query."""
    keys, _ = self._pair_index()
    u = np.atleast_1d(np.asarray(u, np.int64))
    v = np.atleast_1d(np.asarray(v, np.int64))
    q = u << 32 | v
    if not len(keys):
        return np.zeros(len(q), bool), np.zeros(len(q), np.int64)
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return keys[pos] == q, pos


def has_edges_between(self, u, v):
    return _pair_lookup(self, u, v)[0]


def edge_ids(self, u, v):
    """First edge id (user order) between each (u, v) pair; -1 if
    absent."""
    hit, pos = _pair_lookup(self, u, v)
    order = self._pair_index()[1]
    return np.where(hit, order[pos] if len(order) else 0, -1).astype(
        np.int32)


def filter_nodes(self, predicate):
    """Node ids where ``predicate(NodeBatch)`` is True."""
    from .message import NodeBatch
    keep = torch.as_tensor(predicate(NodeBatch(dict(self._node_frames[-1]))))
    return np.nonzero(keep.cpu().numpy())[0].astype(np.int32)


def filter_edges(self, predicate):
    """Edge ids (user order) where ``predicate(EdgeBatch)`` is True."""
    from .message import EdgeBatch
    keep = torch.as_tensor(predicate(EdgeBatch(self))).cpu().numpy()
    if self.user2int is not None:
        keep = keep[self.host("user2int")]
    return np.nonzero(keep)[0].astype(np.int32)


# ---------------------------------------------------------------------------
# DGL's method surface
# ---------------------------------------------------------------------------
def local_var(self) -> Graph:
    """A copy sharing the structure whose frame writes do not show on
    this graph (its frame dicts are copies)."""
    g = self.replace()
    g._node_frames = tuple(dict(f) for f in self._node_frames)
    g._edge_frame = dict(self._edge_frame)
    return g


@contextlib.contextmanager
def local_scope(self):
    """Frame writes inside the block are undone on exit."""
    saved_n = [dict(f) for f in self._node_frames]
    saved_e = dict(self._edge_frame)
    try:
        yield self
    finally:
        for f, s in zip(self._node_frames, saved_n):
            f.clear()
            f.update(s)
        self._edge_frame.clear()
        self._edge_frame.update(saved_e)


def subgraph(self, nodes):
    from .transform import node_subgraph
    return node_subgraph(self, nodes)


def edge_subgraph_m(self, eids, relabel_nodes: bool = True):
    from .transform import edge_subgraph
    return edge_subgraph(self, eids, relabel_nodes)


def in_degree(self, v) -> int:
    indptr = self.host("csc_indptr")
    return int(indptr[int(v) + 1] - indptr[int(v)])


def out_degree(self, u) -> int:
    indptr = self.host("csr_indptr")
    return int(indptr[int(u) + 1] - indptr[int(u)])


def has_node(self, v) -> bool:
    return 0 <= int(v) < self.num_nodes()


def has_edge_between(self, u, v) -> bool:
    return bool(self.has_edges_between([u], [v])[0])


def adjacency_matrix(self, transpose: bool = False, scipy_fmt=None):
    """The adjacency A[dst, src] (A[src, dst] with ``transpose``): a
    scipy matrix in ``scipy_fmt``, else a dense tensor on g's device."""
    import scipy.sparse as sp
    s, d = self.host_edges()
    a = sp.coo_matrix((np.ones(len(s), np.float32), (d, s)),
                      shape=(self.num_dst_nodes, self.num_src_nodes))
    if transpose:
        a = a.T
    if scipy_fmt:
        return a.asformat(scipy_fmt)
    return torch.from_numpy(a.toarray()).to(self.device)


def incidence_matrix(self, typestr: str = "both"):
    """The (num_nodes, num_edges) incidence ('in', 'out' or 'both': +1 at
    the dst, -1 at the src, 0 for a loop), dense, on g's device."""
    s, d = self.host_edges()
    E = len(s)
    m = np.zeros((self.num_nodes(), E), np.float32)
    if typestr in ("in", "both"):
        m[d, np.arange(E)] += 1.0
    if typestr in ("out", "both"):
        m[s, np.arange(E)] += -1.0 if typestr == "both" else 1.0
    if typestr == "both":
        loop = s == d
        m[d[loop], np.nonzero(loop)[0]] = 0.0
    return torch.from_numpy(m).to(self.device)


def add_nodes_m(self, num: int) -> Graph:
    """A new graph with ``num`` more nodes (graphs are immutable)."""
    from .transform import add_nodes
    return add_nodes(self, num)


def add_edges_m(self, u, v) -> Graph:
    """A new graph with the edges (u, v) appended."""
    from .transform import add_edges
    return add_edges(self, u, v)


for _fn in (in_edges, out_edges, predecessors, successors, _pair_index,
            has_edges_between, edge_ids, filter_nodes, filter_edges,
            local_var, local_scope, subgraph, in_degree, out_degree,
            has_node, has_edge_between, adjacency_matrix, incidence_matrix):
    setattr(Graph, _fn.__name__, _fn)
Graph.edge_subgraph = edge_subgraph_m
Graph.add_nodes = add_nodes_m
Graph.add_edges = add_edges_m
Graph.is_readonly = property(lambda self: True)
del _fn
