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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
IdType = torch.int32

_STRUCT = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids",
           "int2user", "user2int", "edge_mask")


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

    # -- host cache and devices ---------------------------------------------
    def host(self, name: str) -> np.ndarray:
        """numpy copy of a structure array, cached; graphs built on the
        host never copy back from the device."""
        if name not in self._np_cache:
            self._np_cache[name] = getattr(self, name).cpu().numpy()
        return self._np_cache[name]

    def host_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) in user order, host-side."""
        s, d = self.host("src"), self.host("dst")
        if self.int2user is None:
            return s, d
        u2i = self.host("user2int")
        return s[u2i], d[u2i]

    def replace(self, **kw) -> "Graph":
        fields = dict(num_src=self._num_src, num_dst=self._num_dst,
                      is_block=self.is_block, node_frames=self._node_frames,
                      edge_frame=self._edge_frame,
                      batch_num_nodes=self.batch_num_nodes,
                      batch_num_edges=self.batch_num_edges,
                      host_cache=self._np_cache)
        fields.update({n: getattr(self, n) for n in _STRUCT})
        fields.update(kw)
        return Graph(**fields)

    def to(self, device) -> "Graph":
        """Copy with every structure tensor and feature on ``device``."""
        device = torch.device(device)

        def mv(t):
            return None if t is None else t.to(device)

        out = self.replace(
            node_frames=tuple({k: mv(v) for k, v in f.items()}
                              for f in self._node_frames),
            edge_frame={k: mv(v) for k, v in self._edge_frame.items()},
            **{n: mv(getattr(self, n)) for n in _STRUCT})
        out.derived = {k: mv(v) for k, v in self.derived.items()}
        return out

    def __repr__(self):
        kind = "Block" if self.is_block else "Graph"
        return (f"{kind}(num_src={self._num_src}, num_dst={self._num_dst}, "
                f"num_edges={self.src.shape[0]}, device={self.device})")


# ---------------------------------------------------------------------------
# Builders (host-side, numpy)
# ---------------------------------------------------------------------------
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
        arrays["csr_eids"] = np.argsort(s_src, kind="stable").astype(np.int32)
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
