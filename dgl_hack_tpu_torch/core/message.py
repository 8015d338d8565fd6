"""Message-passing API: update_all / apply_edges / apply_nodes,
send_and_recv / pull / push, send / recv and group_apply_edges.

The semantics of ``dgl_hack_tpu.core.message``, line for line:

* a builtin (message, reduce) pair lowers onto one ``gspmm`` call, so
  sum/mean reach K1 and max/min K4/K5 on CUDA;
* a UDF message with a builtin reducer reduces its messages as edge data
  (``gspmm`` copy_e: K1's edge-row mode for sum/mean);
* a builtin message with a dst-side ('v') operand is one ``gsddmm`` call
  (K6); a copy of a src or edge field is a gather, as in the JAX package;
* a reduce UDF gets a ``NodeBatch`` whose ``mailbox`` is the dense padded
  (num_dst, max_degree, ...) box of each dst node's messages
  (``build_mailbox``): the static-shape stand-in for DGL's degree
  bucketing.  ``max_degree`` sizes it (the largest in-degree, one host
  sync, when None);
* ``send_and_recv`` and ``push`` are an ``update_all`` over the graph
  masked to the chosen edges (``Graph.replace(edge_mask=...)``: the frames
  are shared, so the results land in g's); on CUDA each call builds that
  masked graph's real-edge view and row plans anew (one host sync);
* ``pull`` and ``recv`` compute every dst row and keep the new rows of
  ``v`` only, for fields that existed before with the same shape; a field
  new to the frame is written whole (the JAX package's rule);
* ``group_apply_edges`` boxes the edges of each src or dst node as the
  mailbox boxes messages, and scatters the UDF's result back to internal
  (CSC) edge order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from ..function import BuiltinMessage, BuiltinReduce
from ..ops.common import gather_edge_operand
from ..ops.edge_softmax import edge_softmax as _edge_softmax
from ..ops.sddmm import gsddmm
from ..ops.spmm import gspmm
from .graph import Graph

Tensor = torch.Tensor
MessageFunc = Union[BuiltinMessage, Callable]
ReduceFunc = Union[BuiltinReduce, Callable]


def _target_frame(g: Graph, target: str) -> Dict[str, Tensor]:
    if target == "u":
        return g._node_frames[0]
    if target == "v":
        return g._node_frames[-1]
    if target == "e":
        return g._edge_frame
    raise ValueError(target)


def _lookup(g: Graph, target: Optional[str], field: Optional[str]):
    if target is None:
        return None
    frame = _target_frame(g, target)
    if field not in frame:
        kind = {"u": "srcdata", "v": "dstdata", "e": "edata"}[target]
        raise KeyError(f"field {field!r} not found in {kind}")
    return frame[field]


def _expand(x: Tensor, ref: Tensor) -> Tensor:
    """A per-row (N,) tensor shaped to broadcast against (N, ...) ``ref``."""
    return x.reshape(x.shape + (1,) * (ref.dim() - x.dim()))


def _node_mask(n: int, ids, device) -> Tensor:
    """(n,) bool, True at ``ids``."""
    keep = torch.zeros(n, dtype=torch.bool, device=device)
    keep[torch.as_tensor(ids, device=device).long()] = True
    return keep


# ---------------------------------------------------------------------------
# UDF batches (reference: python/dgl/udf.py EdgeBatch/NodeBatch)
# ---------------------------------------------------------------------------
class EdgeBatch:
    """Per-edge view handed to edge UDFs: ``.src``/``.dst``/``.data`` are
    dicts of per-edge tensors (internal CSC order)."""

    def __init__(self, g: Graph):
        self._g = g
        self.src = _LazyGather(g, "u")
        self.dst = _LazyGather(g, "v")
        self.data = _LazyGather(g, "e")

    def edges(self):
        g = self._g
        eid = (torch.arange(g.src.shape[0], dtype=torch.int32,
                            device=g.device)
               if g.int2user is None else g.int2user)
        return g.src, g.dst, eid

    def batch_size(self) -> int:
        return self._g.num_edges()


class _LazyGather:
    def __init__(self, g: Graph, target: str):
        self._g, self._target = g, target

    def __getitem__(self, field: str) -> Tensor:
        return gather_edge_operand(
            self._g, _lookup(self._g, self._target, field), self._target)

    def __contains__(self, field):
        return field in _target_frame(self._g, self._target)

    def keys(self):
        return _target_frame(self._g, self._target).keys()


class NodeBatch:
    """Per-dst-node view for reduce and apply-node UDFs.

    ``mailbox[field]`` is the dense padded mailbox (num_dst, max_degree,
    *feat), padded slots zero; ``mask`` (num_dst, max_degree) marks the
    slots below min(in-degree, max_degree); ``degrees`` is the in-degree
    (padded edges of a masked graph included, as ``Graph.in_degrees``
    counts them)."""

    def __init__(self, data: Dict[str, Tensor], mailbox=None, mask=None,
                 degrees=None):
        self.data = data
        self.mailbox = mailbox
        self.mask = mask
        self.degrees = degrees

    def batch_size(self) -> int:
        return next(iter(self.data.values())).shape[0] if self.data else 0


def _slots(indptr: Tensor, seg: Tensor, max_degree: int) -> Tensor:
    """Each edge's place within its segment (edges grouped by ``seg``,
    whose rows start at ``indptr``), clipped to max_degree - 1."""
    E = seg.shape[0]
    slot = torch.arange(E, device=seg.device) - indptr[seg.long()].long()
    return slot.clamp(max=max_degree - 1)


def _box_rows(v: Tensor, rows: int, cols: int, i: Tensor, j: Tensor,
              edge_mask) -> Tensor:
    """Per-edge rows of ``v`` scattered into (rows, cols, ...) zeros at
    (i, j), padded edges written as zeros."""
    if edge_mask is not None:
        v = torch.where(_expand(edge_mask, v), v, torch.zeros_like(v))
    box = v.new_zeros((rows, cols) + tuple(v.shape[1:]))
    return box.index_put((i, j), v)


def _slot_mask(deg: Tensor, max_degree: int) -> Tensor:
    arange = torch.arange(max_degree, dtype=deg.dtype, device=deg.device)
    return arange[None, :] < deg.clamp(max=max_degree)[:, None]


def build_mailbox(g: Graph, messages: Dict[str, Tensor],
                  max_degree: Optional[int] = None):
    """Scatter per-edge messages (internal order) into (num_dst,
    max_degree, ...) mailboxes; returns (mailbox, mask, degrees).

    An edge goes to slot (its place among its dst's in-edges), clipped to
    ``max_degree - 1``: with a dst of higher in-degree several edges
    write the last slot, and which one is left there is the scatter's
    choice (XLA's in the JAX package, ``index_put`` here, on the card in
    no fixed order).  Pass ``max_degree`` >= the largest in-degree where
    that matters."""
    E = g.num_edges()
    deg = g.in_degrees()
    if max_degree is None:
        max_degree = max(int(deg.max()) if E else 1, 1)
    slot = _slots(g.csc_indptr, g.dst, max_degree)
    dst = g.dst.long()
    mailbox = {k: _box_rows(v, g.num_dst_nodes, max_degree, dst, slot,
                            g.edge_mask) for k, v in messages.items()}
    return mailbox, _slot_mask(deg, max_degree), deg


# ---------------------------------------------------------------------------
# Core entry points
# ---------------------------------------------------------------------------
def compute_messages(g: Graph, message_func: MessageFunc
                     ) -> Dict[str, Tensor]:
    """Materialise messages per edge (internal order): a copy of a src or
    edge field is a gather, any other builtin one ``gsddmm``, a UDF runs
    over an ``EdgeBatch``."""
    if isinstance(message_func, BuiltinMessage):
        m = message_func
        lhs = None if m.op == "copy_rhs" else _lookup(g, m.lhs_target,
                                                      m.lhs_field)
        rhs = None if m.op == "copy_lhs" else _lookup(g, m.rhs_target,
                                                      m.rhs_field)
        copied = (m.lhs_target if m.op == "copy_lhs" else
                  m.rhs_target if m.op == "copy_rhs" else "v")
        if copied != "v":
            return {m.out_field: gather_edge_operand(
                g, lhs if rhs is None else rhs, copied)}
        return {m.out_field: gsddmm(g, m.op, lhs, rhs, m.lhs_target,
                                    m.rhs_target)}
    out = message_func(EdgeBatch(g))
    if not isinstance(out, dict):
        raise TypeError("edge UDF must return a dict of per-edge tensors")
    return out


def reduce_messages(g: Graph, message_func: MessageFunc,
                    reduce_func: BuiltinReduce) -> Tensor:
    """The builtin reducer's (num_dst, ...) result over all edges: a
    builtin (message, reduce) pair is one ``gspmm``; a UDF message's
    messages are reduced as edge data (``copy_e``)."""
    r = reduce_func
    if isinstance(message_func, BuiltinMessage):
        m = message_func
        return gspmm(
            g, m.op, r.reducer,
            None if m.op == "copy_rhs" else _lookup(g, m.lhs_target,
                                                    m.lhs_field),
            None if m.op == "copy_lhs" else _lookup(g, m.rhs_target,
                                                    m.rhs_field),
            m.lhs_target or "u", m.rhs_target or "e")
    msgs = compute_messages(g, message_func)
    return reduce_edge_data(g, msgs[r.msg_field], r.reducer)


def reduce_edge_data(g: Graph, data: Tensor, reducer: str) -> Tensor:
    """Per-edge data (internal order) reduced to the dst nodes, padded
    edges left out (``gspmm`` copy_e)."""
    return gspmm(g, "copy_lhs", reducer, data, None, "e", "e")


def _reduce_udf(g: Graph, msgs: Dict[str, Tensor], reduce_func: Callable,
                max_degree: Optional[int], data: Dict[str, Tensor]
                ) -> Dict[str, Tensor]:
    mailbox, mask, deg = build_mailbox(g, msgs, max_degree)
    res = reduce_func(NodeBatch(dict(data), mailbox, mask, deg))
    if not isinstance(res, dict):
        raise TypeError("reduce UDF must return a dict")
    return res


def update_all(g: Graph, message_func: MessageFunc, reduce_func: ReduceFunc,
               apply_node_func: Optional[Callable] = None,
               max_degree: Optional[int] = None) -> None:
    """Message + reduce over all edges, writing into dstdata (reference:
    DGLGraph.update_all, python/dgl/graph.py:3221).  ``max_degree`` sizes
    a reduce UDF's mailbox."""
    if isinstance(reduce_func, BuiltinReduce):
        g._node_frames[-1][reduce_func.out_field] = reduce_messages(
            g, message_func, reduce_func)
    else:
        g._node_frames[-1].update(_reduce_udf(
            g, compute_messages(g, message_func), reduce_func, max_degree,
            g._node_frames[-1]))
    if apply_node_func is not None:
        apply_nodes(g, apply_node_func)


def apply_edges(g: Graph, func: MessageFunc) -> None:
    """Compute per-edge values and store them in edata (internal order).

    Reference: DGLGraph.apply_edges (python/dgl/graph.py:2600), the
    gSDDMM path."""
    g._edge_frame.update(compute_messages(g, func))


def apply_nodes(g: Graph, func: Callable) -> None:
    """Apply a node UDF over dstdata (reference: graph.py:2546)."""
    res = func(NodeBatch(dict(g._node_frames[-1])))
    if not isinstance(res, dict):
        raise TypeError("node UDF must return a dict")
    g._node_frames[-1].update(res)


def _masked_to(g: Graph, sel: Tensor) -> Graph:
    """g restricted to the edges ``sel`` (internal order) marks, sharing
    its frames."""
    if g.edge_mask is not None:
        sel = sel & g.edge_mask
    return g.replace(edge_mask=sel)


def send_and_recv(g: Graph, edge_ids, message_func: MessageFunc,
                  reduce_func: ReduceFunc) -> None:
    """Message-pass along the edges ``edge_ids`` (user order) alone
    (reference: graph.py:2912): an update_all over g masked to them, the
    other edges contributing the reducer's identity."""
    ids = torch.as_tensor(edge_ids, device=g.device).long()
    if g.int2user is not None:
        ids = g.user2int[ids].long()
    sel = torch.zeros(g.num_edges(), dtype=torch.bool, device=g.device)
    sel[ids] = True
    update_all(_masked_to(g, sel), message_func, reduce_func)


def _keep_rows(new: Tensor, prev: Optional[Tensor], keep: Tensor
               ) -> Tensor:
    """``new`` on the rows ``keep`` marks and ``prev`` elsewhere, where
    ``prev`` exists with new's shape; else ``new`` whole."""
    if prev is None or prev.shape != new.shape:
        return new
    return torch.where(_expand(keep, new), new, prev)


def pull(g: Graph, v, message_func: MessageFunc, reduce_func: ReduceFunc,
         max_degree: Optional[int] = None) -> None:
    """Aggregate into nodes ``v`` only (reference: graph.py:3021).

    O(E) whatever |v|: the full update_all runs, then the rows of v are
    kept for every field it wrote that existed before with the same
    shape (a new field is written whole).  For a small pull repeated on a
    large graph, update_all on ``in_subgraph(g, v)`` instead."""
    frame = g._node_frames[-1]
    prev = dict(frame)
    update_all(g, message_func, reduce_func, max_degree=max_degree)
    keep = _node_mask(g.num_dst_nodes, v, g.device)
    for k, new in list(frame.items()):
        if new is not prev.get(k):
            frame[k] = _keep_rows(new, prev.get(k), keep)


def push(g: Graph, u, message_func: MessageFunc,
         reduce_func: ReduceFunc) -> None:
    """Send along the out-edges of nodes ``u`` only (reference:
    graph.py:3124)."""
    sel = _node_mask(g.num_src_nodes, u, g.device)[g.src.long()]
    update_all(_masked_to(g, sel), message_func, reduce_func)


def edge_softmax_graph(g: Graph, logits: Tensor, order="internal") -> Tensor:
    return _edge_softmax(g, logits, order)


class GroupedEdgeBatch:
    """Edge UDF view for ``group_apply_edges``: ``.src``/``.dst``/``.data``
    are dicts of (num_group_nodes, max_degree, *feat) padded tensors;
    ``mask`` (num_group_nodes, max_degree) marks real slots and
    ``degrees`` gives the group sizes."""

    def __init__(self, src, dst, data, mask, degrees):
        self.src = src
        self.dst = dst
        self.data = data
        self.mask = mask
        self.degrees = degrees

    def batch_size(self) -> int:
        return self.mask.shape[0]


def group_apply_edges(g: Graph, group_by: str, func: Callable,
                      max_degree: Optional[int] = None) -> None:
    """Group the edges by their src or dst node and apply a UDF per group,
    writing its fields to edata (internal order) (reference:
    DGLGraph.group_apply_edges, python/dgl/graph.py:2660).

    The UDF gets a ``GroupedEdgeBatch`` of (N, max_degree, ...) boxes (as
    ``build_mailbox`` makes them, the same clipping at max_degree - 1)
    and returns a dict of tensors of that layout; padded slots are
    dropped on the way back."""
    if group_by not in ("src", "dst"):
        raise ValueError("group_by must be 'src' or 'dst'")
    E = g.num_edges()
    if group_by == "dst":
        n, seg, indptr, order = g.num_dst_nodes, g.dst, g.csc_indptr, None
        deg = g.in_degrees()
    else:
        if g.csr_indptr is None or g.csr_eids is None:
            raise ValueError("group_by='src' requires the CSR format")
        order = g.csr_eids.long()                # src-sorted -> internal
        n, seg, indptr = g.num_src_nodes, g.src[order], g.csr_indptr
        deg = g.out_degrees()
    if max_degree is None:
        max_degree = max(1, int(deg.max())) if E else 1
    slot = _slots(indptr, seg, max_degree)
    emask = g.edge_mask if order is None or g.edge_mask is None \
        else g.edge_mask[order]

    def boxed_frame(target):
        out = {}
        for k, v in _target_frame(g, target).items():
            v = gather_edge_operand(g, v, target)
            out[k] = _box_rows(v if order is None else v[order], n,
                               max_degree, seg.long(), slot, emask)
        return out

    res = func(GroupedEdgeBatch(boxed_frame("u"), boxed_frame("v"),
                                boxed_frame("e"), _slot_mask(deg, max_degree),
                                deg))
    if not isinstance(res, dict):
        raise TypeError("group_apply_edges UDF must return a dict")
    for k, v in res.items():
        flat = v[seg.long(), slot]                 # grouped -> edge order
        if order is not None:
            flat = torch.zeros_like(flat).index_put((order,), flat)
        g._edge_frame[k] = flat


def send(g: Graph, message_func: MessageFunc) -> None:
    """Compute the messages on all edges and stage them on g for ``recv``
    (reference: DGLGraph.send, python/dgl/graph.py:2749).  A graph made
    by ``replace`` does not carry them."""
    g._staged_messages = compute_messages(g, message_func)


def recv(g: Graph, v, reduce_func: ReduceFunc) -> None:
    """Reduce the staged messages into nodes ``v`` (reference:
    DGLGraph.recv, graph.py:2810); rows outside v keep their values, as
    in ``pull``.  A builtin reducer is one ``gspmm`` copy_e, a UDF runs
    over the mailbox.  Raises without a ``send`` first."""
    msgs = getattr(g, "_staged_messages", None)
    if msgs is None:
        raise RuntimeError("recv() without a prior send()")
    keep = _node_mask(g.num_dst_nodes, v, g.device)
    frame = g._node_frames[-1]
    if isinstance(reduce_func, BuiltinReduce):
        r = reduce_func
        res = {r.out_field: reduce_edge_data(g, msgs[r.msg_field],
                                             r.reducer)}
    else:
        res = _reduce_udf(g, msgs, reduce_func, None, frame)
    for k, out in res.items():
        frame[k] = _keep_rows(out, frame.get(k), keep)
    g._staged_messages = None


def _attach():
    """The method forms, with the JAX package's arguments."""
    Graph.update_all = lambda self, mf, rf, af=None, **kw: \
        update_all(self, mf, rf, af, **kw)
    Graph.apply_edges = lambda self, f: apply_edges(self, f)
    Graph.apply_nodes = lambda self, f: apply_nodes(self, f)
    Graph.send_and_recv = lambda self, eids, mf, rf: \
        send_and_recv(self, eids, mf, rf)
    Graph.pull = lambda self, v, mf, rf: pull(self, v, mf, rf)
    Graph.push = lambda self, u, mf, rf: push(self, u, mf, rf)
    Graph.edge_softmax = edge_softmax_graph
    Graph.send = lambda self, mf: send(self, mf)
    Graph.recv = lambda self, v, rf: recv(self, v, rf)
    Graph.group_apply_edges = lambda self, group_by, f, **kw: \
        group_apply_edges(self, group_by, f, **kw)


_attach()
