"""Message-passing API: update_all / apply_edges / apply_nodes.

The parts of ``dgl_hack_tpu.core.message`` that builtins and edge UDFs
use.  A builtin message lowers onto one ``gsddmm`` call, so a message with
a dst-side ('v') operand, such as ``fn.u_dot_v``, reaches K6 on CUDA; a
builtin (message, reduce) pair lowers onto one ``gspmm`` call.  Edge UDFs
get an ``EdgeBatch`` of per-edge gathers.

Reduce UDFs (the padded mailbox), send/recv, pull/push, send_and_recv and
group_apply_edges are not ported yet and raise (ROADMAP Queue 1 item 6).
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: Queue 1 item 6, "
        "'core/message.py')")


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
    """Per-dst-node view for apply-node UDFs (``data``: dstdata)."""

    def __init__(self, data: Dict[str, Tensor]):
        self.data = data

    def batch_size(self) -> int:
        return next(iter(self.data.values())).shape[0] if self.data else 0


# ---------------------------------------------------------------------------
# Core entry points
# ---------------------------------------------------------------------------
def compute_messages(g: Graph, message_func: MessageFunc
                     ) -> Dict[str, Tensor]:
    """Materialise messages per edge (internal order): a builtin through
    ``gsddmm``, a UDF over an ``EdgeBatch``."""
    if isinstance(message_func, BuiltinMessage):
        m = message_func
        lhs = None if m.op == "copy_rhs" else _lookup(g, m.lhs_target,
                                                      m.lhs_field)
        rhs = None if m.op == "copy_lhs" else _lookup(g, m.rhs_target,
                                                      m.rhs_field)
        return {m.out_field: gsddmm(g, m.op, lhs, rhs, m.lhs_target,
                                    m.rhs_target)}
    out = message_func(EdgeBatch(g))
    if not isinstance(out, dict):
        raise TypeError("edge UDF must return a dict of per-edge tensors")
    return out


def update_all(g: Graph, message_func: MessageFunc, reduce_func: ReduceFunc,
               apply_node_func: Optional[Callable] = None,
               max_degree: Optional[int] = None) -> None:
    """Message + reduce over all edges, writing into dstdata.

    Reference: DGLGraph.update_all (python/dgl/graph.py:3221).  A builtin
    pair is one ``gspmm``; a UDF message with a builtin reducer reduces its
    messages as edge data (``copy_e``).  ``max_degree`` sizes the UDF
    mailbox, which is not ported."""
    if not isinstance(reduce_func, BuiltinReduce):
        raise _not_ported("update_all with a reduce UDF (the padded "
                          "mailbox)")
    g._node_frames[-1][reduce_func.out_field] = reduce_messages(
        g, message_func, reduce_func)
    if apply_node_func is not None:
        apply_nodes(g, apply_node_func)


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
    return gspmm(g, "copy_lhs", r.reducer, msgs[r.msg_field], None, "e",
                 "e")


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


def edge_softmax_graph(g: Graph, logits: Tensor, order="internal") -> Tensor:
    return _edge_softmax(g, logits, order)


def _not_ported_fn(name: str):
    def fn(g, *args, **kwargs):
        raise _not_ported(name)
    fn.__name__ = name
    return fn


send_and_recv = _not_ported_fn("send_and_recv")
pull = _not_ported_fn("pull")
push = _not_ported_fn("push")
send = _not_ported_fn("send")
recv = _not_ported_fn("recv")
group_apply_edges = _not_ported_fn("group_apply_edges")


def _attach():
    Graph.update_all = lambda self, mf, rf, af=None, **kw: \
        update_all(self, mf, rf, af, **kw)
    Graph.apply_edges = lambda self, f: apply_edges(self, f)
    Graph.apply_nodes = lambda self, f: apply_nodes(self, f)
    Graph.edge_softmax = edge_softmax_graph
    for fn in (send_and_recv, pull, push, send, recv, group_apply_edges):
        setattr(Graph, fn.__name__, fn)


_attach()
