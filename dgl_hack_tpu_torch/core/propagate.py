"""Frontier-ordered message propagation, as
``dgl_hack_tpu.core.propagate`` (reference: python/dgl/propagate.py):
``pull`` (or ``send_and_recv``) one traversal frontier at a time.

Each ``pull`` is a full ``update_all`` (one K1 launch over the whole graph
for a sum) whose rows outside the frontier are dropped; each
``send_and_recv`` builds a masked graph, and on the card its real-edge
view and row plans, anew."""
from __future__ import annotations

from . import traversal
from .graph import Graph
from .message import pull, send_and_recv


def prop_nodes(g: Graph, nodes_generator, message_func, reduce_func) -> None:
    for frontier in nodes_generator:
        pull(g, frontier, message_func, reduce_func)


def prop_edges(g: Graph, edges_generator, message_func, reduce_func) -> None:
    for frontier in edges_generator:
        send_and_recv(g, frontier, message_func, reduce_func)


def prop_nodes_bfs(g: Graph, source, message_func, reduce_func,
                   reverse: bool = False) -> None:
    prop_nodes(g, traversal.bfs_nodes_generator(g, source, reverse),
               message_func, reduce_func)


def prop_nodes_topo(g: Graph, message_func, reduce_func,
                    reverse: bool = False) -> None:
    prop_nodes(g, traversal.topological_nodes_generator(g, reverse),
               message_func, reduce_func)


def prop_edges_dfs(g: Graph, source, message_func, reduce_func,
                   reverse: bool = False) -> None:
    prop_edges(g, traversal.dfs_edges_generator(g, source, reverse),
               message_func, reduce_func)
