"""Graph transforms (host-side numpy), as ``dgl_hack_tpu.core.transform``:
``add_self_loop``, ``remove_self_loop`` and ``to_block``.  The rest of
that module is not ported yet (ROADMAP: Queue 1 item 9)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import Graph, _build


def add_self_loop(g: Graph) -> Graph:
    """g's edges (user order) followed by one loop per node; the result
    lands on g's device."""
    s, d = g.host_edges()
    loop = np.arange(g.num_nodes(), dtype=np.int32)
    return _build(np.concatenate([s, loop]).astype(np.int32),
                  np.concatenate([d, loop]).astype(np.int32),
                  g.num_nodes(), g.num_nodes(), is_block=False).to(g.device)


def remove_self_loop(g: Graph) -> Graph:
    """g without its loops; the result lands on g's device."""
    s, d = g.host_edges()
    keep = s != d
    return _build(s[keep].astype(np.int32), d[keep].astype(np.int32),
                  g.num_nodes(), g.num_nodes(), is_block=False).to(g.device)


def to_block(frontier: Graph, dst_nodes: Optional[np.ndarray] = None,
             include_dst_in_src: bool = True,
             pad_num_src: Optional[int] = None,
             pad_num_edges: Optional[int] = None):
    """Bipartite compaction of a sampled frontier, the minibatch block
    builder, on the host in numpy as the JAX package's.

    dst nodes are ``dst_nodes`` (default: the frontier's unique dst); src
    nodes are the dst nodes first (dstdata is a prefix of srcdata) and then
    the other source endpoints.  Where ``dst_nodes`` repeats an id, the
    last of its places wins, in both maps.  ``pad_num_src`` pads the src
    set and ``pad_num_edges`` the edges (to node 0 -> node 0, mask False);
    asking for edge padding always carries a mask and the internal/user
    permutations, even at an exact fit, so that every padded block has the
    same structure.  The block's tensors are on the CPU.

    Returns (block, src_orig_ids, dst_orig_ids)."""
    s, d = frontier.host_edges()
    if dst_nodes is None:
        dst_nodes = np.unique(d)
    dst_nodes = np.asarray(dst_nodes, np.int32)
    n_dst = len(dst_nodes)

    dmap = np.full(frontier.num_dst_nodes, -1, np.int32)
    dmap[dst_nodes] = np.arange(n_dst, dtype=np.int32)

    if include_dst_in_src:
        smap = np.full(frontier.num_src_nodes, -1, np.int64)
        smap[dst_nodes] = np.arange(n_dst)
        extra = np.unique(s[smap[s] < 0]) if len(s) else np.zeros(0, np.int64)
        extra = extra[smap[extra] < 0]
        smap[extra] = n_dst + np.arange(len(extra))
        src_ids = np.concatenate([dst_nodes, extra.astype(np.int32)])
    else:
        src_ids = np.unique(s)
        smap = np.full(frontier.num_src_nodes, -1, np.int64)
        smap[src_ids] = np.arange(len(src_ids))
    n_src = len(src_ids)

    bs = smap[s].astype(np.int32)
    bd = dmap[d]
    keep = bd >= 0
    bs, bd = bs[keep], bd[keep]
    E = len(bs)

    num_src = n_src if pad_num_src is None else max(pad_num_src, n_src)
    mask = None
    if pad_num_edges is not None:
        pad = max(pad_num_edges - E, 0)
        bs = np.concatenate([bs, np.zeros(pad, np.int32)])
        bd = np.concatenate([bd, np.zeros(pad, np.int32)])
        mask = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    blk = _build(bs, bd, num_src, n_dst, is_block=True, edge_mask=mask,
                 force_perm=pad_num_edges is not None)
    if pad_num_src is not None and num_src > n_src:
        src_ids = np.concatenate(
            [src_ids, np.zeros(num_src - n_src, np.int32)])
    return blk, src_ids.astype(np.int32), dst_nodes
