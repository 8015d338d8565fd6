"""Graph transforms (host-side numpy), as ``dgl_hack_tpu.core.transform``:
``add_self_loop`` and ``remove_self_loop``.  The rest of that module is
not ported yet (ROADMAP: Queue 1 item 9)."""
from __future__ import annotations

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
