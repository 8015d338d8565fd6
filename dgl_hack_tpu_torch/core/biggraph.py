"""Big-graph (int64-id) host path, as ``dgl_hack_tpu.core.biggraph``:
build and shard graphs whose node / edge IDENTIFIERS exceed the int32
device-id ceiling.

Reference parity: DGL carries 32/64-bit ids end-to-end
(python/dgl/heterograph_index.py:162-183 ``asbits``/``bits_needed``).
Every device index of this package is int32 (the kernels read int32 ids),
so the big-graph path keeps int64 ids ON THE HOST and builds graphs only
per partition, in compact int32 LOCAL id spaces:

* ``BigGraph`` -- int64 edge list container; no tensors.
* ``BigGraph.compact()`` -- relabel conceptual int64 ids (sparse, e.g.
  48-bit hash keys) to a dense int32 space + keep the int64 id map.
* ``BigGraph.partition(k)`` -- Fennel (or, past 2^31 edges, a stateless
  hash) partition of the compacted graph into ``BigPartition``s whose
  ``node_map64``/``edge_map64`` recover the conceptual int64 ids; each
  part's local graph is a normal int32 ``Graph``.
* ``BigGraph.spatial_plan(k)`` -- a ``parallel.halo.SpatialPlan`` over
  the compacted graph for multi-GPU training.

The ACTUAL (materialised) node/edge counts must fit host memory and the
per-part counts must fit int32; conceptual id VALUES are unbounded int64.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .graph import Graph, _build

_I32_MAX = np.iinfo(np.int32).max
# Fibonacci hashing's 64-bit constant 0x9E3779B97F4A7C15 as an int64: the
# product wraps mod 2^64 and the shift is arithmetic.  The JAX module
# writes np.int64(0x9E3779B97F4A7C15), which raises OverflowError, so its
# hash branch never runs.
_GOLDEN = np.int64(0x9E3779B97F4A7C15 - (1 << 64))


@dataclass
class BigPartition:
    """One partition of a BigGraph: int32 local graph + int64 id maps."""
    graph: Graph
    node_map64: np.ndarray     # (n_local,) conceptual int64 node id
    edge_map64: np.ndarray     # (e_local,) conceptual int64 edge id
    inner_node: np.ndarray
    part_id: int


class BigGraph:
    """Host-side int64-id edge list; int32 graphs only per partition."""

    def __init__(self, src: np.ndarray, dst: np.ndarray,
                 edge_ids: Optional[np.ndarray] = None):
        self.src64 = np.ascontiguousarray(src, np.int64)
        self.dst64 = np.ascontiguousarray(dst, np.int64)
        if self.src64.shape != self.dst64.shape:
            raise ValueError("src/dst length mismatch")
        E = self.src64.shape[0]
        # conceptual edge ids default to int64 positions (may be >= 2^31
        # when the caller streams edges in from a larger corpus)
        self.edge_ids64 = (np.arange(E, dtype=np.int64) if edge_ids is None
                           else np.ascontiguousarray(edge_ids, np.int64))
        self._uids: Optional[np.ndarray] = None
        self._csrc: Optional[np.ndarray] = None
        self._cdst: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.src64.shape[0])

    def compact(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(uids64, src32, dst32): dense relabel of the conceptual ids.
        The ACTUAL unique-node count must fit int32 (partition upstream
        if it does not — each ingest shard compacts independently)."""
        if self._uids is None:
            uids, inv = np.unique(
                np.concatenate([self.src64, self.dst64]), return_inverse=True)
            if uids.shape[0] > _I32_MAX:
                raise ValueError(
                    f"{uids.shape[0]} materialised nodes exceed int32; "
                    "shard the ingest before building one BigGraph")
            E = self.num_edges
            self._uids = uids
            self._csrc = inv[:E].astype(np.int32)
            self._cdst = inv[E:].astype(np.int32)
        return self._uids, self._csrc, self._cdst

    def compact_graph(self, build_csr: bool = True) -> Tuple[Graph, np.ndarray]:
        """The whole graph in the dense int32 space + int64 node-id map
        (valid when actual counts fit int32 — the common case where only
        the id VALUES are 64-bit)."""
        uids, s, d = self.compact()
        if self.num_edges > _I32_MAX:
            raise ValueError("edge count exceeds int32; use partition()")
        g = _build(s, d, len(uids), len(uids), is_block=False,
                   build_csr=build_csr)
        return g, uids

    def partition(self, k: int, method: str = "fennel",
                  seed: int = 0) -> List[BigPartition]:
        """Per-part int32 local graphs with int64 id maps (edges owned by
        their dst part, matching the spatial plan's convention)."""
        uids, s, d = self.compact()
        n = len(uids)
        if method == "fennel" and self.num_edges <= _I32_MAX:
            g, _ = self.compact_graph()
            from ..partition.partition import partition as make_parts
            parts = make_parts(g, k, method="fennel", seed=seed)
        else:
            # stateless hash partition: works at any edge count
            parts = (((uids * _GOLDEN) >> np.int64(40)) % k).astype(np.int32)
        out: List[BigPartition] = []
        ep = parts[d]
        for p in range(k):
            esel = np.nonzero(ep == p)[0]
            ln = np.unique(np.concatenate([s[esel], d[esel],
                                           np.nonzero(parts == p)[0]]))
            owned = parts[ln] == p
            order = np.argsort(~owned, kind="stable")   # owned first
            ln = ln[order]
            if len(ln) > _I32_MAX or len(esel) > _I32_MAX:
                raise ValueError(f"part {p} exceeds int32; raise k")
            local = np.full(n, -1, np.int64)
            local[ln] = np.arange(len(ln))
            gp = _build(local[s[esel]].astype(np.int32),
                        local[d[esel]].astype(np.int32),
                        len(ln), len(ln), is_block=False)
            out.append(BigPartition(
                graph=gp, node_map64=uids[ln],
                edge_map64=self.edge_ids64[esel],
                inner_node=parts[ln] == p, part_id=p))
        return out

    def spatial_plan(self, k: int, method: str = "fennel", seed: int = 0,
                     hub_k: int = 0):
        """SpatialPlan over the compacted graph for multi-GPU training;
        pair with the BigPartition node_map64 to address features keyed
        by conceptual int64 ids (e.g. a distributed KVStore)."""
        from ..parallel.halo import build_spatial_plan
        g, uids = self.compact_graph()
        plan = build_spatial_plan(g, k, method=method, seed=seed,
                                  hub_k=hub_k)
        return plan, uids
