"""Spatial (graph-partitioned) multi-GPU message passing with a halo
exchange, as ``dgl_hack_tpu.parallel.halo``, over ``torch.distributed``.

The JAX module runs one controller over stacked ``(P, ...)`` plan arrays
under ``shard_map``.  The port runs one process per part: rank ``r`` holds
slice ``[r]`` of the same arrays on its own device
(``SpatialPlan.device_arrays(r, device)``) and calls the functions below
on it.  NCCL carries the collectives between cards, gloo on the CPU and
between ranks that share a card (``collectives.py``).

Design (the JAX module's): each rank owns one partition's dst nodes and
their features (row-sharded).  A host-built exchange plan lists, per (src
part -> dst part) pair, which owned rows must be shipped; ranks gather
their send rows, all_to_all them, and concatenate [own || halo] into an
extended feature table.  Because edges were assigned to their dst's
partition, every dst-side reduction (segment reduce, edge softmax
normalisation, degree clamps) is exact locally.  Every per-part array is
padded to the largest part, and padded edge slots carry ``mask`` False.

Each rank's edges are also split into local-src and remote-src sets, each
dst-sorted.  ``make_halo_gspmm`` reduces the local split from the resident
rows while the all_to_all is in flight (``overlap=True``: the collective
is issued with ``async_op=True``), then the remote split from the landed
halo.  Every split, and the rank's whole partition (``local_graph``), is a
masked block ``Graph`` built once per rank and cached in the rank's array
dict, so its real-edge view (one host sync) and K1's row plans are built
once, not once a step.  Sums go to K1, max/min to K4/K5, GAT to K2/K3, on
the card; their plain versions on the CPU.

The host part (``SpatialPlan``, ``build_spatial_plan``, the dense hub and
the shuffles) is the JAX module's numpy, copied, so that one graph, seed
and method give the same plan array for array.  The TPU plan machinery
that ``attach_spmm_plans`` wraps there is not ported: the port's kernels
read each graph's own CSC/CSR arrays.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.graph import Graph, _build
from ..ops.cuda.spmm_kernel import dense_count_matmul, prepare_spmm
from ..ops.spmm import gspmm
from . import collectives as coll

Tensor = torch.Tensor

# arrays stacked on axis 0 = part; rank r's slices by device_arrays(r)
_DEVICE_FIELDS = (
    # general local-graph layout (dst-sorted, padded to e_max)
    "src_ext", "dst_loc", "edge_mask", "csc_indptr",
    # overlap split layout (local-src then remote-src, each dst-sorted)
    "lsrc", "ldst", "lmask", "rsrc", "rdst", "rmask", "lcnt", "rcnt",
    # exchange plan + node bookkeeping
    "send_idx", "send_mask", "owned_ids", "owned_mask", "in_deg", "out_deg",
    # hub replication (all_gather'ed rows; zero-width when hub_k=0)
    "hub_idx", "hub_mask",
)
_ARRAY_FIELDS = _DEVICE_FIELDS + ("edge_uid", "luid", "ruid", "dense_C",
                                  "dense_rows", "dense_mask")
# the edge layouts whose block graphs a rank caches in its array dict
_LAYOUTS = {"graph": ("src_ext", "dst_loc", "edge_mask"),
            "local": ("lsrc", "ldst", "lmask"),
            "remote": ("rsrc", "rdst", "rmask")}


@dataclass
class SpatialPlan:
    """Host-built stacked per-part arrays (leading dim = num parts).

    n_owned_max / e_max / s_max are the padded per-part sizes; halo_max =
    num_parts * s_max is the receive-buffer size (recv row of node owned
    by part q at send slot j lives at n_owned_max + q*s_max + j in the
    extended index space).
    """
    num_parts: int
    n_owned_max: int          # owned rows per rank (padded)
    halo_max: int             # recv halo rows per rank (P * s_max)
    s_max: int                # send rows per (part, peer) pair (padded)
    e_max: int                # edges per rank (padded, general layout)
    el_max: int               # local-src edges per rank (padded)
    er_max: int               # remote-src edges per rank (padded)
    # general local-graph arrays:
    src_ext: np.ndarray       # (P, e_max) src index into [own || halo]
    dst_loc: np.ndarray       # (P, e_max) local dst row
    edge_mask: np.ndarray     # (P, e_max) bool
    csc_indptr: np.ndarray    # (P, n_owned_max+1)
    edge_uid: np.ndarray      # (P, e_max) original USER edge id (-1 pad)
    # overlap split arrays:
    lsrc: np.ndarray          # (P, el_max) OWN-row index
    ldst: np.ndarray          # (P, el_max)
    lmask: np.ndarray         # (P, el_max) bool
    luid: np.ndarray          # (P, el_max) user edge id (-1 pad)
    rsrc: np.ndarray          # (P, er_max) index into the HALO buffer
    rdst: np.ndarray          # (P, er_max)
    rmask: np.ndarray         # (P, er_max) bool
    ruid: np.ndarray          # (P, er_max) user edge id (-1 pad)
    lcnt: np.ndarray          # (P, n_owned_max) true local-src in-degree
    rcnt: np.ndarray          # (P, n_owned_max) true remote-src in-degree
    # exchange plan + node bookkeeping:
    send_idx: np.ndarray      # (P, P, s_max) rows of OWN x to send to peer q
    send_mask: np.ndarray     # (P, P, s_max) bool
    owned_ids: np.ndarray     # (P, n_owned_max) original node id (pad 0)
    owned_mask: np.ndarray    # (P, n_owned_max) bool
    in_deg: np.ndarray        # (P, n_owned_max) true in-degree
    out_deg: np.ndarray       # (P, n_owned_max) true GLOBAL out-degree
    # hub replication: own rows contributed to one all_gather; hub rows
    # land AFTER the pairwise halo in the extended index space
    hub_idx: np.ndarray       # (P, hk_max) own local rows that are hubs
    hub_mask: np.ndarray      # (P, hk_max) bool
    hk_max: int = 0           # hub rows contributed per part (padded)
    build_seconds: float = 0.0
    # layouts whose block graphs ``device_arrays`` builds and readies for
    # the kernels at once (``attach_spmm_plans``): "local", "remote",
    # "graph"
    spmm_attached: Tuple[str, ...] = ()
    # DISTRIBUTED dense-hub (build_spatial_plan dense_threshold=...):
    # hub DST rows are computed as column-sliced count-matrix matmuls —
    # each rank contributes C[:, own] @ x_own and ONE reduce_scatter
    # (~R*F*4 bytes) delivers every dense row to its owner.  Hub-dst
    # edges leave the halo entirely; ``reduced`` holds the exchange plan
    # over the remaining edges.
    reduced: Optional["SpatialPlan"] = None
    dense_C: Optional[np.ndarray] = None       # (P, P*R_max, n_owned_max)
    dense_rows: Optional[np.ndarray] = None    # (P, R_max) local dst rows
    dense_mask: Optional[np.ndarray] = None    # (P, R_max) bool
    dense_R_max: int = 0

    def device_arrays(self, rank: int, device="cuda") -> Dict[str, object]:
        """Rank ``rank``'s slice of every per-part array, as tensors on
        ``device`` (int32, bool, and the dense hub's float16 counts), under
        the JAX module's keys (the reduced plan's with an ``r2_`` prefix,
        the dense hub's as ``dC``, ``drows`` and ``dmask``).  The rank's
        block graphs are cached in the same dict at first use
        (``local_graph``, ``split_graph``); with ``attach_spmm_plans``
        they are built here, readied for the kernels."""
        def take(a):
            return torch.from_numpy(np.ascontiguousarray(a[rank])).to(device)

        out: Dict[str, object] = {k: take(getattr(self, k))
                                  for k in _DEVICE_FIELDS}
        if self.reduced is not None:
            for k in _DEVICE_FIELDS:
                out[f"r2_{k}"] = take(getattr(self.reduced, k))
            out["dC"] = take(self.dense_C)
            out["drows"] = take(self.dense_rows)
            out["dmask"] = take(self.dense_mask)
        prepare_rank(self, out, self.spmm_attached)
        return out

    def sizes(self) -> "SpatialPlan":
        """This plan without its per-part arrays: the sizes that the device
        side reads.  A rank handed these and its ``device_arrays`` needs
        nothing else of the plan."""
        kw = {k: None for k in _ARRAY_FIELDS}
        red = None if self.reduced is None else self.reduced.sizes()
        return dataclasses.replace(self, reduced=red, **kw)

    @property
    def num_src_ext(self) -> int:
        return self.n_owned_max + self.halo_max \
            + self.num_parts * self.hk_max

    def stats(self) -> Dict[str, float]:
        """Padding / communication accounting for the scaling harness."""
        E = int(self.edge_mask.sum())
        sent = int(self.send_mask.sum())
        return {
            "num_parts": self.num_parts,
            "edges_real": E,
            "edges_padded": self.num_parts * self.e_max,
            "edge_pad_factor": self.num_parts * self.e_max / max(E, 1),
            "halo_rows_real": sent,
            "halo_rows_padded": self.num_parts ** 2 * self.s_max,
            "halo_pad_factor": (self.num_parts ** 2 * self.s_max)
            / max(sent, 1),
            "cut_fraction": int(self.rmask.sum()) / max(E, 1),
            "hub_rows": int(self.hub_mask.sum()),
            "hub_rows_padded": self.num_parts * self.hk_max,
            "build_seconds": self.build_seconds,
        } | ({} if self.reduced is None else {
            # distributed dense-hub: the exchange that actually ships
            "dense_rows_total": int(self.dense_mask.sum()),
            "dense_edge_frac": round(
                1 - int(self.reduced.edge_mask.sum())
                / max(int(self.edge_mask.sum()), 1), 4),
            "cut_fraction_reduced":
                round(int(self.reduced.rmask.sum())
                      / max(int(self.edge_mask.sum()), 1), 4),
            "halo_rows_real_reduced": int(self.reduced.send_mask.sum()),
            "psum_rows": self.num_parts * self.dense_R_max,
        })


def build_spatial_plan(g: Graph, num_parts: int, method: str = "fennel",
                       seed: int = 0,
                       parts: Optional[np.ndarray] = None,
                       hub_k: int = 0,
                       dense_threshold: Optional[int] = None,
                       dense_budget: int = 4 << 30) -> SpatialPlan:
    """Partition g and derive the static exchange + local-graph plan (the
    JAX module's vectorised host build: one stable edge sort per layout
    plus flat scatters, O(E log E)).

    hub_k > 0 replicates up to ``hub_k`` hot SOURCE nodes: a node whose
    rows are demanded by >= 2 peer parts is broadcast once through one
    all_gather rather than shipped per pair (on power-law graphs hub rows
    dominate s_max, the PADDED per-pair send size).  Hub rows land after
    the pairwise halo in the extended index space; cut hub edges read
    them there.  ``dense_threshold`` adds the distributed dense hub
    (``_add_dense_hub``).
    """
    from ..partition.partition import partition as make_parts
    t0 = time.perf_counter()
    s, d = g.host_edges()
    n = g.num_nodes()
    E = len(s)
    if parts is None:
        parts = make_parts(g, num_parts, method=method, seed=seed)
    parts = np.asarray(parts, np.int64)
    P_ = num_parts

    # ---- nodes grouped by part (ascending original id within part)
    node_order = np.argsort(parts, kind="stable")
    nb = np.searchsorted(parts[node_order], np.arange(P_ + 1))
    owned_counts = np.diff(nb)
    n_owned_max = max(1, int(owned_counts.max()))
    local_of = np.empty(n, np.int64)
    local_of[node_order] = (np.arange(n, dtype=np.int64)
                            - np.repeat(nb[:-1], owned_counts))

    sl = s.astype(np.int64)
    dl = d.astype(np.int64)
    ep = parts[dl]                 # owning part per edge (dst side)
    sp = parts[sl]
    cut_e = sp != ep

    # ---- hub selection: sources demanded by the most peer parts
    is_hub = np.zeros(n, bool)
    if hub_k > 0 and cut_e.any():
        ec0 = np.nonzero(cut_e)[0]
        pk = ep[ec0] * np.int64(n) + sl[ec0]       # (dst part, src) pairs
        uk0 = np.unique(pk)
        peer_cnt = np.bincount((uk0 % n).astype(np.int64), minlength=n)
        cand = np.nonzero(peer_cnt >= 2)[0]
        if cand.size:
            top = cand[np.argsort(peer_cnt[cand])[::-1][:hub_k]]
            is_hub[top] = True

    hub_cut_e = cut_e & is_hub[sl]                 # read the hub section
    pair_cut_e = cut_e & ~is_hub[sl]               # pairwise halo

    # ---- hub table: each part contributes its owned hubs (ascending id)
    hub_nodes = np.nonzero(is_hub)[0]
    if hub_nodes.size:
        horder = np.argsort(parts[hub_nodes] * np.int64(n) + hub_nodes,
                            kind="stable")
        hub_nodes = hub_nodes[horder]
        hq = parts[hub_nodes]
        hbou = np.searchsorted(hq, np.arange(P_ + 1))
        hcnts = np.diff(hbou)
        hk_max = max(1, int(hcnts.max()))
        hslot = (np.arange(len(hub_nodes), dtype=np.int64)
                 - np.repeat(hbou[:-1], hcnts))
        hub_idx = np.zeros((P_, hk_max), np.int32)
        hub_mask = np.zeros((P_, hk_max), bool)
        hub_idx.reshape(-1)[hq * hk_max + hslot] = local_of[hub_nodes]
        hub_mask.reshape(-1)[hq * hk_max + hslot] = True
        # global hub ext offset (within the hub section) per hub node
        hub_off = np.full(n, -1, np.int64)
        hub_off[hub_nodes] = hq * hk_max + hslot
    else:
        hk_max = 0
        hub_idx = np.zeros((P_, 0), np.int32)
        hub_mask = np.zeros((P_, 0), bool)
        hub_off = None

    # ---- pairwise halo: unique (dst part, src node) over non-hub cut
    ec = np.nonzero(pair_cut_e)[0]
    pair_key = ep[ec] * np.int64(n) + sl[ec]
    uk = np.unique(pair_key)                        # sorted by (p, u)
    pu = (uk % n).astype(np.int64)                  # halo node original id
    pp = (uk // n).astype(np.int64)                 # dst part
    pq = parts[pu]                                  # owning (src) part
    # group by (q, p), ascending u within the pair
    order2 = np.argsort((pq * P_ + pp) * np.int64(n + 1) + pu,
                        kind="stable")
    grp_s = (pq * P_ + pp)[order2]
    gb = np.searchsorted(grp_s, np.arange(P_ * P_ + 1))
    cnts = np.diff(gb)
    s_max = max(1, int(cnts.max()) if cnts.size else 0)
    slot_s = (np.arange(len(uk), dtype=np.int64)
              - np.repeat(gb[:-1], cnts))
    send_idx = np.zeros((P_, P_, s_max), np.int32)
    send_mask = np.zeros((P_, P_, s_max), bool)
    send_idx.reshape(-1)[grp_s * s_max + slot_s] = \
        local_of[pu[order2]].astype(np.int32)
    send_mask.reshape(-1)[grp_s * s_max + slot_s] = True
    # ext index (per unique pair, in uk order) for edge lookup
    halo_ext_uk = np.empty(len(uk), np.int64)
    halo_ext_uk[order2] = n_owned_max + pq[order2] * s_max + slot_s
    halo_max = P_ * s_max

    # ---- per-edge extended src index
    ext_src_e = np.empty(E, np.int64)
    loc_e = ~cut_e
    ext_src_e[loc_e] = local_of[sl[loc_e]]
    if ec.size:
        ext_src_e[ec] = halo_ext_uk[np.searchsorted(uk, pair_key)]
    if hub_off is not None:
        eh = np.nonzero(hub_cut_e)[0]
        ext_src_e[eh] = n_owned_max + halo_max + hub_off[sl[eh]]

    ld = local_of[dl]                               # local dst per edge

    def _layout(sel_mask, width_pad, src_vals):
        """Scatter the selected edges into (P_, W) padded dst-sorted rows.
        Returns (srcA, dstA, maskA, uidA, cntA, W)."""
        esel = np.nonzero(sel_mask)[0]
        if esel.size:
            order = np.argsort(ep[esel] * np.int64(n_owned_max + 1)
                               + ld[esel], kind="stable")
            esel = esel[order]
        ebou = np.searchsorted(ep[esel], np.arange(P_ + 1))
        ecnts = np.diff(ebou)
        W = max(1, int(ecnts.max()) if ecnts.size else 0)
        if width_pad is not None:
            W = width_pad
        pos = (np.arange(len(esel), dtype=np.int64)
               - np.repeat(ebou[:-1], ecnts))
        flat = ep[esel] * W + pos
        srcA = np.zeros((P_, W), np.int32)
        dstA = np.full((P_, W), max(n_owned_max - 1, 0), np.int32)
        maskA = np.zeros((P_, W), bool)
        uidA = np.full((P_, W), -1, np.int32)
        srcA.reshape(-1)[flat] = src_vals[esel].astype(np.int32)
        dstA.reshape(-1)[flat] = ld[esel].astype(np.int32)
        maskA.reshape(-1)[flat] = True
        uidA.reshape(-1)[flat] = esel.astype(np.int32)
        cnt = np.bincount(ep[esel] * np.int64(n_owned_max) + ld[esel],
                          minlength=P_ * n_owned_max
                          ).reshape(P_, n_owned_max).astype(np.int32)
        return srcA, dstA, maskA, uidA, cnt, W

    all_mask = np.ones(E, bool)
    src_ext, dst_loc, edge_mask, edge_uid, in_deg_a, e_max = \
        _layout(all_mask, None, ext_src_e)
    lsrc, ldst, lmask, luid, lcnt, el_max = _layout(loc_e, None, ext_src_e)
    # remote split reads the EXCHANGE buffer: [pairwise halo || hub rows]
    rext = ext_src_e - n_owned_max
    rsrc, rdst, rmask, ruid, rcnt, er_max = _layout(cut_e, None, rext)

    # csc_indptr over the PADDED rows (pad edges count in the last row so
    # indptr[-1] == e_max, as Graph requires; edge_mask zeroes them out)
    cnt_full = np.bincount(
        (np.arange(P_, dtype=np.int64)[:, None] * n_owned_max
         + dst_loc).reshape(-1),
        minlength=P_ * n_owned_max).reshape(P_, n_owned_max)
    csc_indptr = np.zeros((P_, n_owned_max + 1), np.int32)
    np.cumsum(cnt_full, axis=1, out=csc_indptr[:, 1:])

    # ---- node bookkeeping
    owned_ids = np.zeros((P_, n_owned_max), np.int32)
    owned_mask = np.zeros((P_, n_owned_max), bool)
    out_deg = np.zeros((P_, n_owned_max), np.int32)
    flat_n = parts[node_order] * n_owned_max + local_of[node_order]
    owned_ids.reshape(-1)[flat_n] = node_order.astype(np.int32)
    owned_mask.reshape(-1)[flat_n] = True
    global_out_deg = np.bincount(sl, minlength=n)
    out_deg.reshape(-1)[flat_n] = \
        global_out_deg[node_order].astype(np.int32)

    plan = SpatialPlan(P_, n_owned_max, halo_max, s_max, e_max, el_max,
                       er_max, src_ext, dst_loc, edge_mask, csc_indptr,
                       edge_uid, lsrc, ldst, lmask, luid, rsrc, rdst,
                       rmask, ruid, lcnt, rcnt, send_idx, send_mask,
                       owned_ids, owned_mask, in_deg_a, out_deg,
                       hub_idx, hub_mask, hk_max,
                       time.perf_counter() - t0)
    if dense_threshold is not None:
        plan = _add_dense_hub(plan, parts, local_of, sl, dl,
                              dense_threshold, dense_budget, hub_k)
    return plan


def _add_dense_hub(plan: SpatialPlan, parts: np.ndarray,
                   local_of: np.ndarray, sl: np.ndarray, dl: np.ndarray,
                   thr: int, budget: int, hub_k: int) -> SpatialPlan:
    """Distributed dense-hub construction: hot DST rows become
    column-sliced count matrices.  Rank p holds C[:, own_p] (float16
    counts) and contributes ``C_p @ x_p``; one reduce_scatter sums the
    partials and lands each dense row on its owner — hub-dst edges ship
    ZERO halo rows.  ``reduced`` re-runs the exchange build on the
    remaining edges (same node->part assignment, so local ids match)."""
    P_ = plan.num_parts
    n = len(parts)
    indeg = np.bincount(dl, minlength=n)
    cap = max(1, int(budget // (2 * max(plan.n_owned_max, 1))))
    cand = np.nonzero(indeg >= thr)[0]
    if cand.size == 0:
        return plan
    dense_nodes = cand[np.argsort(indeg[cand])[::-1][:cap]]
    is_dense = np.zeros(n, bool)
    is_dense[dense_nodes] = True
    order = np.argsort(parts[dense_nodes] * np.int64(n) + dense_nodes,
                       kind="stable")
    dn = dense_nodes[order]
    dp = parts[dn]
    bou = np.searchsorted(dp, np.arange(P_ + 1))
    cnts = np.diff(bou)
    R_max = max(1, int(cnts.max()))
    slot = (np.arange(len(dn), dtype=np.int64)
            - np.repeat(bou[:-1], cnts))
    drows = np.zeros((P_, R_max), np.int32)
    dmask = np.zeros((P_, R_max), bool)
    drows.reshape(-1)[dp * R_max + slot] = local_of[dn].astype(np.int32)
    dmask.reshape(-1)[dp * R_max + slot] = True
    grow = np.full(n, -1, np.int64)        # node -> global padded C row
    grow[dn] = dp * R_max + slot

    de = is_dense[dl]
    es = np.nonzero(de)[0]
    sp_e = parts[sl[es]]
    now = plan.n_owned_max
    C = np.zeros((P_, P_ * R_max, now), np.float16)
    key = ((sp_e * np.int64(P_ * R_max) + grow[dl[es]]) * np.int64(now)
           + local_of[sl[es]])
    uk, ucnt = np.unique(key, return_counts=True)
    # float16 holds ints exactly to 2048; clip beyond (multigraph safety)
    C.reshape(-1)[uk] = np.minimum(ucnt, 2048).astype(np.float16)

    keep = ~de
    g2 = _build(sl[keep].astype(np.int32), dl[keep].astype(np.int32),
                n, n, is_block=False, build_csr=False)
    red = build_spatial_plan(g2, P_, parts=parts, hub_k=hub_k)
    return dataclasses.replace(plan, reduced=red, dense_C=C,
                               dense_rows=drows, dense_mask=dmask,
                               dense_R_max=R_max)


def attach_spmm_plans(plan: SpatialPlan, tr: int = 128, te: int = 64,
                      flat_width: int = 128, bucket_rows="auto",
                      bucket_rows_rev=None, bucket_rows_graph=None,
                      which: Tuple[str, ...] = ("local", "remote",
                                                "graph")) -> SpatialPlan:
    """The plan with its kernel plans attached: ``device_arrays`` then
    builds each rank's block graphs of the layouts in ``which`` ('local'
    and 'remote' for ``make_halo_gspmm``'s splits, over the reduced plan
    where the dense hub is on; 'graph' for ``local_graph``) and readies
    them for the kernels (``prepare_spmm``: the real-edge view and K1's
    row plans of both directions), once.  tr, te, flat_width and the
    bucket knobs are the TPU plan's tiling, accepted and ignored, as
    ``prepare_spmm`` ignores them: the port's kernels read each graph's
    own CSC/CSR arrays."""
    for w in which:
        if w not in _LAYOUTS:
            raise ValueError(f"unknown layout {w!r}")
    return dataclasses.replace(plan, spmm_attached=tuple(which))


# ---------------------------------------------------------------------------
# host-side shuffles
# ---------------------------------------------------------------------------
def shard_features(plan: SpatialPlan, x: np.ndarray) -> np.ndarray:
    """(N, ...) global features -> (P, n_owned_max, ...) stacked shards."""
    out = np.zeros((plan.num_parts, plan.n_owned_max) + x.shape[1:],
                   x.dtype)
    for p in range(plan.num_parts):
        m = plan.owned_mask[p]
        out[p, m] = x[plan.owned_ids[p, m]]
    return out


def unshard_rows(plan: SpatialPlan, xs: np.ndarray, n: int) -> np.ndarray:
    """(P, n_owned_max, ...) -> (N, ...) global order."""
    out = np.zeros((n,) + xs.shape[2:], xs.dtype)
    for p in range(plan.num_parts):
        m = plan.owned_mask[p]
        out[plan.owned_ids[p, m]] = xs[p, m]
    return out


def shard_edata(plan: SpatialPlan, w: np.ndarray, fill=0,
                layout: str = "graph") -> np.ndarray:
    """Per-edge USER-order array -> stacked plan-order array.

    layout='graph' -> (P, e_max) matching the local graph's edge order;
    layout='split' -> ((P, el_max), (P, er_max)) for the overlap gspmm.
    """
    w = np.asarray(w)

    def take(uid):
        out = np.full(uid.shape + w.shape[1:], fill, w.dtype)
        m = uid >= 0
        out[m] = w[uid[m]]
        return out

    if layout == "graph":
        return take(plan.edge_uid)
    if layout == "split":
        return take(plan.luid), take(plan.ruid)
    raise ValueError(layout)


# ---------------------------------------------------------------------------
# device-side building blocks (one rank: the leading part dim is gone)
# ---------------------------------------------------------------------------
def _block(src: Tensor, dst: Tensor, mask: Tensor, num_src: int,
           num_dst: int) -> Graph:
    """A masked block graph over plan-ordered edges (dst-sorted, padded
    slots last with dst = num_dst - 1), with its CSC and CSR arrays built
    by torch ops on the edges' device."""
    dev = src.device
    counts = torch.bincount(dst.long(), minlength=num_dst)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    csc = torch.cat([zero, torch.cumsum(counts, 0)]).to(torch.int32)
    csr_eids = torch.sort(src.long(), stable=True).indices.to(torch.int32)
    out_counts = torch.bincount(src.long(), minlength=num_src)
    csr = torch.cat([zero, torch.cumsum(out_counts, 0)]).to(torch.int32)
    return Graph(num_src=num_src, num_dst=num_dst, src=src, dst=dst,
                 csc_indptr=csc, csr_indptr=csr, csr_eids=csr_eids,
                 edge_mask=mask, is_block=True)


def split_graph(plan: SpatialPlan, dev1: Dict[str, object], layout: str,
                prefix: str = "") -> Graph:
    """The rank's block graph of one edge layout of ``plan`` ('graph':
    the whole partition over [own || halo || hubs]; 'local': local-src
    edges over the own rows; 'remote': remote-src edges over the exchange
    buffer), cached in ``dev1`` under ``<prefix>g_<layout>``.  ``prefix``
    is ``r2_`` for the reduced plan of the dense hub."""
    key = f"{prefix}g_{layout}"
    g = dev1.get(key)
    if g is None:
        s, d, m = (dev1[prefix + k] for k in _LAYOUTS[layout])
        n_src = {"graph": plan.num_src_ext, "local": plan.n_owned_max,
                 "remote": max(plan.halo_max
                               + plan.num_parts * plan.hk_max, 1)}[layout]
        g = _block(s, d, m, n_src, plan.n_owned_max)
        dev1[key] = g
    return g


def prepare_rank(plan: SpatialPlan, dev1: Dict[str, object],
                 which: Tuple[str, ...] = ("local", "remote", "graph")
                 ) -> None:
    """Build the rank's block graphs of the layouts in ``which`` (the
    splits over the reduced plan where the dense hub is on) into ``dev1``
    and ready each for the kernels (``prepare_spmm``: its real-edge view
    and K1's row plans of both directions).  ``device_arrays`` calls it
    for the layouts ``attach_spmm_plans`` named; a rank handed its arrays
    some other way calls it itself."""
    for layout in which:
        tgt = plan.reduced if (plan.reduced is not None
                               and layout != "graph") else plan
        pre = "r2_" if tgt is not plan else ""
        prepare_spmm(split_graph(tgt, dev1, layout, pre), dense_hub=False)


def halo_exchange(x: Tensor, send_idx: Tensor, send_mask: Tensor,
                  group=None, hub_idx: Optional[Tensor] = None,
                  hub_mask: Optional[Tensor] = None,
                  comm_dtype: Optional[torch.dtype] = None,
                  async_op: bool = False):
    """Gather send rows, all_to_all them, return the (halo_max, ...)
    receive buffer; autograd sends the cotangent back the reverse way.
    With hub arrays, each rank also contributes its owned hub rows to one
    all_gather, appended: [pairwise halo || hub rows] (its backward is a
    reduce_scatter).  ``comm_dtype=torch.bfloat16`` ships the rows at half
    width and casts them back to x's dtype on landing (the cast's backward
    casts the returning cotangent too).  ``async_op=True`` returns an
    object whose ``wait()`` gives the buffer, the all_to_all in flight
    until then (the hub rows are gathered at the wait)."""
    shape = send_mask.shape + (1,) * (x.dim() - 1)
    sends = x[send_idx.long()] * send_mask.reshape(shape).to(x.dtype)
    wire = sends if comm_dtype is None else sends.to(comm_dtype)
    pending = coll.all_to_all(wire, group, async_op=True)
    ex = _Exchange(pending, x, group, hub_idx, hub_mask, comm_dtype)
    return ex if async_op else ex.wait()


class _Exchange:
    """A halo exchange in flight (``halo_exchange(..., async_op=True)``)."""

    def __init__(self, pending, x, group, hub_idx, hub_mask, comm_dtype):
        self.pending, self.x, self.group = pending, x, group
        self.hub_idx, self.hub_mask = hub_idx, hub_mask
        self.comm_dtype = comm_dtype

    def wait(self) -> Tensor:
        x = self.x
        halo = self.pending.wait()
        halo = halo.reshape((-1,) + tuple(x.shape[1:])).to(x.dtype)
        if self.hub_idx is not None and self.hub_idx.shape[-1] > 0:
            shape = self.hub_mask.shape + (1,) * (x.dim() - 1)
            contrib = x[self.hub_idx.long()] \
                * self.hub_mask.reshape(shape).to(x.dtype)
            if self.comm_dtype is not None:
                contrib = contrib.to(self.comm_dtype)
            hub = coll.all_gather(contrib, self.group)
            halo = torch.cat([halo, hub.to(x.dtype)], 0)
        return halo


def extend(x: Tensor, halo: Tensor) -> Tensor:
    """[own || halo] extended feature table for the local graph."""
    return torch.cat([x, halo], 0)


def local_graph(plan: SpatialPlan, dev1: Dict[str, object]) -> Graph:
    """This rank's partition as a masked block ``Graph`` over the extended
    [own || halo] index space (num_src = ``plan.num_src_ext``, num_dst =
    ``plan.n_owned_max``): every op of the package works on it.  Built
    once and cached in ``dev1``, so that its real-edge view and row plans
    are built once."""
    return split_graph(plan, dev1, "graph")


def _exchange_fn(plan: SpatialPlan, dev1, group, comm_dtype, prefix=""):
    def exchange(h: Tensor, async_op: bool = False):
        return halo_exchange(h, dev1[prefix + "send_idx"],
                             dev1[prefix + "send_mask"], group,
                             dev1.get(prefix + "hub_idx"),
                             dev1.get(prefix + "hub_mask"), comm_dtype,
                             async_op)
    return exchange


# ---------------------------------------------------------------------------
# general wrapper: run ANY per-partition function on the rank
# ---------------------------------------------------------------------------
def make_spatial_apply(plan: SpatialPlan, mesh, fn: Callable,
                       axis: str = "node", n_extra: int = 0,
                       extra_specs: Optional[Tuple] = None,
                       comm_dtype: Optional[torch.dtype] = None):
    """Wrap ``fn(params, g_local, exchange, x, *extras)`` into
    ``apply(params, x, dev, *extras)`` on this rank.

    * ``g_local`` is this rank's partition Graph (extended src space);
    * ``exchange(h)`` returns the (halo_max, ...) halo rows of any
      (n_owned_max, ...) owned-row array — call it once per layer and
      ``extend(h, exchange(h))`` to build the layer's src table;
    * extras are the rank's slices of stacked (P, ...) arrays (etypes,
      masks, labels...);
    * params are replicated: ``spatial_train_step`` sums their gradients
      over the ranks.
    ``mesh`` is a process group, a ``DeviceMesh`` (its ``axis``
    dimension) or None (the default group); ``n_extra`` and
    ``extra_specs`` are accepted for the JAX signature: a rank's extras
    are its own slices whatever their spec."""
    group = coll.group_of(mesh, axis)

    def apply(params, x: Tensor, dev: Dict[str, object], *extras):
        g = local_graph(plan, dev)
        return fn(params, g, _exchange_fn(plan, dev, group, comm_dtype), x,
                  *extras)

    return apply


# ---------------------------------------------------------------------------
# overlap-split gspmm fast path
# ---------------------------------------------------------------------------
def _reduce(g: Graph, base: str, table: Tensor, w: Optional[Tensor]):
    if w is None:
        return gspmm(g, "copy_lhs", base, table)
    w = w.reshape(w.shape + (1,) * (table.dim() - w.dim()))
    return gspmm(g, "mul", base, table, w, "u", "e")


def _combine(base: str, out_l: Tensor, out_r: Tensor, lcnt: Tensor,
             rcnt: Tensor) -> Tensor:
    """Join the two splits' partial reductions: a sum adds them; max/min
    take the extremum where both sides have edges, else the side that
    has (gspmm zero-fills empty rows, and 0 would win over all-negative
    maxima)."""
    if base == "sum":
        return out_l + out_r
    n = out_l.shape[0]
    lc = lcnt.reshape((n,) + (1,) * (out_l.dim() - 1)) > 0
    rc = rcnt.reshape((n,) + (1,) * (out_r.dim() - 1)) > 0
    comb = torch.maximum if base == "max" else torch.minimum
    return torch.where(lc & rc, comb(out_l, out_r),
                       torch.where(lc, out_l, torch.where(
                           rc, out_r, torch.zeros_like(out_l))))


def _mean_div(out: Tensor, in_deg: Tensor) -> Tensor:
    deg = in_deg.clamp(min=1).to(out.dtype)
    return out / deg.reshape((out.shape[0],) + (1,) * (out.dim() - 1))


def make_halo_gspmm(plan: SpatialPlan, mesh=None, axis: str = "node",
                    reduce_op: str = "sum", weighted: bool = False,
                    overlap: bool = True,
                    comm_dtype: Optional[torch.dtype] = None):
    """Returns f(x, dev[, w_local, w_remote]) -> out: this rank's
    halo-exchange aggregation (copy_u or u_mul_e x sum/mean/max/min) of
    its owned rows x (n_owned_max, ...), ``dev`` its ``device_arrays``.

    Each split is a masked block graph of its own through ``gspmm``: the
    local split reads the own rows, the remote split the exchange buffer.
    With ``overlap=True`` the all_to_all is issued with ``async_op=True``,
    the local split reduces, then the rank waits and reduces the remote
    split; the partials combine exactly (max/min with the identity fill of
    ``_combine``).  ``overlap=False`` waits for the exchange before the
    local split reduces.
    ``weighted`` adds per-edge weights in SPLIT plan order
    (``shard_edata(..., layout="split")``).  Mean divides the sum by the
    true in-degree.  With the plan's dense hub (unweighted sum/mean), the
    rows of the reduced plan go through its own exchange and splits and
    the hub rows through the rank's columns of C (``dense_count_matmul``)
    and one reduce_scatter, added at ``drows``."""
    if reduce_op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reducer {reduce_op!r}")
    group = coll.group_of(mesh, axis)
    base = "sum" if reduce_op == "mean" else reduce_op

    def splits(rp, d, x, w_l, w_r, prefix):
        ex = _exchange_fn(rp, d, group, comm_dtype, prefix)(
            x, async_op=True)
        if not overlap:
            halo = ex.wait()
        out_l = _reduce(split_graph(rp, d, "local", prefix), base, x, w_l)
        if overlap:
            halo = ex.wait()
        out_r = _reduce(split_graph(rp, d, "remote", prefix), base, halo,
                        w_r)
        return _combine(base, out_l, out_r, d[prefix + "lcnt"],
                        d[prefix + "rcnt"])

    def apply(x: Tensor, dev: Dict[str, object],
              w_l: Optional[Tensor] = None,
              w_r: Optional[Tensor] = None) -> Tensor:
        if weighted != (w_l is not None):
            raise ValueError("weighted halo gspmm takes (w_local, "
                             "w_remote), an unweighted one neither")
        if plan.reduced is not None and w_l is None and base == "sum":
            out = splits(plan.reduced, dev, x, None, None, "r2_")
            partial = dense_count_matmul(dev["dC"], x.reshape(x.shape[0],
                                                              -1))
            mine = coll.reduce_scatter(partial, group)
            mine = mine * dev["dmask"][:, None].to(mine.dtype)
            out = out.index_add(0, dev["drows"].long(),
                                mine.to(out.dtype).reshape(
                                    (-1,) + tuple(out.shape[1:])))
        else:
            out = splits(plan, dev, x, w_l, w_r, "")
        if reduce_op == "mean":
            out = _mean_div(out, dev["in_deg"])
        return out

    return apply


# ---------------------------------------------------------------------------
# distributed models
# ---------------------------------------------------------------------------
def make_spatial_gcn(plan: SpatialPlan, mesh=None, hidden: int = 16,
                     out_feats: int = 2, axis: str = "node"):
    """Distributed 2-layer GCN over a spatial partition: (init, forward).

    ``init(seed, in_feats, device="cuda")`` returns the raw parameters
    {W1 (in, hidden), b1, W2 (hidden, out), b2}, glorot-uniform from a
    ``torch.Generator`` seeded with ``seed`` (the JAX function draws them
    with ``jax.random``, which the port cannot draw:
    ``interop.spatial_params_from_jax`` carries JAX's across);
    ``forward(params, x, dev)`` -> this rank's logits (n_owned_max, out).
    Each layer's halo all_to_all overlaps the local-edge reduce; the dense
    matmuls run on the rank's rows (GraphConv norm='both' with the
    global out-degrees and true in-degrees)."""
    halo = make_halo_gspmm(plan, mesh, axis=axis, reduce_op="sum",
                           overlap=True)

    def init(seed: int, in_feats: int, device="cuda") -> Dict[str, Tensor]:
        gen = torch.Generator().manual_seed(seed)
        s1 = (6.0 / (in_feats + hidden)) ** 0.5
        s2 = (6.0 / (hidden + out_feats)) ** 0.5
        p = {"W1": torch.empty(in_feats, hidden).uniform_(-s1, s1,
                                                           generator=gen),
             "b1": torch.zeros(hidden),
             "W2": torch.empty(hidden, out_feats).uniform_(-s2, s2,
                                                            generator=gen),
             "b2": torch.zeros(out_feats)}
        return {k: v.to(device).requires_grad_(True) for k, v in p.items()}

    def layer(x, dev, W, b):
        dout = dev["out_deg"].to(x.dtype).clamp(min=1.0)
        din = dev["in_deg"].to(x.dtype).clamp(min=1.0)
        h = x * torch.rsqrt(dout)[:, None]
        if h.shape[-1] > W.shape[1]:
            h = halo(h @ W, dev)
        else:
            h = halo(h, dev) @ W
        return h * torch.rsqrt(din)[:, None] + b

    def forward(params, x: Tensor, dev) -> Tensor:
        h = F.relu(layer(x, dev, params["W1"], params["b1"]))
        return layer(h, dev, params["W2"], params["b2"])

    return init, forward


class SpatialPair(nn.Module):
    """The two layers ``l1`` and ``l2`` of a spatial model (the JAX
    function's ``{"l1": ..., "l2": ...}`` params)."""

    def __init__(self, l1: nn.Module, l2: nn.Module):
        super().__init__()
        self.l1, self.l2 = l1, l2


def seeded(seed: int):
    """A context in which torch's CPU generator is seeded with ``seed``
    and restored after: layers built and materialised inside it on the
    CPU take the same initial values on every rank."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            yield
    return ctx()


def _init_pair(make: Callable[[], SpatialPair], seed: int, feats1, feats2,
               device) -> SpatialPair:
    """Build the pair with ``make`` and materialise its lazy layers at the
    first call's shapes, under ``seeded(seed)`` on the CPU, then move it to
    ``device``."""
    with seeded(seed):
        model = make()
        model.l1.initialize_parameters(None, *feats1)
        model.l2.initialize_parameters(None, *feats2)
    return model.to(device)


def make_spatial_gat(plan: SpatialPlan, mesh=None, hidden: int = 8,
                     out_feats: int = 2, heads: Tuple[int, int] = (4, 1),
                     negative_slope: float = 0.2, axis: str = "node",
                     comm_dtype: Optional[torch.dtype] = None):
    """Distributed 2-layer GAT: per-layer halo exchange of the raw
    activations, then the port's ``GATConv`` on (src, dst) features over
    the rank's partition graph, so the edge phase is exact locally
    (dst-sharding) and runs K2/K3 through the graph's real-edge view on
    the card.  (init, apply): ``init(seed, in_feats, device)`` returns a
    ``SpatialPair`` of two GATConvs, ``apply(model, x, dev)`` the rank's
    (n_owned_max, out) head-mean logits."""
    from ..nn import GATConv

    def fn(model, g, exchange, x):
        h = model.l1(g, (extend(x, exchange(x)), x))
        h = F.elu(h).reshape(x.shape[0], -1)
        h = model.l2(g, (extend(h, exchange(h)), h))
        return h.mean(1)                          # head-mean output layer

    apply = make_spatial_apply(plan, mesh, fn, axis, comm_dtype=comm_dtype)

    def init(seed: int, in_feats: int, device="cuda") -> SpatialPair:
        def make():
            return SpatialPair(
                GATConv(hidden, heads[0], negative_slope=negative_slope),
                GATConv(out_feats, heads[1], negative_slope=negative_slope))
        x0 = torch.zeros(1, in_feats)
        h0 = torch.zeros(1, hidden * heads[0])
        return _init_pair(make, seed, ((x0, x0),), ((h0, h0),), device)

    return init, apply


def make_spatial_rgcn(plan: SpatialPlan, mesh=None, hidden: int = 8,
                      out_feats: int = 2, num_rels: int = 1,
                      num_bases: Optional[int] = None, axis: str = "node",
                      comm_dtype: Optional[torch.dtype] = None):
    """Distributed 2-layer R-GCN: per-edge relation types ride the plan
    (``shard_edata(plan, etypes)``, the rank's (e_max,) slice), messages
    are composed on the extended feature table and summed per dst over
    the partition graph (K1's edge-row mode on the card).  (init, apply):
    ``apply(model, x, dev, etypes)`` -> (n_owned_max, out)."""
    from ..nn import RelGraphConv

    def fn(model, g, exchange, x, etypes):
        h = F.relu(model.l1(g, extend(x, exchange(x)), etypes))
        return model.l2(g, extend(h, exchange(h)), etypes)

    apply = make_spatial_apply(plan, mesh, fn, axis, n_extra=1,
                               comm_dtype=comm_dtype)

    def init(seed: int, in_feats: int, device="cuda") -> SpatialPair:
        def make():
            return SpatialPair(
                RelGraphConv(hidden, num_rels, num_bases=num_bases),
                RelGraphConv(out_feats, num_rels, num_bases=num_bases))
        return _init_pair(make, seed, (torch.zeros(1, in_feats),),
                          (torch.zeros(1, hidden),), device)

    return init, apply


def _parameters(params):
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params.values())


def spatial_train_step(forward, tx, n_extra: int = 0, mesh=None,
                       axis: str = "node"):
    """Masked-CE train step on this rank's shard: ``step(params, x, dev,
    labels, mask, *extras) -> loss``, ``params`` updated in place by ``tx``
    (a ``torch.optim`` optimizer over them, the same on every rank).

    The loss is the JAX step's global masked mean over all parts: each
    rank takes sum(nll * m) over its rows divided by the all-reduced count
    of masked rows, the ranks' gradients are summed (one all_reduce), and
    every rank takes the same optimizer step, so the parameters stay equal
    on every rank.  Returns the global loss (all-reduced) as a 0-d
    tensor.  ``n_extra`` is the JAX signature's: extras are passed on."""
    group = coll.group_of(mesh, axis)

    def step(params, x, dev, labels, mask, *extras):
        tx.zero_grad(set_to_none=True)
        logits = forward(params, x, dev, *extras)
        logp = F.log_softmax(logits, -1)
        nll = -logp.gather(-1, labels[:, None].long())[:, 0]
        m = mask.to(logits.dtype)
        count = coll.all_reduce_sum(m.sum(), group).clamp(min=1.0)
        loss = (nll * m).sum() / count
        loss.backward()
        coll.all_reduce_grads(_parameters(params), group)
        tx.step()
        return coll.all_reduce_sum(loss, group)

    return step
