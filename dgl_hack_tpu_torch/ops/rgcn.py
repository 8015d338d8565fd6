"""Relational (per-etype) aggregation over (dst, etype) pairs, as
``dgl_hack_tpu.ops.rgcn``.

The edges are relabeled to (dst, etype) PAIRS, dense ids sorted by (dst,
etype), a stable refinement of the internal CSC order.  Then:

1. first level: ``agg[m] = sum_{e in pair m} norm_e * x[src_e]``, a copy_u
   (or u_mul_e) sum over the pair graph (src -> pair): K1's CSC forward on
   the card, and K1 over the pair graph's CSR rows for dx;
2. projection: ``msg[m] = agg[m] @ W[etype_m]`` in torch, over chunks
   of the pairs, each gathering its pairs' (in, out) weights; the weight
   gradient sums the pairs' outer products per relation through K1's
   edge-row mode, over the pairs grouped by relation
   (``RelationProjection``);
3. second level: ``out[v] = sum_{pairs of v} msg[m]``: the pairs are
   dst-sorted, so each dst's pairs are one run of rows, which K1 sums in
   edge-row mode (``segment_sum_rows``).

Per edge this gathers one narrow (in-width) row of x.  The plan is built
on the host with numpy, as in the JAX package; its index arrays are the
kernels' plan, so the TPU plan knobs are accepted and ignored.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.graph import Graph, _build
from .cuda.spmm_kernel import Segments, prepare_spmm, segment_sum, \
    segment_sum_rows, segments
from .spmm import gspmm

Tensor = torch.Tensor

# The projection gathers each pair's (in, out) weight; it holds at most
# this many gathered elements at a time (1 GiB of float32).
PROJ_CHUNK_ELEMS = 1 << 28

# prepare_rgcn's keywords for the JAX package's TPU plan: accepted and
# ignored, as prepare_spmm does
TPU_PLAN_KNOBS = ("tr", "te", "bucket_rows", "bucket_rows_rev", "flat",
                  "flat_width")


class RgcnPlan(NamedTuple):
    """Host-built relabeling for the two-level relational aggregation.

    pair_graph:   Graph src -> pair id (num_dst = M), dst-sorted, with its
                  CSR; readied for the kernels by ``prepare_spmm``
    pair_dst:     (M,) int32 destination node of each pair (non-decreasing)
    pair_etype:   (M,) int32 relation of each pair
    edge_perm:    (E_real,) int32 pair-graph edge position -> internal edge
                  id of the original graph (for permuting per-edge norms)
    num_pairs:    M
    dst_segments: the pairs of each dst node as runs of rows (K1's
                  edge-row mode for the second level), over the original
                  graph's ``num_dst`` nodes
    rel_order:    (M,) int64 pair ids stably sorted by relation
    rel_indptr:   (R + 1,) int64 offsets of each relation's run in
                  ``rel_order`` (the projection's weight gradient)
    """
    pair_graph: Graph
    pair_dst: Tensor
    pair_etype: Tensor
    edge_perm: Tensor
    num_pairs: int
    dst_segments: Segments
    rel_order: Tensor
    rel_indptr: Tensor


def prepare_rgcn(g, etypes, num_rels: int, prepare: bool = True,
                 device=None, **prepare_kwargs) -> RgcnPlan:
    """Build the (dst, etype)-pair relabeling (host-side, once per graph).

    ``etypes`` is per-edge in USER (eid) order; masked (padded) edges are
    left out, so the plan is mask-aware.  The plan's tensors land on
    ``device`` (the graph's when None); with ``prepare`` the pair graph's
    CSC and CSR arrays and row plans are readied there
    (``prepare_spmm``), else they are built at first use.
    ``prepare_kwargs`` are the JAX package's TPU plan knobs
    (``TPU_PLAN_KNOBS``), accepted and ignored."""
    unknown = set(prepare_kwargs) - set(TPU_PLAN_KNOBS)
    if unknown:
        raise TypeError(f"prepare_rgcn: unexpected keywords {sorted(unknown)}")
    device = g.device if device is None else torch.device(device)
    et = np.asarray(torch.as_tensor(etypes).cpu(), np.int64)
    if g.int2user is not None:
        et = et[g.host("int2user")]          # internal (CSC) edge order
    src = g.host("src").astype(np.int64)
    dst = g.host("dst").astype(np.int64)
    R = int(num_rels)
    if g.edge_mask is not None:
        eids = np.nonzero(g.host("edge_mask"))[0]
    else:
        eids = np.arange(src.shape[0])
    key = dst[eids] * R + et[eids]
    # the internal order is dst-sorted: a stable sort on the key refines it
    # to (dst, etype)
    order = eids[np.argsort(key, kind="stable")]
    key_sorted = dst[order] * R + et[order]
    uk, inv = np.unique(key_sorted, return_inverse=True)
    M = len(uk)
    pair_dst = (uk // R).astype(np.int32)
    pair_etype = (uk % R).astype(np.int32)

    # relabeled graph: edges (src -> pair), already pair-sorted
    pg = _build(src[order].astype(np.int32), inv.astype(np.int32),
                g.num_src_nodes, max(M, 1), is_block=True)
    if prepare and M:
        pg = prepare_spmm(pg, device=device)
    else:
        pg = pg.to(device)
    counts = np.bincount(pair_dst, minlength=g.num_dst_nodes)
    rel_indptr = np.zeros(R + 1, np.int64)
    np.cumsum(np.bincount(pair_etype, minlength=R), out=rel_indptr[1:])
    return RgcnPlan(pg, torch.from_numpy(pair_dst).to(device),
                    torch.from_numpy(pair_etype).to(device),
                    torch.from_numpy(order.astype(np.int32)).to(device), M,
                    segments(counts, device),
                    torch.from_numpy(np.argsort(pair_etype, kind="stable"))
                    .to(device), torch.from_numpy(rel_indptr).to(device))


def rgcn_aggregate_pairs(plan: RgcnPlan, x: Tensor,
                         norm: Optional[Tensor] = None) -> Tensor:
    """First level: (M, in) per-(dst, etype) sums of (normed) src rows.

    ``norm`` is per-edge in INTERNAL order of the ORIGINAL graph, (E,) or
    (E, 1); it permutes into pair-graph order through ``plan.edge_perm``
    and reaches gspmm as (E, 1), which K1 and its plain version both take
    (an (E,) weight does not broadcast in the plain path)."""
    if norm is None:
        return gspmm(plan.pair_graph, "copy_lhs", "sum", x)
    norm_pg = norm.reshape(norm.shape[0], 1)[plan.edge_perm]
    return gspmm(plan.pair_graph, "mul", "sum", x, norm_pg, "u", "e")


def relation_weights(weight: Tensor, w_comp: Optional[Tensor]) -> Tensor:
    """(R, in, out) per-relation weights: ``w_comp @ weight`` over the
    bases, or ``weight`` itself (B == R) without ``w_comp``."""
    if w_comp is None:
        return weight
    B = weight.shape[0]
    return (w_comp @ weight.reshape(B, -1)).reshape(
        (w_comp.shape[0],) + tuple(weight.shape[1:]))


def _project(a: Tensor, W: Tensor, etype: Tensor) -> Tensor:
    """out[m] = a[m] @ W[etype[m]], in chunks of at most
    ``PROJ_CHUNK_ELEMS`` gathered weight elements."""
    I, O = W.shape[1], W.shape[2]
    out = a.new_empty((a.shape[0], O))
    step = max(1, PROJ_CHUNK_ELEMS // (I * O))
    for m0 in range(0, a.shape[0], step):
        m1 = m0 + step
        out[m0:m1] = (a[m0:m1].unsqueeze(2) * W[etype[m0:m1]]).sum(1)
    return out


def _relation_weight_grad(plan: RgcnPlan, agg: Tensor, dmsg: Tensor
                          ) -> Tensor:
    """dW[r] = sum over the pairs m of relation r of agg[m]^T dmsg[m],
    (R, in * out): the outer products, taken in chunks of the pairs in
    relation order (``plan.rel_order``), are each relation's run of rows,
    which K1 sums in edge-row mode."""
    I, O = agg.shape[1], dmsg.shape[1]
    M = agg.shape[0]
    dW = agg.new_zeros((plan.rel_indptr.numel() - 1, I * O))
    step = max(1, PROJ_CHUNK_ELEMS // (I * O))
    for j0 in range(0, M, step):
        j1 = min(j0 + step, M)
        idx = plan.rel_order[j0:j1]
        outer = (agg[idx].unsqueeze(2) * dmsg[idx].unsqueeze(1)).reshape(
            j1 - j0, I * O)
        indptr = (plan.rel_indptr.clamp(j0, j1) - j0).to(torch.int32)
        dW += segment_sum(indptr, outer, site="rows")
    return dW


class RelationProjection(torch.autograd.Function):
    """msg[m] = agg[m] @ W[pair_etype[m]] for (R, in, out) relation
    weights W.  The forward and the agg gradient gather each pair's
    weight, a chunk of pairs at a time (``_project``), so that no (M, in,
    out) array is kept; the W gradient is ``_relation_weight_grad``."""

    @staticmethod
    def forward(ctx, agg: Tensor, W: Tensor, plan: RgcnPlan) -> Tensor:
        ctx.plan = plan
        ctx.save_for_backward(agg, W)
        return _project(agg, W, plan.pair_etype)

    @staticmethod
    def backward(ctx, dmsg: Tensor):
        agg, W = ctx.saved_tensors
        plan = ctx.plan
        dmsg = dmsg.contiguous()
        d_agg = d_W = None
        if ctx.needs_input_grad[0]:
            d_agg = _project(dmsg, W.transpose(1, 2), plan.pair_etype)
        if ctx.needs_input_grad[1]:
            d_W = _relation_weight_grad(plan, agg, dmsg).reshape(W.shape)
        return d_agg, d_W, None


def rgcn_basis_message(plan: RgcnPlan, agg: Tensor, weight: Tensor,
                       w_comp: Optional[Tensor]) -> Tensor:
    """(M, in) pair sums -> (M, out) relation-projected messages.  weight
    (B, in, out); w_comp (R, B) or None (B == R).

    The per-relation weights come first (``relation_weights``), then each
    pair's product with its relation's (RelationProjection): the JAX
    package's function up to float reassociation, holding a chunk of
    gathered (in, out) weights where its basis-first order holds (M, B,
    out)."""
    return RelationProjection.apply(agg, relation_weights(weight, w_comp),
                                    plan)


def rgcn_reduce_pairs(plan: RgcnPlan, msg: Tensor, num_dst: int) -> Tensor:
    """Second level: pair messages -> dst rows, through K1's edge-row mode
    over each dst's run of pairs (the pairs are dst-sorted)."""
    seg = plan.dst_segments
    if seg.indptr.numel() - 1 != num_dst:
        raise ValueError(f"rgcn_reduce_pairs: the plan was built for "
                         f"{seg.indptr.numel() - 1} dst nodes, not {num_dst}")
    return segment_sum_rows(msg, seg)
