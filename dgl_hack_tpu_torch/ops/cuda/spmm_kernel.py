"""K1, the sorted-segment sum, and the gspmm sum it carries.

``segment_sum`` is the wrapper of the CUDA kernel in
``csrc/segment_sum.cu`` (which replaces the TPU kernel
``dgl_hack_tpu/ops/pallas/spmm_kernel.py:_reduce_kernel``);
``segment_sum_plain`` is its plain PyTorch version.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

``SegmentSumRows`` runs K1 in edge-row mode over runs of consecutive
rows (``Segments``): copy_e sums of gspmm and the readouts of a batched
graph.

``GspmmSum`` is the counterpart of the JAX package's ``_gspmm_fused``
custom VJP: the forward reduces over the CSC direction, dx runs the same
kernel over the CSR direction, and dw = <x[src], g[dst]> stays a plain
gather-and-dot.

K1 cuts rows of more than ``K1_PIECE`` edges into pieces that separate
warps sum, then adds each long row's partial sums in piece order.  The
list of long rows and pieces is the row plan (``row_plan``), built from
an indptr with torch ops on its device and cached per graph and
direction (``graph_row_plan``).  On the card ``GspmmSum`` runs K1 over a
copy of x whose columns are padded to whole 128-byte L2 lines where K1
will slice them (``run_width``); the copy lives through the forward only.

K1 takes float32 or bf16 rows (``FEATURE_DTYPES``), as the JAX
package's packed bf16 path does: bf16 rows are held as loaded, bf16x2
words, and widened where they are added (the pairs walk, ``k1_walk``;
16-byte loads, ``k1_vector_width``), the sums run in float32 and round
once to x's dtype (or stay float32 where the caller asks: ``out_dtype``);
weights are float32 (``kernel_weight``).  The line and slice rules count
the rows' own bytes (``line_cols``: 64 bf16 columns to a 128-byte line),
and ``segment_sum_plain`` has the same float32 accumulation.

The dense-hub hybrid (``select_dense_windows`` ... ``gspmm_hybrid``, the
JAX package's ``spmm_kernel.py:1315-1555``) sums the hub dst windows as a
dense bf16 count matrix C times x (``torch.mm``, outside any kernel, as
JAX leaves it to XLA) and the rest with K1 over the sparse remainder's
own CSC/CSR arrays; ``prepare_spmm`` builds it.

A masked (padded) graph reaches every kernel through its real-edge view
(``real_edges``), the counterpart of the JAX package's mask-aware plans
(``_prepare_spmm_masked``): an unmasked graph over the real edges alone,
with its own CSC and CSR arrays and row plans, built on the device with
torch ops and cached on the masked graph.  Of the JAX plan's two ways to
reach the caller's edge operands, the view takes the gather: an edge
operand (a weight, ``attn_w``, copy_e's data) is gathered into the view's
order (``on_real_edges``), so that autograd's scatter writes zeros at the
padded edges, and no kernel takes an argument more.  A mask with no
padding (the sampled blocks drawn with replacement) gives a view over
the masked graph's own arrays, with nothing to gather.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core.graph import Graph
from ...utils.profiling import span, spanned
from .build import LAUNCHES, counted, library, ptr, require, run

Tensor = torch.Tensor

_I32_MAX = 2 ** 31 - 1


# The plain versions gather one row block at a time, at most this many
# (edge, feature) elements (1 GiB of float32), so that they can be held
# against the kernels at full width (Reddit, F = 602: 14 G elements).
PLAIN_CHUNK_ELEMS = 1 << 28


def row_chunks(indptr: Tensor, F: int):
    """(r0, r1, j0, j1) blocks of consecutive rows whose edges [j0, j1)
    hold at most ``PLAIN_CHUNK_ELEMS`` (edge, feature) elements; a row
    larger than that is a block of its own."""
    ip = indptr.cpu().numpy().astype(np.int64)
    num_rows = ip.shape[0] - 1
    per = max(1, PLAIN_CHUNK_ELEMS // max(F, 1))
    r0 = 0
    while r0 < num_rows:
        r1 = int(np.searchsorted(ip, ip[r0] + per, side="right")) - 1
        r1 = min(max(r1, r0 + 1), num_rows)
        yield r0, r1, int(ip[r0]), int(ip[r1])
        r0 = r1


def local_rows(indptr: Tensor, r0: int, r1: int) -> Tensor:
    """Row of each edge of rows [r0, r1), counted from r0."""
    deg = (indptr[r0 + 1:r1 + 1] - indptr[r0:r1]).long()
    return torch.repeat_interleave(
        torch.arange(r1 - r0, device=indptr.device), deg)


# The dtypes K1, K4 and K5 take for their rows (x, and K5's raw and g).
# Weights are cast to float32 at the kernel boundary (``kernel_weight``).
FEATURE_DTYPES = (torch.float32, torch.bfloat16)


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    """What a sum over data of ``dtype`` accumulates in: float32 for a
    floating dtype narrower than it (bf16, float16), else the dtype itself,
    as the JAX package's Pallas sums do (``gspmm_pallas``: float32 sums
    cast once to x's dtype)."""
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


def widened(t: Optional[Tensor]) -> Optional[Tensor]:
    """t cast to its ``accumulate_dtype`` (a bf16 tensor to float32, exact;
    autograd rounds its gradient back once), None as it is."""
    return None if t is None else t.to(accumulate_dtype(t.dtype))


def kernel_weight(w: Optional[Tensor]) -> Optional[Tensor]:
    """An edge weight as the kernels read it: float32 (a bf16 weight is
    cast up, as the JAX package's ``_run_direction`` casts its weights,
    ``edge_weights`` and ``apply_full_w``)."""
    if w is None or w.dtype == torch.float32:
        return w
    return w.float()


def segment_sum_plain(indptr: Tensor, x: Tensor, gidx: Optional[Tensor] = None,
                      eid: Optional[Tensor] = None,
                      w: Optional[Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """out[r] = sum_{j in [indptr[r], indptr[r+1])} x[gidx[j]] * w[eid[j]].

    gidx None reads x row j (edge-row mode); eid None means eid[j] = j; w
    is None, (E,) or (E, F).  Empty rows give 0.  The products and sums
    run in ``accumulate_dtype(x.dtype)`` (float32 for bf16 x), and the
    result is rounded once to ``out_dtype`` (x's dtype when None), as K1
    does.  Rows go in blocks of ``row_chunks``."""
    if x.is_cuda:
        LAUNCHES.add("plain.segment_sum")
    acc = accumulate_dtype(x.dtype)
    num_rows = indptr.numel() - 1
    out = torch.zeros((num_rows, x.shape[1]), dtype=acc, device=x.device)
    for r0, r1, j0, j1 in row_chunks(indptr, x.shape[1]):
        m = (x[gidx[j0:j1]] if gidx is not None else x[j0:j1]).to(acc)
        if w is not None:
            we = (w[eid[j0:j1]] if eid is not None else w[j0:j1]).to(acc)
            m = m * (we[:, None] if we.dim() == 1 else we)
        out[r0:r1].index_add_(0, local_rows(indptr, r0, r1), m)
    return out.to(out_dtype or x.dtype)


# Rows of more than K1_PIECE edges are cut into pieces of at most
# K1_PIECE edges, one warp each.  At bench.py's shape (N = 1M, E = 16M,
# largest in-degree 173,324) 97% of the edges lie in 2,155 such rows,
# which give 61,641 pieces and 32 MB of partial rows at F = 128.
K1_PIECE = 256

# The H100's L2 holds 50 MB.  A feature slice of x is meant to stay there
# while every row gathers from it, beside the indices, weights and output
# that stream through, so a slice may take up to this many bytes.  On an
# H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), K1 over synthetic
# Reddit at F = 602 (x 561 MB) took 16.4 ms in 32-column slices, 16.9 in
# 64, 18.5 in 16 and 23.4 unsliced; over bench.py's 512 MB x at F = 128
# every slice width was slower than none.  The rule picks the best at
# both.
L2_BYTES = 50 * 10 ** 6
SLICE_BUDGET = L2_BYTES * 3 // 5
SLICE_WIDTHS = (64, 32, 16)

# Each pass over a slice walks every row again, so slices pay only where
# the edges far outnumber the rows walked and the rows gathered.  On an
# H100 80GB HBM3 at 700 W (chip_smoke.py's slice sweeps, PERF.md) slicing
# won at synthetic Reddit (101 edges a row: K1 at F = 608 7.6 ms in
# 32-column slices, 18.2 unsliced) and lost on the sampled GraphSAGE's
# masked layer-0 block: unsliced, K1 dx took 0.880 ms for 2.065 in
# 64-column slices and K5 1.880 for 2.915 (0.43 edges a walked row), and
# bf16 K1 forward 0.169 for 0.536 in 16-column slices (6.9 edges a
# gathered row).  Below SLICE_MIN_REUSE edges a row the kernels take no
# slices; the value lies between those cases, which are all that was
# measured.
SLICE_MIN_REUSE = 16


# An L2 line holds LINE_BYTES bytes: 32 float32 columns, 64 bf16 ones
# (``line_cols``).  A feature slice gathered from a row-major array costs
# one line per edge where it starts on a line boundary and two where it
# straddles one.  Rows of 602 floats (2,408 bytes) start on a line
# boundary once in 16, so gspmm pads the columns of a sliced x with zeros
# to the next multiple of a line's columns and cuts the result back.  On
# an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), K4 over synthetic
# Reddit in 32-column slices took 16.2 ms at F = 602 and 7.9 at 608, K1
# 16.2 and 7.8, K5 24.4 and 16.5 (float32).
LINE_BYTES = 128


def line_cols(elem_bytes: int = 4) -> int:
    """Columns of ``elem_bytes`` bytes in one L2 line."""
    return LINE_BYTES // elem_bytes

# Only the card's kernels gain from the padding: the plain versions that a
# CPU tensor takes read whole rows.
PAD_DEVICES = ("cuda",)


# The packed route (csrc/segment_sum.cu, sum_pack).  A warp sums the rows
# of at most K1_SHORT edges of an aligned window of K1_PACK_ROWS rows, one
# lane group a row, where a warp holds at least K1_PACK_GROUPS lane groups
# and at least K1_PACK_SHARE of the rows are short (``k1_route``); the
# rows of more edges, up to K1_PIECE, are listed in the plan and walked a
# warp each (``single_rows``).  The R-GCN pair graph (11.2 M rows of 1.07
# edges), its per-dst sums (6.7 pairs a dst), Cluster-GCN's 0-hop parts
# (one edge a row) and bench.py's forward over bf16 rows (99% of the rows
# empty or short; two lane groups at 8 values a lane) take it; bench.py's
# graph in float32 at F = 128 (one lane group a warp), its dx (below),
# synthetic Reddit (101 edges a row), the transformer's graph (64) and the
# readouts do not.  On an H100 80GB HBM3 at 700 W (chip_smoke.py's
# k1_short_rows, PERF.md) the windows took K1 over AM's pair graph at F =
# 10 from 4.6 ms to 0.63; at F = 41, one lane group a warp, they won too
# (3.34 against 5.57 ms), but the rule keeps that case on the rows route:
# there it would also take the masked layer-0 block's dx at F = 602, where
# they lost (float32 1.35 against 0.88 ms, bf16 0.99 against 0.68;
# tools/k1_builds_torch.py).  The windows are implicit: a list of runs of
# short rows cut into packs (cummax and cummin over the rows) took the
# message API's per-call row plans over half of bench.py's graph from
# 1.30-1.42 ms to 12.3-13.7 there.
# The share: the pack paid where 95-100% of the rows are short (the AM
# pair graph, the 0-hop parts, k1_short_rows' mixed graph) and lost on
# bench.py's dx, where 56.6% of the 1M CSR rows are short at 13.2 edges
# each: over bf16 rows at 8 values a lane (two lane groups) 1.09 ms packed
# against 0.661 on the rows route (tools/k1_builds_torch.py).  The share
# lies between those cases, which are all that was measured.
K1_SHORT = 16
K1_PACK_ROWS = 32
K1_PACK_GROUPS = 2
K1_PACK_SHARE = 0.75
# The most values a lane of the pack loads (``K1Launch.widths``; the route
# is chosen at the rows route's width).  Its kPackBatch x kPackEdges rows
# in flight a lane group held 101 registers a thread over bf16 rows at 8
# values against 64 at 4, and on an H100 80GB HBM3 at 700 W
# (tools/k1_builds_torch.py, PERF.md) 4 values won: k1_short_rows' mixed
# graph at F = 16 forward 0.0380 ms against 0.0535 at 8 (dx 0.0226 against
# 0.0286), bench.py's forward 1.388 against 1.402.  float32 loads at most
# 4 values anyway.
K1_PACK_VALUES = 4


class RowPlan(NamedTuple):
    """The rows of an indptr longer than ``K1_PIECE`` edges, and their
    pieces: long row l is ``long_rows[l]``, its pieces are
    ``pieces[piece_ptr[l]:piece_ptr[l + 1]]``, in edge order, and piece p
    covers edges ``[pieces[p, 0], pieces[p, 1])`` of row ``piece_row[p]``.
    For K1's packed route, ``singles`` lists the rows of more than
    ``K1_SHORT`` edges and at most ``K1_PIECE`` (``single_rows``).  All
    int32, on the indptr's device."""
    long_rows: Tensor     # (L,)
    piece_ptr: Tensor     # (L + 1,)
    pieces: Tensor        # (P, 2)
    piece_row: Tensor     # (P,)
    singles: Tensor       # (S,)

    def to(self, device) -> "RowPlan":
        return RowPlan(*(t.to(device) for t in self))

    def short_rows(self, num_rows: int) -> int:
        """Rows of at most ``K1_SHORT`` edges, from the plan's shapes (no
        device sync)."""
        return num_rows - self.long_rows.numel() - self.singles.numel()


def short_limit(piece: int = K1_PIECE) -> int:
    """The most edges of a packed row: ``K1_SHORT``, and never a long
    row's."""
    return min(K1_SHORT, piece)


def single_rows(deg: Tensor, piece: int = K1_PIECE) -> Tensor:
    """The rows of the degrees ``deg`` that the packed route walks a warp
    each: more than ``short_limit(piece)`` edges and at most ``piece``;
    (S,) int32 on deg's device."""
    return torch.nonzero((deg > short_limit(piece)) & (deg <= piece)
                         ).squeeze(1).to(torch.int32)


def row_plan(indptr: Tensor, piece: int = K1_PIECE) -> RowPlan:
    """K1's row plan of ``indptr``, from torch ops on its device: degrees,
    the mask of rows longer than ``piece``, ceil(deg / piece) pieces each,
    and their cumulative sum; and the packed route's single rows
    (``single_rows``)."""
    ip = indptr.long()
    deg = ip[1:] - ip[:-1]
    long_rows = torch.nonzero(deg > piece).squeeze(1)
    counts = (deg[long_rows] + piece - 1) // piece
    piece_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    num_pieces = int(piece_ptr[-1])
    owner = torch.repeat_interleave(
        torch.arange(long_rows.numel(), device=ip.device), counts,
        output_size=num_pieces)
    k = torch.arange(num_pieces, device=ip.device) - piece_ptr[owner]
    piece_row = long_rows[owner]
    beg = ip[piece_row] + k * piece
    end = torch.minimum(beg + piece, ip[piece_row + 1])
    i32 = torch.int32
    return RowPlan(long_rows.to(i32), piece_ptr.to(i32),
                   torch.stack([beg, end], 1).to(i32).contiguous(),
                   piece_row.to(i32), single_rows(deg, piece))


def edge_lanes(width: int, vec: int) -> int:
    """Lanes per edge of K1, K4 and K5 over ``width`` columns (a slice's,
    or F) at ``vec`` values a load: width / vec rounded up to a power of
    two, at most 32 (rowwalk.cuh:launch_shape)."""
    lanes = 1
    while lanes < 32 and lanes * vec < width:
        lanes *= 2
    return lanes


def k1_route(num_rows: int, short_rows: int, width: int, vec: int) -> str:
    """K1's route over ``num_rows`` rows of which ``short_rows`` have at
    most ``K1_SHORT`` edges, at ``width`` columns a pass and ``vec``
    values a load: ``"packed"`` where a warp holds at least
    ``K1_PACK_GROUPS`` lane groups (32 / ``edge_lanes``) and at least
    ``K1_PACK_SHARE`` of the rows are short, else ``"rows"`` (a warp a row,
    long rows in pieces)."""
    groups = 32 // edge_lanes(width, vec)
    if groups >= K1_PACK_GROUPS and short_rows > 0 \
            and short_rows >= K1_PACK_SHARE * num_rows:
        return "packed"
    return "rows"


def plan_route(plan: RowPlan, num_rows: int, width: int, vec: int) -> str:
    """``k1_route`` from the plan's counts."""
    return k1_route(num_rows, plan.short_rows(num_rows), width, vec)


def graph_row_plan(g, direction: str) -> RowPlan:
    """The row plan of the graph's CSC (``"csc"``: K1's and K4's forward) or
    CSR (``"csr"``: K1's dx, K5) indptr, cached on the graph."""
    key = f"k1_plan_{direction}"
    plan = g.derived.get(key)
    if plan is None:
        indptr = {"csc": g.csc_indptr, "csr": g.csr_indptr}[direction]
        if indptr is None:
            raise ValueError("gspmm backward needs the graph's CSR format")
        with span("ops.plans"):
            plan = row_plan(indptr)
        g.derived[key] = plan
    return plan


def checked_plan(plan: Optional[RowPlan], indptr: Tensor, what: str
                 ) -> RowPlan:
    """``plan``, or ``row_plan(indptr)`` when None, checked for a kernel
    launch on indptr's device."""
    if plan is None:
        plan = row_plan(indptr)
    if any(t.device != indptr.device or t.dtype != torch.int32
           or not t.is_contiguous() for t in plan):
        raise ValueError(f"{what}: the row plan must be contiguous int32 on "
                         f"{indptr.device}")
    P = plan.pieces.shape[0]
    if plan.piece_ptr.numel() != plan.long_rows.numel() + 1 \
            or plan.piece_row.numel() != P:
        raise ValueError(f"{what}: plan.piece_ptr and plan.piece_row do not "
                         "match plan.long_rows and plan.pieces")
    return plan


def plan_scratch(plan: RowPlan, F: int) -> Optional[Tensor]:
    """The (pieces, F) float32 scratch for the plan's partial rows, None
    without pieces."""
    P = plan.pieces.shape[0]
    return torch.empty((P, F), dtype=torch.float32,
                       device=plan.pieces.device) if P else None


def plan_args(plan: RowPlan, partial: Optional[Tensor]) -> tuple:
    """The plan as the C entry points take it: T, long_rows, piece_ptr,
    pieces, piece_row, num_long, num_pieces, partial."""
    return (K1_PIECE, ptr(plan.long_rows), ptr(plan.piece_ptr),
            ptr(plan.pieces), ptr(plan.piece_row), plan.long_rows.numel(),
            plan.pieces.shape[0], ptr(partial))


def pack_args(plan: RowPlan, route: str) -> tuple:
    """K1's packed route as its C entry points take it: short_limit,
    singles, num_singles; short_limit 0 on the ``"rows"`` route."""
    if route != "packed":
        return (0, None, 0)
    return (short_limit(), ptr(plan.singles), plan.singles.numel())


# The most values a lane of K5 on segment_max.cu's walk loads at a time,
# and of K1 beside an (E, F) float32 weight.  K5 widens bf16 on the load, so
# its 16-byte loads (8 values) cost registers (93-128 a thread against 64
# at 4 values) and took longer on an H100 80GB HBM3 at 700 W
# (chip_smoke.py's load-width sweeps, PERF.md): at bench.py's shape 2.399
# ms against 1.787, at synthetic Reddit (F = 640) 30.86 against 17.41.
SUM_MAX_VALUES = 4

# K1 over bf16 rows holds each row piece as loaded bf16x2 words (the pairs
# walk, csrc/segment_sum.cu), so a 16-byte load (8 values) costs a lane 4
# registers an edge in flight: 48 registers a thread at 8 values where the
# walk that widened bf16 on the load held 70 and kept to 4 values a load.
# On an H100 80GB HBM3 at 700 W (tools/k1_builds_torch.py, PERF.md) 8
# values a lane took synthetic Reddit's forward (640 columns in 64-column
# slices) to 4.32 ms and its dx to 4.63, against 4.85 and 4.97 at 4 values
# and the widening walk's 4.98 and 5.04; bench.py's dx (F = 128) to 0.661
# against 0.723 and 0.758.  The short-rows pack loads fewer
# (``K1_PACK_VALUES``).
K1_BF16_VALUES = 8


def k1_walk(dtype: torch.dtype) -> str:
    """How K1 holds an edge's gathered row piece: ``"pairs"`` for bf16 rows
    (the words as loaded, widened at the add), ``"floats"`` for float32."""
    return "pairs" if dtype == torch.bfloat16 else "floats"


def k1_values(dtype: torch.dtype, w_kind: int) -> int:
    """The most values a lane of K1 loads at a time: ``K1_BF16_VALUES``
    for bf16 rows without an (E, F) weight, else ``SUM_MAX_VALUES`` (16
    bytes of float32; beside bf16 rows, an (E, F) float32 weight at 8
    values would take two 16-byte loads a lane)."""
    if k1_walk(dtype) == "pairs" and w_kind != 2:
        return K1_BF16_VALUES
    return SUM_MAX_VALUES


def k1_vector_width(F: int, x: Tensor, w: Optional[Tensor],
                    w_kind: int) -> int:
    """K1's load width over x (rows, F) and its weight of kind ``w_kind``
    (0 none, 1 (E,), 2 (E, F)): ``vector_width`` at most ``k1_values``,
    counting the weight's alignment where it is (E, F)."""
    return vector_width(F, x, w if w_kind == 2 else None,
                        max_values=k1_values(x.dtype, w_kind))


def k1_name(route: str, dtype: torch.dtype) -> str:
    """K1's name for a launch over rows of ``dtype`` on ``route``
    (``k1_route``) in the dispatch log: "K1", "K1 packed" (short rows
    packed), and with " pairs" after them over bf16 rows (``k1_walk``)."""
    name = "K1 packed" if route == "packed" else "K1"
    return name + " pairs" if k1_walk(dtype) == "pairs" else name


def vector_width(F: int, *tensors: Optional[Tensor],
                 max_values: int = 8) -> int:
    """Values per load of K1, K4 and K5: the most, v, that a 16-byte load
    of the narrowest tensor holds (4 of float32, 8 of bf16), at most
    ``max_values``, halved until v | F and every tensor's data is aligned
    for v of its own values (at most 16 bytes: 8 float32 weights beside
    bf16 rows are two 16-byte loads).  So float32 rows take 4 where 4 | F
    and the data is 16-byte aligned, 2 where 2 | F and it is 8-byte
    aligned, else 1."""
    sizes = [t.element_size() for t in tensors if t is not None]
    v = min(16 // min(sizes, default=4), max_values)
    while v > 1:
        if F % v == 0 and all(
                t is None or t.data_ptr() % min(16, t.element_size() * v) == 0
                for t in tensors):
            return v
        v //= 2
    return 1


def edges_per_row(edges: int, *rows: int) -> float:
    """Edges over the most rows of ``rows`` (walked and gathered): the
    reuse that ``slice_width`` weighs."""
    return edges / max(max(rows), 1)


def slice_width(rows: int, F: int, edge_rows: bool,
                elem_bytes: int = 4, reuse: Optional[float] = None) -> int:
    """Columns per feature slice of K1 over a gathered x of ``rows`` rows
    of ``elem_bytes``-byte values: F (no slicing) where x has no reuse
    (edge-row mode, or ``reuse``, the edges a row from ``edges_per_row``,
    under ``SLICE_MIN_REUSE``) or fits in ``SLICE_BUDGET`` whole; else the
    widest of ``SLICE_WIDTHS`` whose slice of x fits; F where none
    does."""
    if edge_rows or rows * F * elem_bytes <= SLICE_BUDGET or (
            reuse is not None and reuse < SLICE_MIN_REUSE):
        return F
    for s in SLICE_WIDTHS:
        if s < F and rows * s * elem_bytes <= SLICE_BUDGET:
            return s
    return F


def padded_width(rows: int, F: int, w: Optional[Tensor],
                 elem_bytes: int = 4, reuse: Optional[float] = None) -> int:
    """The width gspmm pads an x of ``rows`` rows and F columns of
    ``elem_bytes``-byte values to before K1 or K4 gathers it: the next
    multiple of a line's columns (``line_cols``) where the kernel cuts the
    columns into slices (``slice_width``, with ``reuse``); F (no padding)
    where it does not, and under an (E, F) weight, which would need the
    same padding."""
    if (w is not None and w.dim() == 2) or \
            slice_width(rows, F, False, elem_bytes, reuse) >= F:
        return F
    cols = line_cols(elem_bytes)
    return -(-F // cols) * cols


def run_width(x2: Tensor, w: Optional[Tensor], g=None) -> int:
    """The width at which gspmm runs its kernels over x2 (rows, F) on the
    graph g: ``padded_width`` on a device of ``PAD_DEVICES`` (with g's
    edges a row as the reuse, when g is given), else F."""
    rows, F = x2.shape
    if x2.device.type not in PAD_DEVICES:
        return F
    reuse = None if g is None else edges_per_row(
        g.num_edges(), g.num_src_nodes, g.num_dst_nodes)
    return padded_width(rows, F, w, x2.element_size(), reuse)


def pad_columns(x2: Tensor, width: int) -> Tensor:
    """x2 (rows, F) with zero columns up to ``width``, contiguous."""
    if width > x2.shape[1]:
        x2 = torch.nn.functional.pad(x2, (0, width - x2.shape[1]))
    return x2.contiguous()


@spanned("kernel.k1")
def segment_sum(indptr: Tensor, x: Tensor, gidx: Optional[Tensor] = None,
                eid: Optional[Tensor] = None, w: Optional[Tensor] = None, *,
                site: str = "fwd", plan: Optional[RowPlan] = None,
                out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """K1 wrapper.  x (rows, F) float32 or bf16; indptr, gidx, eid int32;
    w None, (E,) or (E, F).  Sums run in float32; the result is x's dtype,
    or ``out_dtype`` (float32 under bf16 x, for a caller that adds more to
    it before it rounds).  ``site`` names the call site in the launch
    count (fwd, rev, edge, rows).  ``plan`` is ``row_plan(indptr)``, built
    here when None."""
    if x.device.type == "cpu":
        return segment_sum_plain(indptr, x, gidx, eid, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {x.device}")
    launch = segment_sum_launcher(indptr, x, gidx, eid, w, plan, out_dtype)
    LAUNCHES.add(launch_name(site, x.dtype))
    return launch(None)


def launch_name(site: str, dtype: torch.dtype) -> str:
    """K1's name in ``LAUNCHES`` at ``site`` over rows of ``dtype``:
    ``segment_sum.<site>``, and ``segment_sum_bf16.<site>.pairs`` on the
    pairs walk."""
    name = f"{counted('segment_sum', dtype)}.{site}"
    return name + ".pairs" if k1_walk(dtype) == "pairs" else name


class K1Launch:
    """K1's launch over checked arguments (``segment_sum_launcher``):
    ``launch(slice_cols, vec, route)`` runs the kernel at that slice width,
    load width and route, or at the rule's where None (``widths``), and
    returns the result; ``route(...)`` names the route that call takes."""

    def __init__(self, indptr, x, gidx, eid, w, w_kind, plan, out_dtype,
                 vec_rule, reuse):
        self.args = (indptr, x, gidx, eid, w, w_kind, plan, out_dtype)
        self.vec_rule, self.reuse = vec_rule, reuse

    def widths(self, slice_cols: Optional[int] = None,
               vec: Optional[int] = None, route: Optional[str] = None):
        """(slice_cols, vec, route) of a launch: those given, the others
        by the rule: ``slice_width``'s slice; ``k1_route``'s route at that
        slice and ``k1_vector_width``'s load width (``vec_rule``); that
        width on the rows route and at most ``K1_PACK_VALUES`` on the
        pack."""
        indptr, x, gidx = self.args[:3]
        if slice_cols is None:
            slice_cols = slice_width(x.shape[0], x.shape[1], gidx is None,
                                     x.element_size(), self.reuse)
        if route is None:
            route = plan_route(self.args[6], indptr.numel() - 1,
                               min(slice_cols, x.shape[1]),
                               vec or self.vec_rule)
        if vec is None:
            vec = self.vec_rule if route == "rows" else min(
                self.vec_rule, K1_PACK_VALUES)
        return slice_cols, vec, route

    def route(self, slice_cols: Optional[int] = None,
              vec: Optional[int] = None) -> str:
        return self.widths(slice_cols, vec)[2]

    def __call__(self, slice_cols: Optional[int] = None,
                 vec: Optional[int] = None,
                 route: Optional[str] = None) -> Tensor:
        indptr, x, gidx, eid, w, w_kind, plan, out_dtype = self.args
        slice_cols, vec, route = self.widths(slice_cols, vec, route)
        num_rows, F, dev = indptr.numel() - 1, x.shape[1], x.device
        out = torch.empty((num_rows, F), dtype=out_dtype, device=dev)
        head = (ptr(indptr), ptr(gidx), ptr(eid), ptr(x), ptr(w), w_kind,
                ptr(out))
        tail = (num_rows, F, vec, slice_cols,
                *plan_args(plan, plan_scratch(plan, F)),
                *pack_args(plan, route))
        if x.dtype == torch.float32:
            run("segment_sum", library().segment_sum_f32, dev, *head, *tail)
        else:
            run("segment_sum", library().segment_sum_bf16, dev, *head,
                int(out_dtype == torch.float32), *tail)
        return out


def segment_sum_launcher(indptr: Tensor, x: Tensor,
                         gidx: Optional[Tensor] = None,
                         eid: Optional[Tensor] = None,
                         w: Optional[Tensor] = None,
                         plan: Optional[RowPlan] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> K1Launch:
    """Check K1's arguments on CUDA and return their ``K1Launch``.
    ``segment_sum`` launches through it; ``chip_smoke.py`` times the slice
    and load widths and the routes with it."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"segment_sum takes x of shape (rows, F), got "
                         f"{tuple(x.shape)}")
    num_rows, F = indptr.numel() - 1, x.shape[1]
    require(x, "x", FEATURE_DTYPES, dev)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"segment_sum of {x.dtype} x returns {x.dtype} or "
                        f"float32, not {out_dtype}")
    require(indptr, "indptr", torch.int32, dev)
    E = x.shape[0] if gidx is None else gidx.numel()
    if gidx is not None:
        require(gidx, "gidx", torch.int32, dev)
    if eid is not None:
        require(eid, "eid", torch.int32, dev, E)
    w_kind = 0
    if w is not None:
        require(w, "w", FEATURE_DTYPES, dev)
        w = kernel_weight(w)
        if w.dim() == 1:
            w_kind = 1
        elif w.dim() == 2 and w.shape[1] == F:
            w_kind = 2
        else:
            raise ValueError(f"segment_sum weight of shape {tuple(w.shape)} "
                             f"for F={F}; expected (E,) or (E, {F})")
        if w.shape[0] != E:
            raise ValueError(f"w has {w.shape[0]} rows, expected {E}")
    if max(num_rows, E, x.shape[0]) > _I32_MAX:
        raise ValueError("segment_sum: sizes exceed the int32 index range")
    plan = checked_plan(plan, indptr, "segment_sum")
    vec_rule = k1_vector_width(F, x, w, w_kind)
    return K1Launch(indptr, x, gidx, eid, w, w_kind, plan, out_dtype,
                    vec_rule, edges_per_row(E, x.shape[0], num_rows))


def rev_gidx(g) -> Tensor:
    """dst of each edge in CSR order (the dx direction's gather index),
    cached on the graph."""
    t = g.derived.get("dst_csr")
    if t is None:
        if g.csr_eids is None:
            raise ValueError("gspmm backward needs the graph's CSR format")
        with span("ops.plans"):
            t = g.dst[g.csr_eids].contiguous()
        g.derived["dst_csr"] = t
    return t


class GspmmSum(torch.autograd.Function):
    """out[v] = sum_{e=(u,v)} x[u] * w[e] over the graph's CSC direction.

    x (N_src, F); w None, (E,) or (E, F) in internal edge order.  Returns
    (N_dst, ``run_width(x, w, g)``): K1 runs over a padded copy of x that is
    dropped after the forward (the backward needs x only for dw, and
    takes the caller's), and the caller cuts the result back to F
    columns, so that autograd hands the backward a padded cotangent."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Optional[Tensor], g) -> Tensor:
        ctx.g = g
        ctx.save_for_backward(x, w)
        return segment_sum(g.csc_indptr, pad_columns(x, run_width(x, w, g)),
                           gidx=g.src, w=w, site="fwd",
                           plan=graph_row_plan(g, "csc"))

    @staticmethod
    @spanned("ops.gspmm.bwd")
    def backward(ctx, dout: Tensor):
        x, w = ctx.saved_tensors
        g = ctx.g
        F = x.shape[1]
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[u] = sum_{e=(u,v)} dout[v] * w[e]: the src-major direction
            dx = segment_sum(g.csr_indptr, dout, gidx=rev_gidx(g),
                             eid=g.csr_eids, w=w, site="rev",
                             plan=graph_row_plan(g, "csr"))[:, :F]
        if w is not None and ctx.needs_input_grad[1]:
            # dw[e] = <x[src_e], dout[dst_e]>, elementwise for (E, F) w,
            # in float32 under bf16 and cast to w's dtype (spmm_kernel.py
            # _gspmm_fused_bwd)
            acc = accumulate_dtype(x.dtype)
            prod = x[g.src].to(acc) * dout[:, :F][g.dst].to(acc)
            dw = (prod.sum(-1) if w.dim() == 1 else prod).to(w.dtype)
        return dx, dw, None


def check_cuda_call(x: Tensor, what: str,
                    dtypes: tuple = FEATURE_DTYPES) -> None:
    """A dtype that the kernels do not take raises on CUDA (there is no
    plain fallback there): K1-K6 take float32 and bf16 rows
    (``FEATURE_DTYPES``)."""
    if x.is_cuda and x.dtype not in dtypes:
        raise TypeError(f"{what} in {x.dtype}: the CUDA kernels take "
                        f"{' or '.join(map(str, dtypes))}")


class RealEdges(NamedTuple):
    """The real edges of a masked graph: ``graph`` is an unmasked graph
    over them alone (same nodes, edges in the masked graph's internal
    order with the padding left out), and ``eid`` (R,) int64 the masked
    graph's internal position of each, None where no edge is padding
    (``graph`` then shares the masked graph's arrays)."""
    graph: Graph
    eid: Optional[Tensor]

    def to(self, device) -> "RealEdges":
        return RealEdges(self.graph.to(device),
                         None if self.eid is None else self.eid.to(device))


def _running_count(mask: Tensor) -> Tensor:
    """(E + 1,) int32: entry i counts the True entries of mask before i."""
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=mask.device),
                      torch.cumsum(mask, 0, dtype=torch.int32)])


def real_edges(g) -> RealEdges:
    """The real-edge view of the masked graph ``g``, cached on it.  Built
    with torch ops on g's device and one host sync (``nonzero``, for the
    count of real edges): each indptr is the running count of real edges
    read at the masked graph's own row starts, and the CSR order a stable
    sort of the view's src, which is the masked graph's CSR order with the
    padding left out.  Where no edge is padding the view is the masked
    graph's own arrays without the mask."""
    view = g.derived.get("real_edges")
    if view is None:
        with span("ops.plans"):
            view = _real_edge_view(g)
        g.derived["real_edges"] = view
    return view


def _real_edge_view(g) -> RealEdges:
    mask = g.edge_mask
    eid = torch.nonzero(mask).squeeze(1)
    if eid.numel() == mask.numel():
        return RealEdges(Graph(
            num_src=g.num_src_nodes, num_dst=g.num_dst_nodes, src=g.src,
            dst=g.dst, csc_indptr=g.csc_indptr, csr_indptr=g.csr_indptr,
            csr_eids=g.csr_eids, is_block=g.is_block), None)
    src, dst = g.src[eid].contiguous(), g.dst[eid].contiguous()
    csc_indptr = _running_count(mask)[g.csc_indptr.long()]
    csr = {}
    if g.csr_indptr is not None:
        before = _running_count(mask[g.csr_eids.long()])
        csr = {"csr_indptr": before[g.csr_indptr.long()].contiguous(),
               "csr_eids": torch.sort(src, stable=True).indices.to(
                   torch.int32)}
    return RealEdges(Graph(
        num_src=g.num_src_nodes, num_dst=g.num_dst_nodes, src=src,
        dst=dst, csc_indptr=csc_indptr.contiguous(),
        is_block=g.is_block, **csr), eid)


def on_real_edges(g, *edge_data: Optional[Tensor]):
    """(graph, *edge_data) for a kernel: g and the data as they are on an
    unmasked graph; on a masked one its real-edge view and each (E, ...)
    tensor (in g's internal order) gathered into the view's order, None
    staying None."""
    if g.edge_mask is None:
        return (g, *edge_data)
    view = real_edges(g)
    if view.eid is None:
        return (view.graph, *edge_data)
    return (view.graph, *(None if t is None else t[view.eid]
                          for t in edge_data))


def real_in_degrees(g) -> Tensor:
    """In-degree counting real edges only (gspmm mean's divisor); on an
    unmasked graph ``g.in_degrees()``."""
    return on_real_edges(g)[0].in_degrees()


def flat_weight(w: Optional[Tensor], shape) -> Optional[Tensor]:
    """An edge weight (E,), (E, 1...) or (E, ...) broadcastable to x's
    feature shape ``shape[1:]``, as the kernels take it: (E,) for one
    scalar per edge, else (E, F) at x's flattened width."""
    if w is None:
        return None
    if w.dim() > 1 and all(s == 1 for s in w.shape[1:]):
        w = w.reshape(w.shape[0])           # one scalar per edge
    elif w.dim() > 1:
        w = w.expand((w.shape[0],) + tuple(shape[1:]))
        w = w.reshape(w.shape[0], -1)
    return w.contiguous()


def gspmm_sum(g, x: Tensor, w: Optional[Tensor] = None) -> Tensor:
    """copy_u / u_mul_e sum through K1.  x (N, ...) and w (E,), (E, 1...)
    or (E, ...) broadcastable to x's feature shape.  Returns (N_dst, ...).
    A wide x that K1 will slice is first padded to whole L2 lines
    (``padded_width``).  A masked graph runs over its real-edge view."""
    check_cuda_call(x, "gspmm")
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    g, w = on_real_edges(g, flat_weight(w, shape))
    out = GspmmSum.apply(x2, w, g)[:, :x2.shape[1]]
    return out.reshape((out.shape[0],) + tuple(shape[1:]))


def gspmm_sum_route(g, x: Tensor, w: Optional[Tensor] = None) -> str:
    """The route K1 takes in ``gspmm_sum(g, x, w)``'s forward on x's
    device (``k1_route``; on the CPU the plain version runs whatever it
    says).  For the dispatch log: it pads a copy of x as the forward
    does."""
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    g, w = on_real_edges(g, flat_weight(w, shape))
    return segment_sum_launcher(
        g.csc_indptr, pad_columns(x2, run_width(x2, w, g)), g.src, w=w,
        plan=graph_row_plan(g, "csc")).route()


class Segments(NamedTuple):
    """Runs of consecutive rows that K1's edge-row mode sums: segment r is
    rows ``[indptr[r], indptr[r + 1])`` of x; ``ids`` is the segment of
    each row (the backward's gather index) and ``plan`` K1's row plan of
    indptr.  On the indptr's device."""
    indptr: Tensor        # (S + 1,) int32
    ids: Tensor           # (rows,) int32
    plan: RowPlan

    def to(self, device) -> "Segments":
        return Segments(self.indptr.to(device), self.ids.to(device),
                        self.plan.to(device))


def segments(counts, device) -> Segments:
    """The segments of consecutive runs of ``counts[i]`` rows each."""
    counts = np.asarray(counts, dtype=np.int64)
    indptr = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    if indptr[-1] > _I32_MAX:
        raise ValueError("segments: sizes exceed the int32 index range")
    ids = np.repeat(np.arange(counts.shape[0], dtype=np.int32), counts)
    indptr = torch.from_numpy(indptr.astype(np.int32)).to(device)
    return Segments(indptr, torch.from_numpy(ids).to(device),
                    row_plan(indptr))


def graph_segments(g, kind: str) -> Segments:
    """The graph's row segments, cached on it: ``"csc"`` groups the edges
    (in internal order) by dst node, ``"nodes"`` the nodes and ``"edges"``
    the edges (internal order) by the graph of a batch; a graph not made
    by ``batch()`` is one segment."""
    if kind == "csc":
        return Segments(g.csc_indptr, g.dst, graph_row_plan(g, "csc"))
    key = f"rows_{kind}"
    seg = g.derived.get(key)
    if seg is None:
        if kind == "nodes":
            counts = g.batch_num_nodes or (g.num_dst_nodes,)
        elif kind == "edges":
            counts = g.batch_num_edges or (g.num_edges(),)
        else:
            raise ValueError(f"unknown segment kind {kind!r}")
        with span("ops.plans"):
            seg = segments(counts, g.device)
        g.derived[key] = seg
    return seg


class SegmentSumRows(torch.autograd.Function):
    """out[r] = sum of the rows of x in segment r (K1 with gidx None over
    the segments' row plan).  The backward gathers dout back to each row,
    the transpose of a sorted segment sum."""

    @staticmethod
    def forward(ctx, x: Tensor, seg: Segments) -> Tensor:
        ctx.ids = seg.ids
        return segment_sum(seg.indptr, x, site="rows", plan=seg.plan)

    @staticmethod
    def backward(ctx, dout: Tensor):
        return dout[ctx.ids], None


def segment_sum_rows(x: Tensor, seg: Segments) -> Tensor:
    """Sum of each segment's rows of x (rows, ...) -> (S, ...)."""
    shape = x.shape
    out = SegmentSumRows.apply(x.reshape(shape[0], -1).contiguous(), seg)
    return out.reshape((out.shape[0],) + tuple(shape[1:]))


def segment_mean_rows(x: Tensor, seg: Segments) -> Tensor:
    """Sum of each segment's rows divided by clamp(rows, 1)."""
    out = segment_sum_rows(x, seg)
    cnt = (seg.indptr[1:] - seg.indptr[:-1]).to(out.dtype).clamp(min=1)
    return out / cnt.reshape((-1,) + (1,) * (out.dim() - 1))


def gspmm_rows_route(g, data: Tensor) -> str:
    """The route K1 takes in ``gspmm_rows(g, data, ...)`` (``k1_route``),
    as ``gspmm_sum_route``."""
    g, data = on_real_edges(g, data)
    seg = graph_segments(g, "csc")
    return segment_sum_launcher(
        seg.indptr, data.reshape(data.shape[0], -1).contiguous(),
        plan=seg.plan).route()


def gspmm_rows(g, data: Tensor, reduce_op: str) -> Tensor:
    """copy_e sum or mean: the edge data (E, ...) in internal order are
    each dst row's run of rows, so K1 sums them in edge-row mode.  A
    masked graph sums its real edges' rows (``on_real_edges``)."""
    check_cuda_call(data, "gspmm")
    g, data = on_real_edges(g, data)
    seg = graph_segments(g, "csc")
    if reduce_op == "mean":
        return segment_mean_rows(data, seg)
    return segment_sum_rows(data, seg)


# ---------------------------------------------------------------------------
# The dense-hub hybrid: a dense count matrix for hub dst windows, K1 for
# the rest (the JAX package's select_dense_windows ... gspmm_hybrid,
# spmm_kernel.py:1315-1555)
# ---------------------------------------------------------------------------
# What the default breakeven weighs, measured on an H100 80GB HBM3 at
# 700.00 W (chip_smoke.py's bf16_kernels and hybrid phases, PERF.md): K1's
# forward time per edge at bench.py's shape (float32, F = 128: 2.94 ms
# over 16M edges), and the rate of the hybrid's float32 dense product,
# its C chunks cast to float32 included, over (2,304, 1M) x (1M, 128):
# 31.1 TFLOP/s.  The C read counts at the card's 3.35 TB/s (H100 SXM data
# sheet).  With these the default densifies bench.py's one hub window
# (9.5M of its 16M edges), which took bench.py's loop from 3.085 to 2.780
# ms an iteration in float32 and from 1.653 to 1.097 in bf16 on that
# card; bench.py's own threshold (18 windows) took it to 19.57 and 2.186.
K1_NS_PER_EDGE = 0.18
K1_NS_WIDTH = 128
DENSE_FP32_OPS_PER_S = 31e12
CARD_BYTES_PER_S = 3.35e12
# rows of C cast to float32 at a time by the float32 product (1 GiB of
# float32 at 1M sources)
DENSE_CHUNK_ROWS = 256
# bf16 holds every integer up to 256 exactly (8 significant bits)
BF16_EXACT_INT = 256


def _dense_breakeven(num_src: int, tr: int, flat_width: int = 128) -> int:
    """Edges in a window of ``tr`` dst rows above which its dense product
    (reading a (tr, num_src) bf16 block of C, and a float32 product at
    ``flat_width`` columns) takes less time than K1 over those edges
    (``K1_NS_PER_EDGE`` at ``K1_NS_WIDTH`` columns, scaled to
    ``flat_width``); at least 4 tr, as in the JAX package."""
    read_s = tr * num_src * 2 / CARD_BYTES_PER_S
    gemm_s = 2.0 * tr * num_src * max(flat_width, 1) / DENSE_FP32_OPS_PER_S
    k1_s = K1_NS_PER_EDGE * 1e-9 * max(flat_width, 1) / K1_NS_WIDTH
    return max(4 * tr, int(max(read_s, gemm_s) / k1_s))


def select_dense_windows(csc_indptr: np.ndarray, num_src: int, num_dst: int,
                         tr: int, threshold: Optional[int] = None,
                         budget_bytes: int = 3 << 30,
                         flat_width: int = 128) -> np.ndarray:
    """Ids of the windows of ``tr`` consecutive dst rows to densify: those
    of at least ``threshold`` edges (``_dense_breakeven``'s when None), the
    heaviest first as far as ``budget_bytes`` of bf16 C holds them, in
    ascending order.  Host numpy, as in the JAX package."""
    W = max(1, -(-num_dst // tr))
    bounds = np.minimum(np.arange(W + 1) * tr, num_dst)
    ip = np.asarray(csc_indptr)
    cnt = (ip[bounds[1:]] - ip[bounds[:-1]]).astype(np.int64)
    thr = _dense_breakeven(num_src, tr, flat_width) if threshold is None \
        else threshold
    max_wins = int(budget_bytes // max(tr * num_src * 2, 1))
    cand = np.nonzero(cnt >= max(thr, 1))[0]
    if cand.size == 0 or max_wins == 0:
        return np.zeros(0, np.int64)
    order = cand[np.argsort(cnt[cand], kind="stable")[::-1]]
    return np.sort(order[:max_wins])


def _check_dense_exact(g, wins: np.ndarray, tr: int) -> np.ndarray:
    """``wins`` without the windows where some (dst, src) pair repeats more
    than ``BF16_EXACT_INT`` times: C's bf16 counts would not be exact."""
    if wins.size == 0:
        return wins
    dst = g.host("dst").astype(np.int64)
    src = g.host("src").astype(np.int64)
    win = dst // tr
    dense = np.zeros(max(1, -(-g.num_dst_nodes // tr)), bool)
    dense[wins] = True
    sel = dense[win]
    keys, counts = np.unique(dst[sel] * g.num_src_nodes + src[sel],
                             return_counts=True)
    bad = np.unique(keys[counts > BF16_EXACT_INT] // g.num_src_nodes // tr)
    return wins[~np.isin(wins, bad)]


def _window_rows(wins: np.ndarray, tr: int, num_dst: int) -> np.ndarray:
    """The dst rows of the windows, in order (int64)."""
    if wins.size == 0:
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(w * tr, min((w + 1) * tr, num_dst))
                           for w in wins]).astype(np.int64)


def _build_dense_C(g, wins: np.ndarray, tr: int,
                   rows_per_chunk: int = DENSE_CHUNK_ROWS):
    """(C, rows) on g's device: C (R, num_src) bf16 counts of the edges
    into each dense row from each source, rows (R,) int64 the dst rows.
    Built a chunk of ``rows_per_chunk`` rows at a time through a float32
    staging buffer (``index_put_`` with accumulate)."""
    dev = g.device
    rows = torch.from_numpy(_window_rows(wins, tr, g.num_dst_nodes)).to(dev)
    R, num_src = rows.numel(), g.num_src_nodes
    row_map = torch.full((g.num_dst_nodes,), -1, dtype=torch.int64,
                         device=dev)
    row_map[rows] = torch.arange(R, device=dev)
    local = row_map[g.dst.long()]                # dense row of each edge
    src = g.src.long()
    C = torch.empty((R, num_src), dtype=torch.bfloat16, device=dev)
    for r0 in range(0, R, rows_per_chunk):
        cr = min(rows_per_chunk, R - r0)
        sel = (local >= r0) & (local < r0 + cr)
        stage = torch.zeros((cr, num_src), dtype=torch.float32, device=dev)
        stage.index_put_((local[sel] - r0, src[sel]),
                         torch.ones((), device=dev), accumulate=True)
        C[r0:r0 + cr] = stage.to(torch.bfloat16)
    return C, rows


def build_hybrid_plan(g, wins: np.ndarray, tr: int) -> Graph:
    """The sparse remainder: an unmasked graph over the edges outside the
    dense windows, with its own CSC and CSR arrays and K1's row plans in
    both directions (the real-edge view of the mask of kept edges, built
    with torch ops on g's device).  Its rows in the dense windows are
    empty."""
    W = max(1, -(-g.num_dst_nodes // tr))
    dense = torch.zeros(W, dtype=torch.bool, device=g.device)
    dense[torch.from_numpy(np.asarray(wins, np.int64)).to(g.device)] = True
    keep = ~dense[g.dst.long() // tr]
    rem = real_edges(g.structure_only().replace(edge_mask=keep)).graph
    rev_gidx(rem)
    graph_row_plan(rem, "csc")
    graph_row_plan(rem, "csr")
    return rem


class HybridPlan(NamedTuple):
    """A graph's dense-hub hybrid (``prepare_spmm``): ``rem`` the sparse
    remainder (``build_hybrid_plan``), ``C`` (R, num_src) bf16 the dense
    rows' counts, ``rows`` (R,) int64 those rows, ``windows`` the dense
    windows' ids and ``tr`` their rows."""
    rem: Graph
    C: Tensor
    rows: Tensor
    windows: Tensor
    tr: int

    def to(self, device) -> "HybridPlan":
        return HybridPlan(self.rem.to(device), self.C.to(device),
                          self.rows.to(device), self.windows.to(device),
                          self.tr)


def _mm_float(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with a float32 result: on the card a bf16 x bf16 product with
    float32 output (``out_dtype``), each sum taken before any rounding
    (the JAX package's bf16 dot with preferred_element_type float32);
    else a product in ``accumulate_dtype`` (float32 for bf16), which for
    float32 is a full-float32 product: the port leaves TF32 off, PyTorch's
    default."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    acc = accumulate_dtype(b.dtype)
    return torch.mm(a.to(acc), b.to(acc))


@spanned("kernel.hybrid_mm")
def _dense_matmul(C: Tensor, x: Tensor) -> Tensor:
    """C @ x: (R, N) counts @ (N, F) -> (R, F) in float32 (in float64 for
    a float64 x).  A bf16 x takes one bf16 product of C as it is stored;
    a float32 x a float32 product over C cast up ``DENSE_CHUNK_ROWS`` rows
    at a time."""
    if x.dtype == torch.bfloat16:
        return _mm_float(C, x)
    return torch.cat([_mm_float(C[r0:r0 + DENSE_CHUNK_ROWS], x)
                      for r0 in range(0, C.shape[0], DENSE_CHUNK_ROWS)])


@spanned("kernel.hybrid_mm")
def _dense_matmul_t(C: Tensor, g: Tensor) -> Tensor:
    """Cᵀ @ g: (R, N)ᵀ @ (R, F) -> (N, F) in float32 (the backward), with
    ``_dense_matmul``'s precision."""
    if g.dtype == torch.bfloat16:
        return _mm_float(C.t(), g)
    out = None
    for r0 in range(0, C.shape[0], DENSE_CHUNK_ROWS):
        part = _mm_float(C[r0:r0 + DENSE_CHUNK_ROWS].t(),
                         g[r0:r0 + DENSE_CHUNK_ROWS])
        out = part if out is None else out.add_(part)
    return out


class DenseCountMatmul(torch.autograd.Function):
    """C @ x in float32 with its transpose as the backward, the JAX
    package's ``dense_count_matmul`` (a plain matmul there too, outside
    any Pallas kernel).  The gradient comes back in x's dtype."""

    @staticmethod
    def forward(ctx, C: Tensor, x: Tensor) -> Tensor:
        ctx.save_for_backward(C)
        ctx.x_dtype = x.dtype
        return _dense_matmul(C, x)

    @staticmethod
    def backward(ctx, g: Tensor):
        (C,) = ctx.saved_tensors
        return None, _dense_matmul_t(C, g).to(ctx.x_dtype)


def dense_count_matmul(C: Tensor, x: Tensor) -> Tensor:
    """Differentiable (R, N) count matrix @ (N, F) features -> (R, F)
    float32."""
    return DenseCountMatmul.apply(C, x)


class GspmmHybrid(torch.autograd.Function):
    """out[v] = sum_{u->v} x[u] through the hybrid: K1 over the remainder
    plus, at the dense rows, C @ x added in float32 and rounded once to x's
    dtype (``_gspmm_hybrid``).  The backward is K1 over the remainder's
    CSR direction, returned in float32, plus Cᵀ @ g[rows], rounded once.
    Returns (N_dst, ``run_width(x, None, rem)``), as ``GspmmSum``
    does."""

    @staticmethod
    def forward(ctx, x: Tensor, hyb: HybridPlan) -> Tensor:
        ctx.hyb = hyb
        ctx.x_meta = (x.dtype, x.shape[1])
        rem = hyb.rem
        out = segment_sum(rem.csc_indptr,
                          pad_columns(x, run_width(x, None, rem)),
                          gidx=rem.src, site="fwd",
                          plan=graph_row_plan(rem, "csc"))
        F = x.shape[1]
        acc = accumulate_dtype(x.dtype)
        d = _dense_matmul(hyb.C, x)
        out[hyb.rows, :F] = (out[hyb.rows, :F].to(acc) + d).to(out.dtype)
        return out

    @staticmethod
    @spanned("ops.gspmm.bwd")
    def backward(ctx, dout: Tensor):
        hyb = ctx.hyb
        rem = hyb.rem
        dtype, F = ctx.x_meta
        dout = dout.contiguous()
        acc = accumulate_dtype(dtype)
        dx = segment_sum(rem.csr_indptr, dout, gidx=rev_gidx(rem),
                         site="rev", plan=graph_row_plan(rem, "csr"),
                         out_dtype=acc)[:, :F]
        dx = dx + _dense_matmul_t(hyb.C, dout[hyb.rows, :F])
        return dx.to(dtype), None


def gspmm_hybrid_route(g, x: Tensor) -> str:
    """The route K1 takes over the remainder in ``gspmm_hybrid(g, x)``'s
    forward (``k1_route``), as ``gspmm_sum_route``."""
    rem = g.derived["hybrid"].rem
    x2 = x.reshape(x.shape[0], -1)
    return segment_sum_launcher(
        rem.csc_indptr, pad_columns(x2, run_width(x2, None, rem)), rem.src,
        plan=graph_row_plan(rem, "csc")).route()


def gspmm_hybrid(g, x: Tensor) -> Tensor:
    """copy_u sum through the graph's dense-hub hybrid
    (``g.derived["hybrid"]``).  x (N, ...) -> (N_dst, ...)."""
    check_cuda_call(x, "gspmm")
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    out = GspmmHybrid.apply(x2, g.derived["hybrid"])[:, :x2.shape[1]]
    return out.reshape((out.shape[0],) + tuple(shape[1:]))


@spanned("ops.prepare")
def prepare_spmm(g, tr: int = 128, te: int = 1024, bc: Optional[int] = None,
                 wc: Optional[int] = None, *, weighted: bool = True,
                 dense_hub: bool = True, dense_threshold: Optional[int] = None,
                 dense_budget: int = 3 << 30, flat="auto",
                 flat_width: int = 128, sddmm: bool = True,
                 bucket_rows="auto", bucket_rows_rev="same", device=None):
    """Ready a graph for the kernels: its CSC and CSR arrays are the plan.

    Places ``csc_indptr``, ``src``, ``csr_indptr``, ``csr_eids`` and
    ``dst[csr_eids]`` on ``device`` (the graph's own device when None) and
    builds K1's row plans of both directions there.  A masked graph gets
    the same over its real-edge view (``real_edges``) and no hybrid.

    ``dense_hub`` builds the dense-hub hybrid as the JAX package does: the
    windows of ``tr`` dst rows that ``select_dense_windows`` picks with
    ``dense_threshold`` and ``dense_budget`` (the default threshold from
    ``_dense_breakeven`` at ``flat_width`` columns, the card's own
    numbers), less those whose counts bf16 cannot hold
    (``_check_dense_exact``), go dense; copy_u sum and mean then run
    through ``gspmm_hybrid`` on either device.  The returned graph carries
    the hybrid in its ``derived`` cache, a new dict: ``g``'s cache is not
    changed by it.  On an H100 the default threshold picks bench.py's one
    hub window, which beat K1 alone, and not the 17 more that bench.py's
    own threshold adds, which lost to it (``K1_NS_PER_EDGE``, PERF.md);
    ``dense_hub=False`` keeps K1 alone.  ``weighted`` is
    accepted and the full plan built either way (weighted=False without
    a dense window keeps it, as in the JAX package); te, bc, wc, flat,
    sddmm, bucket_rows and bucket_rows_rev are the TPU plan's and are
    ignored: the port's kernels read the graph's own index arrays.  A
    graph does not need this call to run the kernels: the row plans are
    otherwise built at first use."""
    if g.csr_indptr is None or g.csr_eids is None:
        raise ValueError("prepare_spmm requires the graph's CSR format")
    if device is not None:
        g = g.to(device)
    kg = on_real_edges(g)[0]
    rev_gidx(kg)
    graph_row_plan(kg, "csc")
    graph_row_plan(kg, "csr")
    hyb = None
    if dense_hub and g.edge_mask is None:
        with span("ops.plans"):
            wins = select_dense_windows(
                g.host("csc_indptr"), g.num_src_nodes, g.num_dst_nodes, tr,
                threshold=dense_threshold, budget_bytes=dense_budget,
                flat_width=flat_width)
            wins = _check_dense_exact(g, wins, tr)
            if wins.size:
                C, rows = _build_dense_C(g, wins, tr)
                hyb = HybridPlan(build_hybrid_plan(g, wins, tr), C, rows,
                                 torch.from_numpy(wins).to(g.device), tr)
    if hyb is None and "hybrid" not in g.derived:
        return g
    out = g.replace()
    out.derived = {k: v for k, v in g.derived.items() if k != "hybrid"}
    if hyb is not None:
        out.derived["hybrid"] = hyb
    return out
