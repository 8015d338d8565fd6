"""K4 and K5, the segment max and its fused argmax backward, and the gspmm
max/min they carry.

``segment_max`` wraps K4 and ``segment_max_bwd`` wraps K5, both in
``csrc/segment_max.cu`` (which replaces the TPU kernels
``dgl_hack_tpu/ops/pallas/spmm_kernel.py:_minmax_kernel`` /
``_minmax_kernel_acc`` and the backward ``_gspmm_fused_max_bwd``);
``segment_max_plain`` and ``segment_max_bwd_plain`` are their plain
PyTorch versions, on the same arguments.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``GspmmMax`` is the counterpart of the JAX package's ``_gspmm_fused_max``
custom VJP, and ``gspmm_max`` of ``gspmm_pallas``'s max/min branch: the
forward returns the raw max (``MINMAX_NEG`` on empty rows, saved for the
backward), the caller zero-fills ``raw <= MINMAX_NEG / 2``, and min is
``-max(-x)``.  The backward finds the argmax edges by float equality of
the recomputed message with the saved raw max, so every tied edge gets
the full cotangent, on either device.

On this card both kernels are bound by the node rows they gather per
edge (x in K4, raw in K5, and g where an edge hits the max), far above
their compulsory bytes, and at F = 602 by how many L2 lines those rows'
slices touch.  The design is K1's (``csrc/rowwalk.cuh``): work items
from the graph's cached row plans (``graph_row_plan``: the CSC
direction's for K4, the CSR direction's for K5), so a hub row is cut into
pieces of ``K1_PIECE`` edges whose partial rows a fix-up combines in
piece order; 16-, 8- or 4-byte loads by ``vector_width`` over every
tensor the kernel touches; several edges in flight per lane group; and
feature slices that keep the gathered array's columns in L2
(``slice_width``).  On the card ``GspmmMax`` lines the slices up with the
L2's 128-byte lines by running over copies of x whose columns are padded
(``run_width``), so that K4 and K5 run at F = 608 where x has 602: K4
over a padded copy of x that lives through the forward only, K5 over the
padded raw and cotangent, while it takes x and writes dx, which it streams
and does not gather, at their own 602 columns (``max_bwd_load_widths``).  K5 with an (E,) weight whose gradient
is wanted runs unsliced: dw[e] sums over all columns, and one warp must
own it for the sum to repeat bitwise (``max_bwd_slice_width``).

Both take bf16 rows as the JAX package's packed path does: x, raw, the
cotangent and dx in one dtype, the weight cast to float32, each message
rounded to x's dtype (``_message``), so that K5 compares the values K4
stored; the max is exact, K5's sums run in float32 and round once.  The
line and slice rules then count two-byte columns (64 to a line).

Unweighted bf16 rows of an even width take the packed walk
(``max_route``; ``csrc/segment_max_packed.cu``, entry points
``segment_max_bf16_packed`` and ``segment_max_bwd_bf16_packed``, launches
counted as ``segment_max_bf16.fwd.packed`` and ``.bwd.packed``): the same
work items, walk and slices, with each gathered row piece kept as loaded,
bf16x2 pairs, which K4 maxes and K5 compares without widening, so a
16-byte load costs half the registers (K5 then loads 16 bytes a lane,
``packed_widths``).  Weighted and odd-width bf16 calls and every float32
call keep ``csrc/segment_max.cu`` (the "walk").  Left for later: K5's g
loads, one scattered load per lane and hit edge; and a slice-major copy in
place of the padded one (no line of a slice would then hold another
slice's columns).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import LAUNCHES, counted, library, ptr, require, run
from .spmm_kernel import (_I32_MAX, FEATURE_DTYPES, SUM_MAX_VALUES, RowPlan,
                          accumulate_dtype, check_cuda_call, checked_plan,
                          edges_per_row, flat_weight, graph_row_plan,
                          kernel_weight, local_rows, on_real_edges,
                          pad_columns, plan_args, plan_scratch, rev_gidx,
                          row_chunks, run_width, slice_width, vector_width)

Tensor = torch.Tensor

MINMAX_NEG = -1e30


def _w_kind(w: Optional[Tensor], E: int, F: int) -> int:
    """0 none, 1 (E,), 2 (E, F); raises on any other weight."""
    if w is None:
        return 0
    if w.dim() == 1 and w.shape[0] == E:
        return 1
    if w.dim() == 2 and tuple(w.shape) == (E, F):
        return 2
    raise ValueError(f"segment max weight of shape {tuple(w.shape)}; "
                     f"expected ({E},) or ({E}, {F})")


def _weighted(m: Tensor, we: Optional[Tensor]) -> Tensor:
    if we is None:
        return m
    return m * (we[:, None] if we.dim() == 1 else we)


def _message(xe: Tensor, we: Optional[Tensor]) -> Tensor:
    """max(x[u] * w[e], MINMAX_NEG) as K4 and K5 form it: the product in
    ``accumulate_dtype`` (float32 for bf16 x, with the weight cast up),
    then clamped and rounded to x's dtype, so that a bf16 message is the
    bf16 value K4 stores and K5 compares."""
    acc = accumulate_dtype(xe.dtype)
    m = _weighted(xe.to(acc), None if we is None else we.to(acc))
    return torch.clamp_min(m, MINMAX_NEG).to(xe.dtype)


# ---------------------------------------------------------------------------
# The route: segment_max.cu's walk or the packed walk
# ---------------------------------------------------------------------------
def max_route(dtype: torch.dtype, w_kind: int, vec: int) -> str:
    """K4's or K5's route on the card: ``"packed"``
    (segment_max_packed.cu) for bf16 rows without a weight at ``vec``
    values a load of 2 or more (``packed_widths``: an even width, the
    gathered arrays 4-byte aligned), else ``"walk"`` (segment_max.cu).

    On an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md) the packed walk
    took K4 4.13 ms against the walk's 6.89 and K5 10.28 against 17.50 at
    synthetic Reddit (640 columns in 64-column slices), K4 1.51 against
    1.60 and K5 1.17 against 1.77 at bench.py's graph (F = 128), and K4
    0.158 against 0.183 and K5 1.62 against 1.99 on the masked layer-0
    block (F = 602, 2 values a load); a route that staged the gathered rows
    in shared memory (cp.async) lost to it at all three.  It takes
    ``slice_width``'s slices, which won its sweep at all three (Reddit: 64
    columns, K4 4.21 ms and K5 10.26 against 5.55 and 10.71 at 128)."""
    if dtype == torch.bfloat16 and w_kind == 0 and vec >= 2:
        return "packed"
    return "walk"


def packed_widths(F: int, rows: Tensor, *more: Tensor) -> int:
    """Values a lane loads on the packed walk over the gathered ``rows``
    (and ``more`` read beside them: K5's g): ``vector_width``'s, up to 8 (16
    bytes; not bound by ``SUM_MAX_VALUES``, since packed pairs cost half
    the registers of widened floats).  On the card (chip_smoke.py,
    PERF.md) 8 values took K5 10.26 ms at Reddit against 11.38 at 4 and
    18.93 at 2, and K4 4.21 against 4.51 and 6.37."""
    return vector_width(F, rows, *more)


# ---------------------------------------------------------------------------
# K4: forward
# ---------------------------------------------------------------------------
def segment_max_plain(indptr: Tensor, x: Tensor, gidx: Tensor,
                      w: Optional[Tensor] = None) -> Tensor:
    """raw[r] = max_{j in [indptr[r], indptr[r+1])} max(x[gidx[j]] * w[j],
    MINMAX_NEG); empty rows give MINMAX_NEG.  w None, (E,) or (E, F), in
    the order of gidx.  raw has x's dtype (each message rounded to it:
    ``_message``).  Rows go in blocks of ``row_chunks``."""
    if x.is_cuda:
        LAUNCHES.add("plain.segment_max")
    out = x.new_full((indptr.numel() - 1, x.shape[1]), MINMAX_NEG)
    for r0, r1, j0, j1 in row_chunks(indptr, x.shape[1]):
        m = _message(x[gidx[j0:j1]], None if w is None else w[j0:j1])
        rows = local_rows(indptr, r0, r1)[:, None].expand_as(m)
        out[r0:r1].scatter_reduce_(0, rows, m, "amax")
    return out


def max_bwd_slice_width(rows: int, F: int, w_kind: int, want_dw: bool,
                        elem_bytes: int = 4,
                        reuse: Optional[float] = None) -> int:
    """Columns per feature slice of K5 over a gathered raw of ``rows``
    rows.  K4 over a gathered x takes K1's rule (``slice_width``) as it
    is, and so does K5, since what must stay in L2 is the same, one slice
    of the array gathered per edge; but an (E,) weight whose gradient is
    wanted takes F (one slice), since dw[e] sums over every column and one
    warp must own that sum.

    On an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), at slice widths
    16 / 32 / 64 / none: over synthetic Reddit at F = 608 (602 padded to
    whole L2 lines) K4 took 14.5 / 7.8 / 11.3 / 19.1 ms and K5 21.4 / 17.7
    / 20.4 / 25.1; at F = 602 unpadded K4 17.9 / 16.6 / 17.4 / 24.6 and K5
    28.3 / 25.6 / 25.5 / 29.9; over bench.py's graph at F = 128 (no slice
    of a 512 MB array fits) K4 5.6 / 3.3 / 3.0 / 2.9 and K5 4.7 / 2.7 / 1.8
    / 1.4.  The rule picks 32 on Reddit and none at bench.py's shape."""
    return F if w_kind == 1 and want_dw else \
        slice_width(rows, F, False, elem_bytes, reuse)


def segment_max(indptr: Tensor, x: Tensor, gidx: Tensor,
                w: Optional[Tensor] = None, *,
                plan: Optional[RowPlan] = None) -> Tensor:
    """K4 wrapper; arguments and result as ``segment_max_plain``.  x (rows,
    F) float32 or bf16; indptr, gidx int32.  ``plan`` is
    ``row_plan(indptr)``, built here when None."""
    if x.device.type == "cpu":
        return segment_max_plain(indptr, x, gidx, w)
    if x.device.type != "cuda":
        raise ValueError(f"segment_max: unsupported device {x.device}")
    launch = segment_max_launcher(indptr, x, gidx, w, plan)
    LAUNCHES.add(f"{counted('segment_max', x.dtype)}.fwd"
                 + (".packed" if launch.route == "packed" else ""))
    return launch(None)


def segment_max_launcher(indptr: Tensor, x: Tensor, gidx: Tensor,
                         w: Optional[Tensor] = None,
                         plan: Optional[RowPlan] = None):
    """Check K4's arguments on CUDA and return ``launch(slice_cols, vec,
    route)``, which runs the kernel on ``route`` (None: ``launch.route``,
    ``max_route``'s; ``launch.routes`` lists those that take the call) at
    that slice width and load width, or at ``slice_width``'s and
    ``vector_width``'s where None, and returns raw.  ``segment_max``
    launches through it; ``chip_smoke.py`` times the routes, slice and load
    widths with it."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"segment_max takes x of shape (rows, F), got "
                         f"{tuple(x.shape)}")
    num_rows, F, E = indptr.numel() - 1, x.shape[1], gidx.numel()
    require(x, "x", FEATURE_DTYPES, dev)
    require(indptr, "indptr", torch.int32, dev)
    require(gidx, "gidx", torch.int32, dev)
    w_kind = _w_kind(w, E, F)
    if w is not None:
        require(w, "w", FEATURE_DTYPES, dev)
        w = kernel_weight(w)
    if max(num_rows, E, x.shape[0]) > _I32_MAX:
        raise ValueError("segment_max: sizes exceed the int32 index range")
    plan = checked_plan(plan, indptr, "segment_max")
    vec_rule = vector_width(F, x, w if w_kind == 2 else None)
    reuse = edges_per_row(E, x.shape[0], num_rows)
    entry = "segment_max_f32" if x.dtype == torch.float32 \
        else "segment_max_bf16"

    def launch(slice_cols: Optional[int] = None, vec: Optional[int] = None,
               route: Optional[str] = None) -> Tensor:
        route = route or launch.route
        vec = vec or vec_rule
        if slice_cols is None:
            slice_cols = slice_width(x.shape[0], F, False, x.element_size(),
                                     reuse)
        out = torch.empty((num_rows, F), dtype=x.dtype, device=dev)
        scratch = plan_args(plan, plan_scratch(plan, F))
        if route == "packed":
            _check_packed("segment_max", launch.routes, F, slice_cols, vec,
                          x)
            run("segment_max", library().segment_max_bf16_packed, dev,
                ptr(indptr), ptr(gidx), ptr(x), ptr(out), num_rows, F, vec,
                slice_cols, *scratch)
        else:
            run("segment_max", getattr(library(), entry), dev,
                ptr(indptr), ptr(gidx), ptr(x), ptr(w), w_kind, ptr(out),
                num_rows, F, vec, slice_cols, *scratch)
        return out
    launch.route = max_route(x.dtype, w_kind, vec_rule)
    launch.routes = ("walk", "packed") if launch.route == "packed" \
        else ("walk",)
    return launch


def _check_packed(what: str, routes, F: int, slice_cols: int, vec: int,
                  *rows: Tensor) -> None:
    """Raise where the packed walk does not take a launch: a call it is
    not a route of (float32, weighted, odd widths), or a load width under
    2, not dividing F and the slice, or that the gathered rows' alignment
    does not allow."""
    if "packed" not in routes or vec < 2 or F % vec or slice_cols % vec \
            or any(t.data_ptr() % (2 * vec) for t in rows):
        raise ValueError(f"{what}: no packed route at F={F}, slice "
                         f"{slice_cols}, {vec} values a load")


# ---------------------------------------------------------------------------
# K5: the argmax backward
# ---------------------------------------------------------------------------
def segment_max_bwd_plain(csr_indptr: Tensor, dst_csr: Tensor,
                          csr_eids: Tensor, x: Tensor, w: Optional[Tensor],
                          raw: Tensor, g: Tensor, want_dw: bool = True,
                          acc_dtype: Optional[torch.dtype] = None
                          ) -> Tuple[Tensor, Optional[Tensor]]:
    """Plain version of K5.  Over each src row u's out-edges j (v =
    dst_csr[j], e = csr_eids[j]): m = max(x[u] * w[e], MINMAX_NEG), eq =
    (m == raw[v]);  dx[u] = sum_j eq * g[v] * w[e];  dw[e] = sum_f eq *
    x[u] * g[v] for (E,) weights, elementwise for (E, F).  The comparison
    runs on the message rounded to x's dtype (``_message``); the products
    and sums in ``acc_dtype`` when given (a float64 reference can check
    the float32 kernel; dx and dw come back in it), else in float32 for
    bf16 x (dx rounded once to x's dtype, dw cast to w's) and in x's dtype
    otherwise.  An x of fewer columns than raw and g stands for x with
    zero columns added (no (E, F) weight then), and dx has x's columns.
    Returns (dx, dw), dw None without w or ``want_dw``."""
    if x.is_cuda:
        LAUNCHES.add("plain.segment_max_bwd")
    acc = acc_dtype or accumulate_dtype(x.dtype)
    dx_dtype = acc_dtype or x.dtype
    dw_dtype = acc_dtype or (None if w is None else w.dtype)
    Fx = x.shape[1]
    x = pad_columns(x, raw.shape[1])
    Ns, F = x.shape
    dx = torch.zeros((Ns, F), dtype=acc, device=x.device)
    dw = None
    if w is not None and want_dw:
        dw = torch.empty(w.shape, dtype=acc, device=x.device)
    for r0, r1, j0, j1 in row_chunks(csr_indptr, F):
        rows = local_rows(csr_indptr, r0, r1)
        v = dst_csr[j0:j1].long()
        e = csr_eids[j0:j1].long()
        xu = x[r0:r1][rows]
        we = None if w is None else w[e]
        eq = _message(xu, we) == raw[v]
        gv = torch.where(eq, g[v].to(acc), 0.0)
        we_acc = None if we is None else we.to(acc)
        dx[r0:r1].index_add_(0, rows, _weighted(gv, we_acc))
        if dw is not None:
            prod = xu.to(acc) * gv
            dw[e] = prod.sum(-1) if w.dim() == 1 else prod
    return (dx[:, :Fx].to(dx_dtype),
            None if dw is None else dw.to(dw_dtype))


def max_bwd_load_widths(F: int, x: Tensor, w: Optional[Tensor], raw: Tensor,
                        g: Tensor) -> Tuple[int, int]:
    """Values per load of K5: (of raw, g and an (E, F) weight, which set
    the columns a lane owns; of x, and per store of dx).  Each is
    ``vector_width``'s over its tensors' width and alignment, at most
    ``SUM_MAX_VALUES``, the second at most the first."""
    vec = vector_width(F, raw, g, w if w is not None and w.dim() == 2
                       else None, max_values=SUM_MAX_VALUES)
    return vec, min(vec, vector_width(x.shape[1], x))


def segment_max_bwd(csr_indptr: Tensor, dst_csr: Tensor, csr_eids: Tensor,
                    x: Tensor, w: Optional[Tensor], raw: Tensor, g: Tensor,
                    want_dw: bool = True, *, plan: Optional[RowPlan] = None
                    ) -> Tuple[Tensor, Optional[Tensor]]:
    """K5 wrapper; arguments and results as ``segment_max_bwd_plain``.
    x (N_src, Fx), raw and g (N_dst, F) of one dtype, float32 or bf16, Fx
    <= F; index arrays int32.  ``plan`` is ``row_plan(csr_indptr)``, built
    here when None."""
    if x.device.type == "cpu":
        return segment_max_bwd_plain(csr_indptr, dst_csr, csr_eids, x, w,
                                     raw, g, want_dw)
    if x.device.type != "cuda":
        raise ValueError(f"segment_max_bwd: unsupported device {x.device}")
    launch = segment_max_bwd_launcher(csr_indptr, dst_csr, csr_eids, x, w,
                                      raw, g, want_dw, plan)
    LAUNCHES.add(f"{counted('segment_max', x.dtype)}.bwd"
                 + (".packed" if launch.route == "packed" else ""))
    return launch(None)


def segment_max_bwd_launcher(csr_indptr: Tensor, dst_csr: Tensor,
                             csr_eids: Tensor, x: Tensor,
                             w: Optional[Tensor], raw: Tensor, g: Tensor,
                             want_dw: bool = True,
                             plan: Optional[RowPlan] = None):
    """Check K5's arguments on CUDA and return ``launch(slice_cols, vec,
    route)``, which runs the kernel on ``route`` (None: ``launch.route``,
    ``max_route``'s; ``launch.routes`` lists those that take the call) at
    that slice width and load width (of raw and g; x's is the narrower of
    it and x's own), or at ``max_bwd_slice_width``'s and
    ``max_bwd_load_widths``' (``packed_widths``' on the packed walk) where
    None, and returns (dx, dw)."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"segment_max_bwd takes x of shape (rows, F), got "
                         f"{tuple(x.shape)}")
    Ns, Fx = x.shape
    F = raw.shape[-1]
    E = csr_eids.numel()
    require(csr_indptr, "csr_indptr", torch.int32, dev, Ns + 1)
    require(dst_csr, "dst_csr", torch.int32, dev, E)
    require(csr_eids, "csr_eids", torch.int32, dev)
    require(x, "x", FEATURE_DTYPES, dev)
    require(raw, "raw", x.dtype, dev)
    require(g, "g", x.dtype, dev, raw.numel())
    if raw.dim() != 2 or Fx > F:
        raise ValueError(f"raw of shape {tuple(raw.shape)} for x of "
                         f"{Fx} columns")
    w_kind = _w_kind(w, E, F)
    if w_kind == 2 and Fx != F:
        raise ValueError(f"an (E, F) weight needs x at raw's {F} columns, "
                         f"got {Fx}")
    w_dtype = None if w is None else w.dtype
    if w is not None:
        require(w, "w", FEATURE_DTYPES, dev)
        w = kernel_weight(w)
    if max(Ns, E, raw.shape[0]) > _I32_MAX:
        raise ValueError("segment_max_bwd: sizes exceed the int32 index "
                         "range")
    want_dw = want_dw and w is not None
    plan = checked_plan(plan, csr_indptr, "segment_max_bwd")
    vec_walk = max_bwd_load_widths(F, x, w, raw, g)[0]
    vec_packed = packed_widths(F, raw, g)
    reuse = edges_per_row(E, raw.shape[0], Ns)
    entry = "segment_max_bwd_f32" if x.dtype == torch.float32 \
        else "segment_max_bwd_bf16"

    def launch(slice_cols: Optional[int] = None, vec: Optional[int] = None,
               route: Optional[str] = None
               ) -> Tuple[Tensor, Optional[Tensor]]:
        route = route or launch.route
        vec = vec or (vec_packed if route == "packed" else vec_walk)
        vec_x = min(vec, vector_width(Fx, x))
        if slice_cols is None:
            slice_cols = max_bwd_slice_width(raw.shape[0], F, w_kind, want_dw,
                                             raw.element_size(), reuse)
        dx = torch.empty((Ns, Fx), dtype=x.dtype, device=dev)
        dw = torch.empty(w.shape, dtype=torch.float32, device=dev) \
            if want_dw else None
        scratch = plan_args(plan, plan_scratch(plan, Fx))
        if route == "packed":
            _check_packed("segment_max_bwd", launch.routes, F, slice_cols,
                          vec, raw, g)
            run("segment_max_bwd", library().segment_max_bwd_bf16_packed,
                dev, ptr(csr_indptr), ptr(dst_csr), ptr(x), ptr(raw),
                ptr(g), ptr(dx), Ns, F, Fx, vec, vec_x, slice_cols,
                *scratch)
        else:
            run("segment_max_bwd", getattr(library(), entry), dev,
                ptr(csr_indptr), ptr(dst_csr), ptr(csr_eids), ptr(x),
                ptr(w), w_kind, ptr(raw), ptr(g), ptr(dx), ptr(dw), Ns, F,
                Fx, vec, vec_x, slice_cols, *scratch)
        return dx, None if dw is None else dw.to(w_dtype)
    launch.route = max_route(x.dtype, w_kind, vec_packed)
    launch.routes = ("walk", "packed") if launch.route == "packed" \
        else ("walk",)
    return launch


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class GspmmMax(torch.autograd.Function):
    """raw[v] = max_{e=(u,v)} max(x[u] * w[e], MINMAX_NEG) over the graph's
    CSC direction (K4); the backward walks the CSR direction (K5).

    x (N_src, F); w None, (E,) or (E, F) in internal edge order.  Returns
    (N_dst, ``run_width(x, w, g)``): K4 runs over a padded copy of x, and the
    caller cuts the result back to F columns, so that autograd hands the
    backward a padded cotangent.  What is saved is the caller's x, which
    K5 takes as it is, so the padded copy lives through the forward
    only."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Optional[Tensor], g) -> Tensor:
        raw = segment_max(g.csc_indptr, pad_columns(x, run_width(x, w, g)),
                          g.src, w, plan=graph_row_plan(g, "csc"))
        ctx.g = g
        ctx.save_for_backward(x, w, raw)
        return raw

    @staticmethod
    def backward(ctx, draw: Tensor):
        x, w, raw = ctx.saved_tensors
        g = ctx.g
        want_dw = w is not None and ctx.needs_input_grad[1]
        dx, dw = segment_max_bwd(g.csr_indptr, rev_gidx(g), g.csr_eids, x,
                                 w, raw, draw.contiguous(), want_dw,
                                 plan=graph_row_plan(g, "csr"))
        return dx if ctx.needs_input_grad[0] else None, dw, None


def gspmm_max(g, x: Tensor, w: Optional[Tensor] = None,
              reduce_op: str = "max") -> Tensor:
    """copy_u / u_mul_e max or min through K4 (K5 in the backward).  x (N,
    ...) and w (E,), (E, 1...) or (E, ...) broadcastable to x's feature
    shape.  Zero in-degree rows, and rows whose every message is at or
    below MINMAX_NEG / 2, give 0.  Returns (N_dst, ...).  On the card K4
    and K5 run over a wide x at ``run_width``'s padded width.  A masked
    graph runs over its real-edge view, so a row whose edges are all
    padding is empty and gives 0."""
    if reduce_op not in ("max", "min"):
        raise ValueError(f"gspmm_max takes max or min, got {reduce_op!r}")
    check_cuda_call(x, f"gspmm {reduce_op}")
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    if reduce_op == "min":
        x2 = -x2
    g, w = on_real_edges(g, flat_weight(w, shape))
    raw = GspmmMax.apply(x2, w, g)[:, :x2.shape[1]]
    val = -raw if reduce_op == "min" else raw
    out = torch.where(raw > MINMAX_NEG * 0.5, val, torch.zeros_like(val))
    return out.reshape((out.shape[0],) + tuple(shape[1:]))


def gspmm_max_routes(g, x: Tensor, w: Optional[Tensor] = None
                     ) -> Tuple[str, str]:
    """(K4's, K5's) route in ``gspmm_max(g, x, w)`` on the card
    (``max_route`` at the width ``GspmmMax`` runs, over x's padded copy
    and a fresh raw and cotangent).  For the dispatch log."""
    shape = x.shape
    x2 = x.reshape(shape[0], -1)
    g, w = on_real_edges(g, flat_weight(w, shape))
    F = run_width(x2, w, g)
    w_kind = _w_kind(w, g.num_edges(), F)
    fresh = torch.empty((1, F), dtype=x.dtype, device="meta")
    x_run = x2 if F == x2.shape[1] else fresh
    return (max_route(x.dtype, w_kind, vector_width(F, x_run)),
            max_route(x.dtype, w_kind, packed_widths(F, fresh, fresh)))
