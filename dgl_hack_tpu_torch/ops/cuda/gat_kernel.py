"""K2 and K3, the fused GAT edge phase, and the autograd.Function that
joins them.

``gat_fwd`` wraps ``csrc/gat_fwd.cu`` (which replaces the TPU kernels
``dgl_hack_tpu/ops/pallas/gat_kernel.py:_gat_kernel_shift`` and
``_gat_kernel``); ``gat_bwd`` wraps ``csrc/gat_bwd.cu`` (which replaces
``_gat_bwd_kernel``).  ``gat_fwd_plain`` and ``gat_bwd_plain`` are their
plain PyTorch versions, on the same arguments.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.

``GatFused`` is the counterpart of the JAX package's ``_gat_fused``
custom VJP: the forward saves rst, den and the per-dst shift; the backward
computes sds in torch, runs K3 over the CSR direction, then K1 in
edge-row mode over the CSC direction for der.

On the card both kernels are bound by the rows they gather per edge (Wh[u]
in K2; dout[v] and the dst's er, shift, den and sds in K3), and short of
that by how many of those loads a warp keeps in flight and how many
scattered requests each edge costs.  Their design is that of K1, K4 and K5
(``csrc/rowwalk.cuh``) with the lanes laid out by head: work items from
the graph's cached row plans (``graph_row_plan``: CSC for K2, CSR for K3),
so a hub row is cut into pieces of ``K1_PIECE`` edges whose partial rows
(num and den in K2, dWh and del in K3) a fix-up adds in piece order; the
edge walk with indices loaded a chunk ahead and several edges in flight;
16-, 8- or 4-byte loads by ``vector_width`` over every tensor read or
written in rows, over the head width D; a head's per-edge work (K2's logit
and exp, K3's dot and epilogue) done by the head's own lanes, as few as
hold its D columns in ``K2_LANE_FLOATS`` / ``K3_LANE_FLOATS`` floats each,
the dot reduced by shuffles in a fixed order; accumulators in registers.
K3 reads the dst's four (N, H) operands packed into one (N, H, 4) array
(one 16-byte load, where four 4-byte loads cost four scattered requests)
and writes dw only where attn_w wants a gradient (GAT's dropout mask does
not).  No feature slices: slices of whole heads lost on the card at every
width (PERF.md).  Any H * D that K2 takes, K3 takes: a head wider than one pass goes in
passes, and no shared memory is used.  'exact' mode takes the per-dst max
first with K4 over el (``exact_shift``), so its pieces need no rescaling.
A masked graph runs both kernels over its real-edge view
(``on_real_edges``), attn_w gathered into the view's order: the padded
edges are left out of the softmax and the sum, and attn_w's gradient is
0 there.

Wh may be bf16: the JAX package's packed z (``_pack_z``: bf16 features,
float32 logits) and its bf16 ``gat_attention_pallas`` (bf16 operands
upcast into a float32 z, the result rounded once to fsrc's dtype).  Both
kernels widen Wh on the load; el, er, w, the sums and every output stay
float32.  ``GatFused`` rounds Wh to bf16 once in packed mode and saves
that copy, so the backward differentiates the function the forward ran
(``_gat_fused_bwd``'s zt), straight through the rounding: dWh is float32.
A bf16 fsrc gets its gradient rounded once to bf16.

A bf16 Wh takes the staged route (``gat_route``; ``gat_fwd_bf16_staged``,
``gat_bwd_bf16_staged`` over ``csrc/stage.cuh``; launches counted as
``gat_fwd_bf16.staged`` and ``gat_bwd_bf16.staged``) wherever its heads
fit one lane group (``stage_shape``), else the head-major walk
(``gat_fwd_bf16``, ``gat_bwd_bf16``: 4 heads of 256, say).  On the
head-major walk bf16 bought nothing (K2 2.06 ms against float32's 1.83 at
synthetic Reddit's hidden layer on an H100 80GB HBM3 at 700 W): the rows
a warp has in flight cost registers.  The staged route gathers each
edge's rows into a ring of ``STAGES`` stages in shared memory with
cp.async and works on one while the next arrives; a head width whose bf16
row is no whole number of 16-byte pieces is read from a copy padded with
zero columns (``padded_head_width``, ``pad_heads``; never the caller's
tensor), and results are written at the caller's width.  K3 gathers dout
in bf16 where its values are bf16 ones (``bf16_dout``: a bf16 fsrc) and
runs in passes over ranges of dst nodes where the dst rows it gathers
exceed the L2 (``k3_passes``, ``dst_cuts``).  What bounds both is the
rows gathered from the L2 and the warps an SM that the rings leave room
for (PERF.md §6 has the times: K2 1.44 ms, K3 3.69 at Reddit's hidden
layer, no dw).
"""
from __future__ import annotations

import math
import weakref
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...utils.profiling import span, spanned
from .build import LAUNCHES, counted, library, ptr, require, run
from .segment_max_kernel import MINMAX_NEG, segment_max
from .spmm_kernel import (_I32_MAX, FEATURE_DTYPES, RowPlan,
                          check_cuda_call, checked_plan, graph_row_plan,
                          on_real_edges, plan_args, rev_gidx, segment_sum,
                          vector_width, widened)

Tensor = torch.Tensor

NEG = -1e30               # shift of an empty row in 'exact' mode
# The most floats of an edge's row that a lane holds (csrc/rowwalk.cuh:
# head_shape): fewer lanes per edge put more edges in flight, more floats
# per lane cost registers.  Chosen per kernel from chip_smoke.py's sweep
# (PERF.md): K2 8, K3 4.
K2_LANE_FLOATS = 8
K3_LANE_FLOATS = 4
# Values per load of a bf16 Wh (8: one 16-byte load; 4: 8 bytes).  K2's
# from chip_smoke.py's sweep on an H100 (80GB HBM3, 700 W): at synthetic
# Reddit's hidden layer 4 took 2.071 ms and 8 2.095 (PERF.md).
# K3 reads Wh once per src row and gathers float32 dout, so it keeps
# float32's width.
K2_BF16_VALUES = 4
K3_BF16_VALUES = 4

# The staged route over a bf16 Wh (csrc/stage.cuh; ``gat_route``): a warp
# gathers each edge's rows into a ring of ``STAGES`` stages in shared
# memory with cp.async, and works on one stage while the next arrives.  A
# stage holds the most of 32, 16 or 8 edges whose records fit
# ``STAGE_BYTES`` (a stage's edges: ``stage_shape``); blocks of
# ``STAGE_WARPS`` warps take STAGE_WARPS * stages * (edges * record + 4 *
# edges) bytes of shared memory, at most ``STAGE_SMEM``.  From
# chip_smoke.py's sweep on an H100 (80GB HBM3, 700 W; PERF.md): more
# stages or larger ones hold fewer warps an SM and lost at every shape.
STAGE_WARPS = 4
STAGE_SMEM = 232_448
STAGES = 2
STAGE_BYTES = 4096
# a staged lane holds up to 8 values of an edge's row (rowwalk.cuh:
# kLaneFloatsMax): one 16-byte load of bf16, or two of float32 dout
STAGED_LANE_FLOATS = 8
# K3 gathers the dst's dout row and packed (er, shift, den, sds) per edge:
# where those rows of all dst nodes hold more than ``K3_PASS_BYTES``, the
# staged K3 runs in passes over ranges of dst nodes whose rows fit the L2
# together (``k3_passes``; a CSR row's edges are sorted by dst, so a pass
# takes a run of each row, ``dst_cuts``).
K3_PASS_BYTES = 30_000_000
K3_PASSES_MAX = 8


def _widened(wh: Tensor, like: Tensor) -> Tensor:
    """wh (float32 or bf16) in the plain versions' working dtype: that of
    ``like`` (el), at least float32, so a bf16 Wh is summed in float32 (or
    float64 where a reference runs so)."""
    return wh.to(torch.promote_types(like.dtype, torch.float32))


def _rows(indptr: Tensor) -> Tensor:
    n = indptr.numel() - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)


def shift_bound(el: Tensor, er: Tensor, slope: float) -> Tensor:
    """'shift' mode subtrahend c[v] = leaky(max_u el[u] + er[v]) (leaky is
    monotone, so every logit into v is <= c[v] and exp(logit - c) <= 1)."""
    elmax = el.max(0).values if el.shape[0] else el.new_zeros(el.shape[1])
    return F.leaky_relu(elmax[None, :] + er, slope)


def exact_shift(elmax: Tensor, er: Tensor, slope: float) -> Tensor:
    """'exact' mode subtrahend: the per-dst max of leaky(el[u] + er[v]) from
    elmax[v] = max_u el[u] (K4's result, ``MINMAX_NEG`` on an empty row).
    leaky and the rounded add are monotone, so leaky(elmax + er) is the max
    over the row's logits bit for bit; an empty row gets ``NEG``."""
    return torch.where(elmax > MINMAX_NEG * 0.5,
                       F.leaky_relu(elmax + er, slope),
                       torch.full_like(er, NEG)).contiguous()


# ---------------------------------------------------------------------------
# The staged route's shapes (pure functions; the CPU tests hold them)
# ---------------------------------------------------------------------------
def padded_head_width(H: int, D: int) -> int:
    """The head width Dp >= D of the staged rows: D rounded up until a row
    of H heads of bf16 is whole 16-byte pieces (8 | H * Dp), each head
    padded alike (41 -> 48 at H = 1; 8 at H = 8 is its own)."""
    step = 8 // math.gcd(H, 8)
    return -(-D // step) * step


def stage_vec(Dp: int, values: int = 8) -> int:
    """Values per load of a staged row: the most of 8, 4, 2, 1, at most
    ``values``, that divides the head width Dp."""
    return next(v for v in (8, 4, 2, 1) if Dp % v == 0 and v <= values)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def head_layout(H: int, D: int, vec: int, lane_floats: int) -> dict:
    """rowwalk.cuh:head_shape's lane layout: Lh lanes a head, NC chunks of
    vec columns a lane, nchunk passes over a head's columns, lanes a lane
    group, Hp heads a group."""
    lane_floats = max(lane_floats, vec)
    per_head = D // vec
    max_nc = lane_floats // vec
    Lh = min(_pow2(-(-per_head // max_nc)), 32)
    NC = min(_pow2(-(-per_head // Lh)), max_nc)
    lanes = min(Lh * _pow2(H), 32)
    return {"Lh": Lh, "NC": NC, "nchunk": -(-D // (Lh * vec * NC)),
            "lanes": lanes, "Hp": lanes // Lh}


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def record_bytes(kernel: str, H: int, Dp: int, with_w: bool,
                 dout_bf16: bool = False) -> int:
    """Bytes of an edge's record in a stage (stage.cuh:add_segment): K2
    ("fwd") its Wh row in bf16 and its el row, K3 ("bwd") the dst's dout
    row (float32, or bf16 with ``dout_bf16``) and its packed (er, shift,
    den, sds); each with its w row where attn_w is given; each segment
    rounded up to 16 bytes."""
    if kernel == "fwd":
        rows = _round16(2 * H * Dp) + _round16(4 * H)
    else:
        rows = _round16((2 if dout_bf16 else 4) * H * Dp) + 16 * H
    return rows + (_round16(4 * H) if with_w else 0)


def stage_shape(kernel: str, H: int, D: int, with_w: bool = True,
                dout_bf16: bool = False, stages: Optional[int] = None,
                edges: Optional[int] = None,
                values: Optional[int] = None) -> Optional[dict]:
    """The staged route's shape for K2 (``kernel`` "fwd") or K3 ("bwd") at
    H heads of D columns: the padded head width Dp, the load width vec, the
    head layout at ``STAGED_LANE_FLOATS``, the stages and edges a stage
    (None: ``STAGES``, and the most of 32, 16, 8 edges whose records fit
    ``STAGE_BYTES``; fewer edges, then fewer stages, where the ring would
    not fit ``STAGE_SMEM``), the record and the block's shared memory.
    ``values`` caps the load width (None: 8, a 16-byte load; fewer values a
    load give a head more lanes).  None where the staged kernels do not
    take the shape: a head layout of more than one pass (heads or columns
    past one lane group) or no ring that fits."""
    Dp = padded_head_width(H, D)
    vec = stage_vec(Dp, values or 8)
    lay = head_layout(H, Dp, vec, STAGED_LANE_FLOATS)
    if lay["nchunk"] != 1 or lay["Hp"] < H:
        return None
    rec = record_bytes(kernel, H, Dp, with_w, dout_bf16)
    S = stages or STAGES
    C = edges or next((c for c in (32, 16) if c * rec <= STAGE_BYTES), 8)
    while True:
        smem = STAGE_WARPS * S * (C * rec + _round16(4 * C))
        if smem <= STAGE_SMEM:
            break
        if C > 8:
            C //= 2
        elif S > 2:
            S -= 1
        else:
            return None
    return {"Dp": Dp, "vec": vec, "lane_floats": STAGED_LANE_FLOATS, **lay,
            "stages": S, "edges": C, "record": rec, "smem": smem}


def gat_route(kernel: str, H: int, D: int, dtype: torch.dtype) -> str:
    """K2's or K3's route on the card: ``"staged"`` (stage.cuh) for a bf16
    Wh where ``stage_shape`` takes the shape (its widest record: with w,
    and a float32 dout), else ``"rows"`` (rowwalk.cuh's head-major walk,
    float32 Wh always)."""
    if dtype == torch.bfloat16 and stage_shape(kernel, H, D) is not None:
        return "staged"
    return "rows"


def k3_passes(num_dst: int, H: int, D: int, with_w: bool = True,
              dout_bf16: bool = False) -> int:
    """Passes of the staged K3 over ranges of dst nodes: the fewest whose
    gathered rows (dout and the packed dst operands of ``record_bytes``)
    hold at most ``K3_PASS_BYTES`` a pass, at most ``K3_PASSES_MAX``."""
    rows = record_bytes("bwd", H, padded_head_width(H, D), False, dout_bf16)
    return max(1, min(K3_PASSES_MAX, -(-num_dst * rows // K3_PASS_BYTES)))


def dst_cuts(csr_indptr: Tensor, dst_csr: Tensor, num_dst: int,
             passes: int) -> Tensor:
    """(passes - 1, N_src) int32: entry [k, u] is the first CSR position of
    row u whose dst is at least ceil((k + 1) * num_dst / passes), or the
    row's end (each row's dst ascend: the CSR order is a stable sort of
    the dst-sorted edges by src)."""
    Ns = csr_indptr.numel() - 1
    rows = _rows(csr_indptr)
    out = torch.empty((passes - 1, Ns), dtype=torch.int32,
                      device=dst_csr.device)
    for k in range(1, passes):
        below = (dst_csr < -(-k * num_dst // passes)).int()
        cnt = torch.zeros(Ns, dtype=torch.int32, device=dst_csr.device)
        out[k - 1] = csr_indptr[:-1] + cnt.index_add_(0, rows, below)
    return out


# dst_cuts of a graph's CSR arrays: {id(dst_csr): (weakref, passes, cuts)}
_CUTS: dict = {}


def _cached_cuts(csr_indptr: Tensor, dst_csr: Tensor, num_dst: int,
                 passes: int) -> Tensor:
    """``dst_cuts``, kept while dst_csr lives (a graph's ``rev_gidx`` is
    cached on the graph, so a graph's backward passes build them once)."""
    hit = _CUTS.get(id(dst_csr))
    if hit is not None and hit[0]() is dst_csr and hit[1] == passes:
        return hit[2]
    for key in [k for k, v in _CUTS.items() if v[0]() is None]:
        del _CUTS[key]
    with span("ops.plans"):
        cuts = dst_cuts(csr_indptr, dst_csr, num_dst, passes)
    _CUTS[id(dst_csr)] = (weakref.ref(dst_csr), passes, cuts)
    return cuts


def pad_heads(x: Tensor, H: int, D: int, Dp: int,
              dtype: Optional[torch.dtype] = None) -> Tensor:
    """A copy of x (N, H*D) as (N, H*Dp) in ``dtype`` (None: x's), each
    head's columns [D, Dp) zero: the staged rows at ``padded_head_width``.
    x itself is not changed."""
    N = x.shape[0]
    out = x.new_empty((N, H, Dp), dtype=dtype or x.dtype)
    out[:, :, D:] = 0
    out[:, :, :D] = x.view(N, H, D)
    return out.view(N, H * Dp)


def bf16_dout(fdtype: torch.dtype) -> bool:
    """Whether K3 may gather a bf16 copy of GatFused's float32 dout: only
    where fsrc is bf16, since ``gat_attention_fused`` then rounds the
    result to bf16 and that cast, its only consumer, hands back a dout of
    bf16 values (the copy is exact).  A float32 fsrc, packed or not, gets
    a general float32 dout (the JAX fused path's ``g.astype(float32)``)."""
    return fdtype == torch.bfloat16


def _staged_rows(x: Tensor, H: int, D: int, Dp: int,
                 dtype: Optional[torch.dtype] = None) -> Tensor:
    """x as the staged kernels read it: itself where it is already rows of
    ``Dp`` columns a head in ``dtype``, 16-byte aligned; else a padded
    copy (``pad_heads``)."""
    if Dp == D and (dtype is None or x.dtype == dtype) \
            and x.data_ptr() % 16 == 0:
        return x
    return pad_heads(x, H, D, Dp, dtype)


def _gran(t: Optional[Tensor], nbytes: int) -> int:
    """Bytes a copy of a row of ``nbytes`` of t: the most of 16, 8, 4 that
    divides the row and t's alignment."""
    if t is None:
        return 4
    return next(g for g in (16, 8, 4)
                if nbytes % g == 0 and t.data_ptr() % g == 0)


def _scratch(plan: RowPlan, HD: int, H: int, dev) -> Optional[Tensor]:
    """The pieces' partial rows, (P, H*D) then (P, H), or None."""
    P = plan.pieces.shape[0]
    return torch.empty(P * (HD + H), dtype=torch.float32, device=dev) \
        if P else None


# ---------------------------------------------------------------------------
# K2: forward
# ---------------------------------------------------------------------------
def gat_fwd_plain(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor,
                  er: Tensor, w: Optional[Tensor], shift: Optional[Tensor],
                  slope: float, exact: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K2.  wh (N_src, H*D), float32 or bf16, el (N_src,
    H), er (N_dst, H), w (E, H) or None, shift (N_dst, H) ('shift' mode)
    or None ('exact').  Returns rst (N_dst, H*D), den (N_dst, H), shift
    (N_dst, H), in el's dtype (a bf16 wh is widened first)."""
    if wh.is_cuda:
        LAUNCHES.add("plain.gat_fwd")
    wh = _widened(wh, el)
    N, H = er.shape
    D = wh.shape[1] // H
    rows = _rows(indptr)
    logit = F.leaky_relu(el[src] + er[rows], slope)                    # (E, H)
    if exact:
        shift = torch.full((N, H), NEG, dtype=logit.dtype,
                           device=logit.device)
        idx = rows[:, None].expand_as(logit)
        shift = shift.scatter_reduce(0, idx, logit, "amax", include_self=True)
    p = torch.exp(logit - shift[rows])
    pw = p * w if w is not None else p
    msg = pw[:, :, None] * wh.view(-1, H, D)[src]
    num = wh.new_zeros((N, H, D)).index_add(0, rows, msg)
    den = p.new_zeros((N, H)).index_add(0, rows, p)
    rst = num / torch.where(den > 0, den, torch.ones_like(den))[:, :, None]
    return rst.reshape(N, H * D), den, shift


@spanned("kernel.k2")
def gat_fwd(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor, er: Tensor,
            w: Optional[Tensor], shift: Optional[Tensor], slope: float,
            exact: bool, *, plan: Optional[RowPlan] = None
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 wrapper; arguments and results as ``gat_fwd_plain``.  ``plan`` is
    ``row_plan(indptr)``, built here when None.  In 'exact' mode K4 takes
    the per-dst max of el first (``exact_shift``)."""
    if wh.device.type == "cpu":
        return gat_fwd_plain(indptr, src, wh, el, er, w, shift, slope, exact)
    if wh.device.type != "cuda":
        raise ValueError(f"gat_fwd: unsupported device {wh.device}")
    launch, shift = gat_fwd_launcher(indptr, src, wh, el, er, w, shift, slope,
                                     exact, plan)
    LAUNCHES.add(counted("gat_fwd", wh.dtype)
                 + (".staged" if launch.route == "staged" else ""))
    rst, den = launch()
    return rst, den, shift


def gat_fwd_launcher(indptr: Tensor, src: Tensor, wh: Tensor, el: Tensor,
                     er: Tensor, w: Optional[Tensor], shift: Optional[Tensor],
                     slope: float, exact: bool,
                     plan: Optional[RowPlan] = None):
    """Check K2's arguments on CUDA, take the 'exact' shift (K4), and
    return ``(launch, shift)``: ``launch(lane_floats, values, route,
    stages, edges)`` runs the kernel on ``route`` (None: ``launch.route``,
    ``gat_route``'s) and returns (rst, den).  The head-major walk
    ("rows") takes ``lane_floats`` values per lane (None:
    ``K2_LANE_FLOATS``) and at most ``values`` per load (None: 4 of
    float32, ``K2_BF16_VALUES`` of bf16); the staged route (bf16 Wh only)
    at most ``values`` per load, ``stages`` and ``edges`` a stage (None:
    ``stage_shape``'s) over Wh padded to ``padded_head_width``.
    ``gat_fwd`` launches through it; ``chip_smoke.py`` sweeps it."""
    dev = wh.device
    N, H = er.shape
    HD = wh.shape[1]
    if H == 0 or HD % H:
        raise ValueError(f"gat_fwd: width {HD} is not a multiple of H={H}")
    D = HD // H
    E = src.numel()
    require(indptr, "indptr", torch.int32, dev, N + 1)
    require(src, "src", torch.int32, dev)
    require(wh, "wh", FEATURE_DTYPES, dev)
    require(el, "el", torch.float32, dev, wh.shape[0] * H)
    require(er, "er", torch.float32, dev)
    if w is not None:
        require(w, "w", torch.float32, dev, E * H)
    if max(N, E, wh.shape[0]) > _I32_MAX:
        raise ValueError("gat_fwd: sizes exceed the int32 index range")
    plan = checked_plan(plan, indptr, "gat_fwd")
    if exact:
        shift = exact_shift(segment_max(indptr, el.view(-1, H), src,
                                        plan=plan), er, slope)
    else:
        require(shift, "shift", torch.float32, dev, N * H)
    bf16 = wh.dtype == torch.bfloat16
    entry = library().gat_fwd_bf16 if bf16 else library().gat_fwd_f32
    max_values = K2_BF16_VALUES if bf16 else 4
    staged_wh = {}

    def launch(lane_floats: Optional[int] = None,
               values: Optional[int] = None, route: Optional[str] = None,
               stages: Optional[int] = None,
               edges: Optional[int] = None) -> Tuple[Tensor, Tensor]:
        rst = torch.empty((N, HD), dtype=torch.float32, device=dev)
        den = torch.empty((N, H), dtype=torch.float32, device=dev)
        if (route or launch.route) == "staged":
            st = stage_shape("fwd", H, D, w is not None, stages=stages,
                             edges=edges, values=values)
            if not bf16 or st is None:
                raise ValueError(f"gat_fwd: no staged route at H={H}, "
                                 f"D={D}, {wh.dtype}")
            Dp = st["Dp"]
            if "wh" not in staged_wh:
                staged_wh["wh"] = _staged_rows(wh, H, D, Dp)
            run("gat_fwd", library().gat_fwd_bf16_staged, dev,
                ptr(indptr), ptr(src), ptr(staged_wh["wh"]), ptr(el),
                ptr(er), ptr(w), ptr(shift), ptr(rst), ptr(den), N, H, D,
                Dp, float(slope), st["vec"], st["lane_floats"],
                st["stages"], st["edges"], _gran(el, 4 * H),
                _gran(w, 4 * H), *plan_args(plan, _scratch(plan, HD, H,
                                                           dev)))
            return rst, den
        # a lane's columns lie in one head; ``values`` caps the load width
        vec = vector_width(D, wh, max_values=values or max_values)
        lane_floats = max(lane_floats or K2_LANE_FLOATS, vec)
        run("gat_fwd", entry, dev,
            ptr(indptr), ptr(src), ptr(wh), ptr(el), ptr(er), ptr(w),
            ptr(shift), ptr(rst), ptr(den), N, H, D, float(slope), vec,
            lane_floats, *plan_args(plan, _scratch(plan, HD, H, dev)))
        return rst, den
    launch.route = gat_route("fwd", H, D, wh.dtype)
    return launch, shift


# ---------------------------------------------------------------------------
# K3: backward
# ---------------------------------------------------------------------------
def gat_bwd_plain(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
                  wh: Tensor, el: Tensor, er: Tensor, shift: Tensor,
                  den: Tensor, sds: Tensor, dout: Tensor, w: Optional[Tensor],
                  slope: float, want_dw: bool = True):
    """Plain version of K3.  Per CSR edge e=(u->v): recompute a, daw,
    dlogit and draw; returns dwh (N_src, H*D), del (N_src, H), draw (E, H)
    and dw (E, H), None without w or ``want_dw``; per-edge outputs at
    internal edge ids, all in el's dtype (a bf16 wh is widened first)."""
    if wh.is_cuda:
        LAUNCHES.add("plain.gat_bwd")
    wh = _widened(wh, el)
    Ns, HD = wh.shape
    H = el.shape[1]
    D = HD // H
    srcs = _rows(csr_indptr)
    e = csr_eids.long()
    v = dst_csr.long()
    raw = el[srcs] + er[v]
    dv = den[v]
    a = torch.exp(torch.clamp(F.leaky_relu(raw, slope) - shift[v], max=60.0))
    a = a / torch.where(dv > 0, dv, torch.ones_like(dv))
    do_v = dout.view(-1, H, D)[v]
    daw = (wh.view(Ns, H, D)[srcs] * do_v).sum(-1)
    wv = w[e] if w is not None else torch.ones_like(a)
    dlogit = a * (daw * wv - sds[v])
    draw = dlogit * torch.where(raw >= 0, torch.ones_like(raw),
                                torch.full_like(raw, slope))
    dwh = wh.new_zeros((Ns, H, D)).index_add(0, srcs, (a * wv)[:, :, None]
                                             * do_v)
    del_ = el.new_zeros((Ns, H)).index_add(0, srcs, draw)
    draw_out = torch.empty_like(draw)
    draw_out[e] = draw
    dw = None
    if w is not None and want_dw:
        dw = torch.empty_like(draw)
        dw[e] = a * daw
    return dwh.reshape(Ns, HD), del_, draw_out, dw


@spanned("kernel.k3")
def gat_bwd(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
            wh: Tensor, el: Tensor, er: Tensor, shift: Tensor, den: Tensor,
            sds: Tensor, dout: Tensor, w: Optional[Tensor], slope: float,
            want_dw: bool = True, *, plan: Optional[RowPlan] = None,
            dout_bf16: bool = False):
    """K3 wrapper; arguments and results as ``gat_bwd_plain``; dw is None
    unless ``want_dw`` (and w is given).  ``plan`` is
    ``row_plan(csr_indptr)``, built here when None.  ``dout_bf16``: dout
    holds bf16 values only (``bf16_dout``), so the staged route may gather
    a bf16 copy of it, which gives the same bits."""
    if wh.device.type == "cpu":
        return gat_bwd_plain(csr_indptr, csr_eids, dst_csr, wh, el, er, shift,
                             den, sds, dout, w, slope, want_dw)
    if wh.device.type != "cuda":
        raise ValueError(f"gat_bwd: unsupported device {wh.device}")
    launch = gat_bwd_launcher(csr_indptr, csr_eids, dst_csr, wh, el, er,
                              shift, den, sds, dout, w, slope, want_dw, plan,
                              dout_bf16)
    LAUNCHES.add(counted("gat_bwd", wh.dtype)
                 + (".staged" if launch.route == "staged" else ""))
    return launch()


def gat_bwd_launcher(csr_indptr: Tensor, csr_eids: Tensor, dst_csr: Tensor,
                     wh: Tensor, el: Tensor, er: Tensor, shift: Tensor,
                     den: Tensor, sds: Tensor, dout: Tensor,
                     w: Optional[Tensor], slope: float,
                     want_dw: bool = True, plan: Optional[RowPlan] = None,
                     dout_bf16: bool = False):
    """Check K3's arguments on CUDA, pack er, shift, den and sds into one
    (N_dst, H, 4) array, which K3 reads with one 16-byte load per (edge,
    head), and return ``launch(lane_floats, values, route, stages,
    edges, passes)``, which runs the kernel as ``gat_fwd_launcher``'s does
    (rows: None is ``K3_LANE_FLOATS``; 4 values, ``K3_BF16_VALUES`` of a
    bf16 wh; staged: Wh and dout padded to ``padded_head_width``, dout
    gathered in bf16 where ``dout_bf16``, in ``passes`` over ranges of dst
    nodes, None: ``k3_passes``) and returns (dwh, del, draw, dw)."""
    dev = wh.device
    Ns, HD = wh.shape
    Nd, H = er.shape
    if H == 0 or HD % H:
        raise ValueError(f"gat_bwd: width {HD} is not a multiple of H={H}")
    D = HD // H
    E = csr_eids.numel()
    require(csr_indptr, "csr_indptr", torch.int32, dev, Ns + 1)
    require(csr_eids, "csr_eids", torch.int32, dev)
    require(dst_csr, "dst_csr", torch.int32, dev, E)
    require(wh, "wh", FEATURE_DTYPES, dev)
    require(el, "el", torch.float32, dev, Ns * H)
    for name, t in (("er", er), ("shift", shift), ("den", den),
                    ("sds", sds)):
        require(t, name, torch.float32, dev, Nd * H)
    require(dout, "dout", torch.float32, dev, Nd * HD)
    if w is not None:
        require(w, "w", torch.float32, dev, E * H)
    if max(Ns, Nd, E) > _I32_MAX:
        raise ValueError("gat_bwd: sizes exceed the int32 index range")
    plan = checked_plan(plan, csr_indptr, "gat_bwd")
    dstp = torch.stack([er, shift, den, sds], -1).contiguous()
    bf16 = wh.dtype == torch.bfloat16
    entry = library().gat_bwd_bf16 if bf16 else library().gat_bwd_f32
    max_values = K3_BF16_VALUES if bf16 else 4
    staged_rows = {}

    def launch(lane_floats: Optional[int] = None,
               values: Optional[int] = None, route: Optional[str] = None,
               stages: Optional[int] = None, edges: Optional[int] = None,
               passes: Optional[int] = None):
        dwh = torch.empty((Ns, HD), dtype=torch.float32, device=dev)
        del_ = torch.empty((Ns, H), dtype=torch.float32, device=dev)
        draw = torch.empty((E, H), dtype=torch.float32, device=dev)
        dw = torch.empty((E, H), dtype=torch.float32, device=dev) \
            if w is not None and want_dw else None
        if (route or launch.route) == "staged":
            st = stage_shape("bwd", H, D, w is not None, dout_bf16, stages,
                             edges, values)
            if not bf16 or st is None:
                raise ValueError(f"gat_bwd: no staged route at H={H}, "
                                 f"D={D}, {wh.dtype}")
            Dp = st["Dp"]
            if not staged_rows:
                staged_rows["wh"] = _staged_rows(wh, H, D, Dp)
                staged_rows["dout"] = _staged_rows(
                    dout, H, D, Dp, torch.bfloat16 if dout_bf16 else None)
            P = passes or k3_passes(Nd, H, D, w is not None, dout_bf16)
            cuts = _cached_cuts(csr_indptr, dst_csr, Nd, P) if P > 1 \
                else None
            pargs = plan_args(plan, _scratch(plan, HD, H, dev))
            for p in range(P):        # the fix-up runs after the last
                run("gat_bwd", library().gat_bwd_bf16_staged, dev,
                    ptr(csr_indptr), ptr(csr_eids), ptr(dst_csr),
                    ptr(staged_rows["wh"]), ptr(el), ptr(dstp),
                    ptr(staged_rows["dout"]), ptr(w), ptr(dwh), ptr(del_),
                    ptr(draw), ptr(dw), Ns, H, D, Dp, float(slope),
                    st["vec"], st["lane_floats"], st["stages"], st["edges"],
                    int(dout_bf16), _gran(w, 4 * H), ptr(cuts), p, P,
                    *pargs)
            return dwh, del_, draw, dw
        # a lane's columns lie in one head
        vec = vector_width(D, wh, dout, max_values=values or max_values)
        lane_floats = max(lane_floats or K3_LANE_FLOATS, vec)
        run("gat_bwd", entry, dev,
            ptr(csr_indptr), ptr(csr_eids), ptr(dst_csr), ptr(wh), ptr(el),
            ptr(dstp), ptr(dout), ptr(w), ptr(dwh), ptr(del_), ptr(draw),
            ptr(dw), Ns, H, D, float(slope), vec, lane_floats,
            *plan_args(plan, _scratch(plan, HD, H, dev)))
        return dwh, del_, draw, dw
    launch.route = gat_route("bwd", H, D, wh.dtype)
    return launch


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class GatFused(torch.autograd.Function):
    """out[v] = sum_{e=(u,v)} softmax_v(leaky(el[u]+er[v]))_e * w[e] * fsrc[u]
    through K2 (forward) and K3 + K1 (backward).  fsrc float32 or bf16;
    el, er and w float32.  ``packed``: Wh rounded to bf16 once here, and
    that copy is what K2 and K3 read.  The result is float32; fsrc's
    gradient comes back in fsrc's dtype."""

    @staticmethod
    def forward(ctx, fsrc: Tensor, el: Tensor, er: Tensor,
                w: Optional[Tensor], g, slope: float, softmax: str,
                packed: bool = False) -> Tensor:
        N, H, D = fsrc.shape
        wh = fsrc.reshape(N, H * D).contiguous()
        if packed:
            wh = wh.to(torch.bfloat16)
        el = el.contiguous()
        er = er.contiguous()
        exact = softmax == "exact"
        shift = None if exact else shift_bound(el, er, slope).contiguous()
        rst, den, shift = gat_fwd(g.csc_indptr, g.src, wh, el, er, w, shift,
                                  slope, exact, plan=graph_row_plan(g, "csc"))
        ctx.g, ctx.slope, ctx.HD = g, slope, (H, D)
        ctx.fdtype = fsrc.dtype
        ctx.save_for_backward(wh, el, er, w, rst, den, shift)
        return rst.view(-1, H, D)

    @staticmethod
    @spanned("ops.gat_attention.bwd")
    def backward(ctx, dout: Tensor):
        wh, el, er, w, rst, den, shift = ctx.saved_tensors
        g = ctx.g
        H, D = ctx.HD
        Nd = er.shape[0]
        dout = dout.reshape(Nd, H * D).contiguous()
        sds = (rst.view(Nd, H, D) * dout.view(Nd, H, D)).sum(-1).contiguous()
        exact_bf16 = {"dout_bf16": True} if bf16_dout(ctx.fdtype) else {}
        dwh, del_, draw, dw = gat_bwd(g.csr_indptr, g.csr_eids, rev_gidx(g),
                                      wh, el, er, shift, den, sds, dout, w,
                                      ctx.slope, ctx.needs_input_grad[3],
                                      plan=graph_row_plan(g, "csr"),
                                      **exact_bf16)
        der = segment_sum(g.csc_indptr, draw, site="edge",
                          plan=graph_row_plan(g, "csc"))
        return (dwh.view(-1, H, D).to(ctx.fdtype), del_, der,
                dw, None, None, None, None)


def gat_attention_fused(g, fsrc: Tensor, el: Tensor, er: Tensor,
                        negative_slope: float = 0.2,
                        attn_w: Optional[Tensor] = None,
                        softmax: str = "shift",
                        packed: bool = False) -> Tensor:
    """Fused GAT edge phase.  fsrc (N_src, H, D), el (N_src, H), er (N_dst,
    H), attn_w (E, H) in internal edge order or None.  Returns (N_dst, H,
    D) in fsrc's dtype.  On CUDA each is float32 or bf16 (another dtype
    raises).  As ``gat_attention_pallas``: a bf16 el, er or attn_w is
    upcast (their gradients come back rounded once to bf16), the sums run
    in float32 and a bf16 fsrc's result is rounded once.  ``packed`` (the
    JAX ``DGL_TPU_GAT_PACKED``) reads Wh rounded to bf16 where H * D is
    even, and is off for an odd H * D (``gat_kernel.py:940``).  A masked
    graph runs over its real-edge view."""
    for name, t in (("fsrc", fsrc), ("el", el), ("er", er),
                    ("attn_w", attn_w)):
        if t is not None:
            check_cuda_call(t, f"gat_attention {name}")
    g, attn_w = on_real_edges(g, attn_w)
    if attn_w is not None:
        attn_w = widened(attn_w).contiguous()
    H, D = fsrc.shape[1], fsrc.shape[2]
    out = GatFused.apply(fsrc, widened(el), widened(er), attn_w, g,
                         float(negative_slope), softmax,
                         packed and (H * D) % 2 == 0)
    return out.to(fsrc.dtype)
