"""K1 over bf16 rows on the pairs walk: its load-width rule, its names,
and bf16 gspmm sums against the JAX package.

The rule (``k1_vector_width``: at most ``k1_values`` values a lane, 8 for
bf16 rows without an (E, F) weight, 4 beside one and for float32; the
short-rows pack at most ``K1_PACK_VALUES``, 4) is a pure function of x's
dtype, width and alignment, the weight's kind and the route, so
it is held here at the real shapes (synthetic Reddit's 232,965 x 640 bf16
rows, 602 unpadded, bench.py's 1,000,000 x 128, F = 7 and 1) without a
card: meta tensors stand for the operands.  So are the lanes and route
those widths give (``edge_lanes``, ``k1_route``) and the names a launch
takes (``launch_name``: ``segment_sum_bf16.<site>.pairs``; ``k1_name`` in
the dispatch log).  The CUDA kernel runs only on the card
(``chip_smoke.py``'s ``bf16_kernels`` and ``bf16_reddit`` hold it to its
plain version there).

On the CPU ``GspmmSum`` (``sk.gspmm_sum``) runs K1's plain version
(``segment_sum_plain``), which the pairs walk must match on the card.  It
is held here against the JAX package's prepared graph (its Pallas sum in
interpret mode, as its own tests run it) and a float64 reference, on two
graphs made from a seed with numpy: one whose dst hub and src hub are cut
into pieces (K1's rows walk, forward and dx) and one of mostly short rows
(the short-rows pack), at F = 64 (8 values a lane on the card) and 130 (2
a lane): copy_u sum, mean and u_mul_e with an (E,) float32 weight, each
forward and dx.

Tolerance (``assert_k1``): one bf16 ulp at the larger of the two plus
K1_TOL (2e-5) of max|reference|, as ``chip_smoke.bf16_check`` holds K1:
both sides sum the same bf16 values in float32 and round once, so only the
float32 summation order differs, which may move a sum across a rounding
boundary.  Against the JAX prepared graph a u_mul_e sum also carries the
JAX kernel's rounding of each message to bf16 (``_block_contrib``'s
single bf16 pass; its reverse pass the same): at most u = 2^-8 of each
|message|, u * sum |m| a row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
from dgl_hack_tpu_torch.ops.cuda.build import LAUNCHES

torch.set_num_threads(2)

BF16 = torch.bfloat16
K1_TOL = 2e-5
U = 2.0 ** -8                    # bf16's unit roundoff
REDDIT = (232_965, 640)          # gspmm pads Reddit's 602 columns to 640
REDDIT_RAW = (232_965, 602)      # unpadded: 4-byte aligned rows
BENCH = (1_000_000, 128)


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _weight(kind, E, F):
    return None if kind == 0 else _meta((E,) if kind == 1 else (E, F),
                                        torch.float32)


@pytest.mark.parametrize("shape,w_kind,want", [
    (REDDIT, 0, 8), (REDDIT, 1, 8), (REDDIT, 2, 4),
    (REDDIT_RAW, 0, 2), (REDDIT_RAW, 1, 2), (REDDIT_RAW, 2, 2),
    (BENCH, 0, 8), (BENCH, 1, 8), (BENCH, 2, 4),
    ((10, 7), 0, 1), ((10, 7), 2, 1), ((10, 1), 0, 1), ((10, 1), 1, 1),
])
def test_bf16_width_rule(shape, w_kind, want):
    """bf16 rows load 8 values a lane where 8 | F (16 bytes), beside an
    (E, F) float32 weight 4 (one 16-byte weight load a lane); 602 columns
    are 4-byte aligned rows (2 a load), odd widths 1."""
    F = shape[1]
    x = _meta(shape)
    assert sk.k1_values(BF16, w_kind) == (4 if w_kind == 2 else 8)
    assert sk.k1_vector_width(F, x, _weight(w_kind, 16, F), w_kind) == want


@pytest.mark.parametrize("shape,w_kind,want", [
    (REDDIT, 0, 4), (REDDIT, 2, 4), (REDDIT_RAW, 0, 2), (BENCH, 0, 4),
    (BENCH, 1, 4), (BENCH, 2, 4), ((10, 7), 0, 1), ((10, 1), 2, 1),
])
def test_float32_width_unchanged(shape, w_kind, want):
    """float32 rows keep ``vector_width`` at ``SUM_MAX_VALUES`` (16 bytes:
    4 values), as before the pairs walk."""
    F = shape[1]
    x = _meta(shape, torch.float32)
    w = _weight(w_kind, 16, F)
    assert sk.k1_values(torch.float32, w_kind) == sk.SUM_MAX_VALUES == 4
    assert sk.k1_vector_width(F, x, w, w_kind) == want == sk.vector_width(
        F, x, w if w_kind == 2 else None, max_values=sk.SUM_MAX_VALUES)


def test_bf16_width_alignment():
    """x or an (E, F) weight off its 16-byte boundary loads less at a
    time; bf16 rows 2 bytes off a 4-byte one load one value."""
    buf = torch.zeros(8 * 640 + 8, dtype=BF16)
    assert sk.k1_vector_width(640, buf[:8 * 640].view(8, 640), None, 0) == 8
    assert sk.k1_vector_width(640, buf[4:4 + 8 * 640].view(8, 640), None,
                              1) == 4
    assert sk.k1_vector_width(640, buf[2:2 + 8 * 640].view(8, 640), None,
                              0) == 2
    assert sk.k1_vector_width(640, buf[1:1 + 8 * 640].view(8, 640), None,
                              0) == 1
    w = torch.zeros(4 * 640 + 2)
    x = buf[:4 * 640].view(4, 640)
    assert sk.k1_vector_width(640, x, w[2:2 + 4 * 640].view(4, 640), 2) == 2
    assert sk.k1_vector_width(640, x, w[1:1 + 4 * 640].view(4, 640), 1) == 8


@pytest.mark.parametrize("width,vec,groups", [
    (64, 8, 4),      # Reddit's 64-column slices at 16-byte loads
    (64, 4, 2),      # ... at the parent's 8-byte loads
    (128, 8, 2),     # bench.py's F = 128 or a 128-column slice
    (128, 4, 1),
    (602, 2, 1),     # the masked block (no slice, 2 a load)
    (7, 1, 4), (1, 1, 32)])
def test_bf16_lanes_and_route(width, vec, groups):
    """The lanes an edge the kernel takes at those widths, and the route
    they give: the short-rows pack where a warp holds two lane groups or
    more and three quarters of the rows or more are short (bench.py's
    forward: 99%; its dx: 56.6%, the rows route)."""
    assert 32 // sk.edge_lanes(width, vec) == groups
    for short in (0, 32, 36, 47, 48, 64):
        want = "packed" if groups >= 2 and short >= 48 else "rows"
        assert sk.k1_route(64, short, width, vec) == want


def test_names():
    """bf16 rows take the pairs walk (``k1_walk``), float32 rows keep
    theirs; a launch counts as ``segment_sum_bf16.<site>.pairs`` and the
    dispatch log names ``K1 pairs`` / ``K1 packed pairs``."""
    assert sk.k1_walk(BF16) == "pairs" and sk.k1_walk(torch.float32) == \
        "floats"
    for site in ("fwd", "rev", "edge", "rows"):
        assert sk.launch_name(site, BF16) == f"segment_sum_bf16.{site}.pairs"
        assert sk.launch_name(site, torch.float32) == f"segment_sum.{site}"
    assert sk.k1_name("rows", BF16) == "K1 pairs"
    assert sk.k1_name("packed", BF16) == "K1 packed pairs"
    assert sk.k1_name("rows", torch.float32) == "K1"
    assert sk.k1_name("packed", torch.float32) == "K1 packed"


_GRAPHS = {}


def graphs(kind):
    """(JAX prepared, port) graphs of ``kind``:

    * ``hub``: 700 nodes, 12,000 random edges into nodes 0-599 (600-699
      have no in-edge; most rows longer than the pack's 16 edges) plus 700
      into node 0 (a dst hub of 3 pieces of K1_PIECE edges) and 600 out of
      node 1 (a src hub: 3 pieces of the CSR rows);
    * ``short``: 2,400 dst rows, 55% of one edge, 20% empty, 20% of 2-16
      and 5% of 17-40 (the pack's single rows), src uniform."""
    if kind not in _GRAPHS:
        rng = np.random.default_rng(11 if kind == "hub" else 12)
        if kind == "hub":
            n = 700
            src = rng.integers(0, n, 12_000)
            dst = rng.integers(0, 600, 12_000)
            src = np.r_[src, rng.integers(0, n, 700), np.full(600, 1)]
            dst = np.r_[dst, np.zeros(700, np.int64),
                        rng.integers(0, 600, 600)]
        else:
            n = 2400
            u = rng.random(n)
            deg = np.where(u < 0.55, 1, np.where(u < 0.75, 0, np.where(
                u < 0.95, rng.integers(2, 17, n), rng.integers(17, 41, n))))
            dst = np.repeat(np.arange(n), deg)
            src = rng.integers(0, n, dst.shape[0])
        src, dst = src.astype(np.int32), dst.astype(np.int32)
        gj = dgl.graph((src, dst), num_nodes=n)
        gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
        _GRAPHS[kind] = (gp, dt.graph((src, dst), num_nodes=n))
    return _GRAPHS[kind]


def bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_k1(out, ref, what, extra=0.0):
    """|out - ref| <= one bf16 ulp at the larger of the two + K1_TOL *
    max|ref| (+ extra)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    bound = bf16_ulp(np.maximum(np.abs(out), np.abs(ref))) + extra \
        + K1_TOL * (np.abs(ref).max() if ref.size else 0.0)
    err = np.abs(out - ref)
    assert np.all(err <= bound), f"{what}: max err {err.max()}"


def f32(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32), np.float32)


def bf16_pair(a):
    """(JAX, torch) bf16 arrays of the same values."""
    aj = jnp.asarray(a).astype(jnp.bfloat16)
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).to(BF16)


def segsum64(index, m, n):
    """Float64 sum of the rows of m by ``index`` into n rows."""
    m = torch.as_tensor(m).double()
    return torch.zeros((n,) + tuple(m.shape[1:]), dtype=torch.float64) \
        .index_add_(0, torch.as_tensor(index).long(), m)


def test_routes_on_the_graphs():
    """What the card takes on the two graphs, as the dispatch log names it:
    the hub graph's rows walk and the short graph's pack, over bf16 rows
    at F = 64 (8 a load: 4 lane groups) on the pairs walk, and the rows
    walk at F = 130 (2 a load: one lane group)."""
    for kind, want in (("hub", "K1 pairs"), ("short", "K1 packed pairs")):
        _, gt = graphs(kind)
        x = torch.zeros((gt.num_src_nodes, 64), dtype=BF16)
        assert sk.k1_name(sk.gspmm_sum_route(gt, x), x.dtype) == want
        x = torch.zeros((gt.num_src_nodes, 130), dtype=BF16)
        assert sk.k1_name(sk.gspmm_sum_route(gt, x), x.dtype) == "K1 pairs"
    _, gt = graphs("hub")
    plan = sk.graph_row_plan(gt, "csc")
    assert plan.pieces.shape[0] >= 3 and plan.long_rows.tolist() == [0]
    assert sk.graph_row_plan(gt, "csr").long_rows.tolist() == [1]
    _, gt = graphs("short")
    assert sk.graph_row_plan(gt, "csc").singles.numel() > 0


@pytest.mark.parametrize("kind,F,want", [
    ("hub", 64, (64, 8, "rows")), ("hub", 130, (130, 2, "rows")),
    ("short", 64, (64, 4, "packed")), ("short", 16, (16, 4, "packed")),
    ("short", 10, (10, 2, "packed")), ("short", 130, (130, 2, "rows"))])
def test_launch_widths(kind, F, want):
    """The launcher's (slice, load width, route) over bf16 rows: the route
    at 8 values a lane where F allows, and the pack at most
    ``K1_PACK_VALUES`` (4); the rows route keeps 8.  float32 rows keep
    ``vector_width``'s 4 on either route."""
    _, gt = graphs(kind)
    x = torch.zeros((gt.num_src_nodes, F), dtype=BF16)
    launch = sk.segment_sum_launcher(gt.csc_indptr, x, gt.src)
    assert launch.widths() == want
    assert launch.route() == want[2]
    assert launch.widths(None, None, "rows")[1] == sk.k1_vector_width(
        F, x, None, 0)
    x32 = x.float()
    launch = sk.segment_sum_launcher(gt.csc_indptr, x32, gt.src)
    assert launch.widths(None, None, "packed")[1] == \
        launch.widths(None, None, "rows")[1] == sk.vector_width(F, x32)


def test_cpu_counts_nothing():
    """On CPU tensors K1's wrapper runs its plain version and counts no
    launch."""
    _, gt = graphs("hub")
    x = torch.ones((gt.num_src_nodes, 8), dtype=BF16)
    LAUNCHES.reset()
    out = sk.segment_sum(gt.csc_indptr, x, gt.src)
    assert out.dtype == BF16 and not LAUNCHES.counts
    # a sum of ones is the in-degree, rounded once to bf16 (715 -> 716)
    assert torch.equal(out, gt.in_degrees().to(BF16)[:, None].expand(-1, 8))


@pytest.mark.parametrize("kind", ["hub", "short"])
@pytest.mark.parametrize("F", [64, 130])
@pytest.mark.parametrize("op", ["sum", "mean", "u_mul_e"])
def test_gspmm_bf16(kind, F, op):
    """gspmm over bf16 x through the port's K1 Function (``GspmmSum``; the
    plain version on the CPU) against the JAX prepared graph and a float64
    reference, forward and dx, with a bf16 cotangent (``assert_k1``)."""
    gp, gt = graphs(kind)
    n, E = gt.num_src_nodes, gt.num_edges()
    rng = np.random.default_rng(F + len(op) + len(kind))
    xj, xt = bf16_pair(rng.normal(size=(n, F)))
    tj, tt = bf16_pair(rng.normal(size=(gt.num_dst_nodes, F)))
    w = rng.random(E).astype(np.float32) + 0.5
    src, dst = gt.src.long(), gt.dst.long()
    deg = gt.in_degrees().to(BF16).clamp(min=1)[:, None]

    def jax_fn(xx):
        if op == "u_mul_e":
            return dgl.gspmm(gp, "mul", "sum", xx, jnp.asarray(w), "u", "e")
        return dgl.gspmm(gp, "copy_lhs", op, xx)
    ref_j, vjp = jax.vjp(jax_fn, xj)
    (gx_j,) = vjp(tj)
    xt.requires_grad_(True)
    wt = torch.from_numpy(w) if op == "u_mul_e" else None
    out = sk.gspmm_sum(gt, xt, wt)
    if op == "mean":
        out = out / deg                          # as ops/spmm.py:_mean
    (gx,) = torch.autograd.grad(out, xt, tt)
    assert out.dtype == gx.dtype == BF16
    # float64 references over the same bf16 values (mean: the rounded sum
    # divided in bf16; its cotangent divided in bf16 as autograd does)
    m = xt.detach().double()[src]
    cot = tt
    if op == "u_mul_e":
        m = m * wt.double()[:, None]
    ref = segsum64(dst, m, gt.num_dst_nodes)
    if op == "mean":
        ref = segsum64(dst, m, gt.num_dst_nodes).to(BF16) / deg
        cot = tt / deg
    gm = cot.double()[dst]
    if op == "u_mul_e":
        gm = gm * wt.double()[:, None]
    ref_dx = segsum64(src, gm, n)
    assert_k1(f32(out), ref.double().numpy(), "fwd vs float64")
    assert_k1(f32(gx), ref_dx.numpy(), "dx vs float64")
    extra_f = extra_b = 0.0
    if op == "u_mul_e":
        extra_f = U * segsum64(dst, m.abs(), gt.num_dst_nodes).numpy()
        extra_b = U * segsum64(src, gm.abs(), n).numpy()
    assert_k1(f32(out), f32(ref_j), "fwd vs JAX prepared", extra_f)
    assert_k1(f32(gx), f32(gx_j), "dx vs JAX prepared", extra_b)
