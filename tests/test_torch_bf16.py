"""bf16 storage in gspmm: the port against the JAX package's packed path.

Mirrors the JAX package's own bf16 tests (``tests/test_pallas_spmm.py``:
copy_u at both flat settings, u_mul_e, the gradients, an odd width,
max/min) and adds copy_e.  The JAX side runs on a **prepared** graph (its
Pallas kernels in interpret mode), which gathers bf16 rows, sums them in
float32 and rounds once (``_run_direction``'s u32 packing, ``_block_
contrib``); the port runs both of its CPU routes: ``dt.gspmm`` (the
composed path) and the autograd Functions around K1 and K4/K5 (their plain
versions).  Inputs are made from a seed with numpy.

Tolerances, stated per case:

* ``ulp``: within one bf16 ulp of each element (bf16 keeps 8 significant
  bits): both sides sum the same bf16 values in float32 and round once,
  so only a float32 summation order can differ, which may move a sum
  across a rounding boundary;
* ``exact``: max and min of bf16 values, and which edges hit them;
* ``rounded``: where the JAX side rounds where the port does not, the
  bound that rounding gives, plus one ulp.  A weighted message rounded to
  bf16 before its float32 sum (``_block_contrib``'s single bf16 pass,
  ``spmm_kernel.py:531-533``) errs by at most u = 2^-8 (bf16's unit
  roundoff) of each |message|: u * sum |m|.  A sum taken in bf16 (the
  composed copy_e sum, the dw dot of ``_gspmm_fused_bwd``) errs by at
  most (n - 1) u * sum |m| over n terms, and each bf16 product by u |m|
  more: n u * sum |m|.  Float32 messages that the JAX kernel sums as
  bf16 hi and lo parts (its f32x2 mode, an (E, F) weight's messages) lose
  at most u^2 |m| each: u^2 * sum |m|, which moves a sum near 0 by a few
  of its ulps.  There the port is also held within one ulp of a float64
  reference, its own semantics.

The JAX **bare** graph sums bf16 messages in bf16; the port departs from
it on purpose (``test_probe_departs_from_bare``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as smk
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk

torch.set_num_threads(2)

N, E = 300, 2000
U = 2.0 ** -8                       # bf16's unit roundoff


def bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_ulp(out, ref, what="", extra=0.0):
    """|out - ref| <= one bf16 ulp at the larger of the two (+ extra)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref)
    bound = bf16_ulp(np.maximum(np.abs(out), np.abs(ref))) + extra
    assert np.all(err <= bound), f"{what}: max err {err.max()}"


def abs_sum(index, m, n):
    """sum |m| per row of ``index`` (n rows): what ``rounded`` scales."""
    m = torch.as_tensor(m).double().abs()
    return torch.zeros((n,) + tuple(m.shape[1:]), dtype=torch.float64) \
        .index_add_(0, torch.as_tensor(index).long(), m).numpy()


def f32(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32), np.float32)


def bf16_pair(a):
    """(JAX, torch) bf16 arrays of the same values."""
    aj = jnp.asarray(a).astype(jnp.bfloat16)
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).bfloat16()


_GRAPHS = {}


def graphs(flat=False, num_nodes=N, num_edges=E, seed=0):
    """(JAX prepared, port) graphs over the edges of test_pallas_spmm.py's
    ``_prep``, cached per setting."""
    key = (flat, num_nodes, num_edges, seed)
    if key not in _GRAPHS:
        rng = np.random.default_rng(seed)
        src = rng.integers(0, num_nodes, num_edges).astype(np.int32)
        dst = rng.integers(0, num_nodes, num_edges).astype(np.int32)
        gj = dgl.graph((src, dst), num_nodes=num_nodes)
        gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2, flat=flat)
        _GRAPHS[key] = (gp, dt.graph((src, dst), num_nodes=num_nodes))
    return _GRAPHS[key]


def port_sum(route, gt, x, w=None):
    """copy_u / u_mul_e sum through one of the port's CPU routes."""
    if route == "gspmm":
        if w is None:
            return dt.gspmm(gt, "copy_lhs", "sum", x)
        return dt.gspmm(gt, "mul", "sum", x, w, "u", "e")
    return sk.gspmm_sum(gt, x, w)                   # GspmmSum (K1 plain)


def ref_sum(gt, x, w=None):
    """Float64 sum of the same values, rounded once to bf16."""
    src, dst = gt.src.long(), gt.dst.long()
    m = x.double()[src]
    if w is not None:
        m = m * w.double().reshape((w.shape[0],) + (1,) * (m.dim() - 1)
                                   if w.dim() == 1 or w.shape[1] == 1
                                   else w.shape).double()
    out = torch.zeros((gt.num_dst_nodes,) + tuple(x.shape[1:]),
                      dtype=torch.float64).index_add_(0, dst, m)
    return out.bfloat16()


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
@pytest.mark.parametrize("flat", [False, True])
def test_bf16_copy_u(route, flat):
    """test_pallas_bf16_packed_copy_u: tolerance ``ulp``."""
    gp, gt = graphs(flat)
    rng = np.random.default_rng(1)
    xj, xt = bf16_pair(rng.normal(size=(N, 128)))
    ref = dgl.gspmm(gp, "copy_lhs", "sum", xj)
    out = port_sum(route, gt, xt)
    assert out.dtype == torch.bfloat16
    assert_ulp(f32(out), f32(ref), "vs JAX prepared")
    assert_ulp(f32(out), f32(ref_sum(gt, xt)), "vs float64")


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
def test_bf16_mean(route):
    """mean: the once-rounded sum divided by the in-degree in bf16, as
    gspmm_pallas does; tolerance ``ulp``."""
    gp, gt = graphs()
    rng = np.random.default_rng(2)
    xj, xt = bf16_pair(rng.normal(size=(N, 64)))
    ref = dgl.gspmm(gp, "copy_lhs", "mean", xj)
    if route == "gspmm":
        out = dt.gspmm(gt, "copy_lhs", "mean", xt)
    else:
        deg = gt.in_degrees().to(torch.bfloat16).clamp(min=1)
        out = sk.gspmm_sum(gt, xt) / deg[:, None]
    assert out.dtype == torch.bfloat16
    assert_ulp(f32(out), f32(ref))


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
@pytest.mark.parametrize("wshape", [(1,), (128,)])
def test_bf16_u_mul_e(route, wshape):
    """test_pallas_bf16_packed_u_mul_e (float32 weights).  An (E, F)
    weight multiplies outside the JAX kernel in float32 and the sum takes
    the f32x2 split: ``rounded`` with u^2.  An (E, 1) weight's messages
    are rounded to bf16 inside it: ``rounded`` with u."""
    gp, gt = graphs()
    rng = np.random.default_rng(3)
    xj, xt = bf16_pair(rng.normal(size=(N, 128)))
    w = rng.random((E,) + wshape, dtype=np.float32)
    ref = dgl.gspmm(gp, "mul", "sum", xj, jnp.asarray(w), "u", "e")
    out = port_sum(route, gt, xt, torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    assert_ulp(f32(out), f32(ref_sum(gt, xt, torch.from_numpy(w))),
               "vs float64")
    m = xt.double()[gt.src.long()] * torch.from_numpy(w).double()
    per = U if wshape == (1,) else U * U
    assert_ulp(f32(out), f32(ref), "vs JAX prepared",
               per * abs_sum(gt.dst, m, N))


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
def test_bf16_copy_u_grad(route):
    """test_pallas_bf16_packed_grads with a fixed bf16 cotangent: dx is a
    float32 sum of bf16 cotangent rows, rounded once; ``ulp``."""
    gp, gt = graphs()
    rng = np.random.default_rng(4)
    xj, xt = bf16_pair(rng.normal(size=(N, 128)))
    tj, tt = bf16_pair(rng.normal(size=(N, 128)))
    gx_ref = jax.grad(lambda xx: (dgl.gspmm(gp, "copy_lhs", "sum", xx)
                                  .astype(jnp.float32)
                                  * tj.astype(jnp.float32)).sum())(xj)
    xt.requires_grad_(True)
    out = port_sum(route, gt, xt)
    (gx,) = torch.autograd.grad((out.float() * tt.float()).sum(), xt)
    assert gx.dtype == torch.bfloat16
    assert_ulp(f32(gx), f32(gx_ref))


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
def test_bf16_u_mul_e_grads(route):
    """bf16 x with an (E, 1) float32 weight.  dx: the JAX reverse pass
    rounds each g[v] * w[e] message to bf16 (a scalar weight in the packed
    pass): ``rounded``.  dw: the port's float32 dot, within 1e-5 of the
    float64 dot; JAX forms each product and the sum over F in bf16:
    ``rounded`` with n = F."""
    gp, gt = graphs()
    rng = np.random.default_rng(5)
    F = 32
    xj, xt = bf16_pair(rng.normal(size=(N, F)))
    tj, tt = bf16_pair(rng.normal(size=(N, F)))
    w = rng.normal(size=(E, 1)).astype(np.float32)

    def loss_j(xx, ww):
        out = dgl.gspmm(gp, "mul", "sum", xx, ww, "u", "e")
        return (out.astype(jnp.float32) * tj.astype(jnp.float32)).sum()
    gx_ref, gw_ref = jax.grad(loss_j, argnums=(0, 1))(xj, jnp.asarray(w))
    xt.requires_grad_(True)
    wt = torch.tensor(w, requires_grad=True)
    out = port_sum(route, gt, xt, wt)
    gx, gw = torch.autograd.grad((out.float() * tt.float()).sum(),
                                 (xt, wt))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    src, dst = gt.src.long(), gt.dst.long()
    gm = tt.double()[dst] * torch.from_numpy(w).double()
    assert_ulp(f32(gx), f32(gx_ref), "dx", U * abs_sum(src, gm, N))
    # dw against float64: <x[src], g[dst]> of the bf16 values
    prod = xt.detach().double()[src] * tt.double()[dst]
    dw64 = prod.sum(-1, keepdim=True).numpy()
    np.testing.assert_allclose(f32(gw), dw64, rtol=1e-5, atol=1e-5)
    bound = F * U * prod.abs().sum(-1, keepdim=True).numpy()
    assert np.all(np.abs(f32(gw) - f32(gw_ref)) <= bound + 1e-6)


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
@pytest.mark.parametrize("F", [37, 7, 1])
def test_bf16_odd_width(route, F):
    """test_pallas_bf16_odd_width_fallback (and the narrowest widths K1's
    bf16 loads take one value at a time): ``ulp``."""
    gp, gt = graphs()
    rng = np.random.default_rng(6)
    xj, xt = bf16_pair(rng.normal(size=(N, F)))
    ref = dgl.gspmm(gp, "copy_lhs", "sum", xj)
    out = port_sum(route, gt, xt)
    assert_ulp(f32(out), f32(ref))


@pytest.mark.parametrize("route", ["gspmm", "kernel"])
@pytest.mark.parametrize("reducer", ["max", "min"])
@pytest.mark.parametrize("flat", [False, True])
def test_bf16_minmax(route, reducer, flat):
    """test_pallas_minmax_bf16_packed: the max of bf16 values is exact,
    and so is the gradient's choice of edges: ``exact`` (dx sums one
    cotangent per hit edge in float32; a tie hits every tied edge on both
    sides)."""
    gp, gt = graphs(flat)
    rng = np.random.default_rng(7)
    xj, xt = bf16_pair(rng.normal(size=(N, 128)))
    tj, tt = bf16_pair(rng.normal(size=(N, 128)))
    ref = dgl.gspmm(gp, "copy_lhs", reducer, xj)
    gx_ref = jax.grad(lambda xx: (dgl.gspmm(gp, "copy_lhs", reducer, xx)
                                  .astype(jnp.float32)
                                  * tj.astype(jnp.float32)).sum())(xj)
    xt.requires_grad_(True)
    out = dt.gspmm(gt, "copy_lhs", reducer, xt) if route == "gspmm" \
        else smk.gspmm_max(gt, xt, None, reducer)
    (gx,) = torch.autograd.grad((out.float() * tt.float()).sum(), xt)
    assert out.dtype == gx.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(out), f32(ref))
    np.testing.assert_array_equal(f32(gx), f32(gx_ref))


@pytest.mark.parametrize("reducer", ["max", "min"])
def test_bf16_u_mul_e_minmax(reducer):
    """A float32 weight: each message is rounded to bf16 (a monotone
    rounding, so the max is the JAX package's rounded f32 max): exact."""
    gp, gt = graphs()
    rng = np.random.default_rng(8)
    xj, xt = bf16_pair(rng.normal(size=(N, 64)))
    w = rng.normal(size=(E, 1)).astype(np.float32)
    ref = dgl.gspmm(gp, "mul", reducer, xj, jnp.asarray(w), "u", "e")
    out = dt.gspmm(gt, "mul", reducer, xt, torch.from_numpy(w), "u", "e")
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(out), f32(ref))


@pytest.mark.parametrize("reducer", ["sum", "mean"])
def test_bf16_copy_e(reducer):
    """copy_e (K1's edge-row mode): float32 sums rounded once, ``ulp`` of
    a float64 reference; the JAX prepared graph composes it with a bf16
    segment sum: ``rounded`` with n the row's in-degree."""
    gp, gt = graphs()
    rng = np.random.default_rng(9)
    ej, et = bf16_pair(rng.normal(size=(E, 16)))
    ref = dgl.gspmm(gp, "copy_rhs", reducer, None, ej, "u", "e")
    out = dt.gspmm(gt, "copy_rhs", reducer, None, et, "u", "e")
    assert out.dtype == torch.bfloat16
    deg = gt.in_degrees().clamp(min=1).double().numpy()[:, None]
    bound = deg * U * abs_sum(gt.dst, et, N)
    if reducer == "mean":
        bound = bound / deg + bf16_ulp(f32(ref))   # and the division
    assert_ulp(f32(out), f32(ref), "vs JAX prepared", bound)
    s64 = torch.zeros((N, 16), dtype=torch.float64).index_add_(
        0, gt.dst.long(), et.double())
    if reducer == "mean":
        s64 = s64.bfloat16().double() / gt.in_degrees().clamp(min=1) \
            .bfloat16().double()[:, None]
    assert_ulp(f32(out), f32(s64.bfloat16()))


def test_probe_departs_from_bare():
    """The probe of ROADMAP's bf16 item (50 nodes, 300 edges, F = 8): the
    port's bf16 sum equals the JAX **prepared** graph's bit for bit, since
    both sum in float32 and round once, as K1 does on the card; the JAX
    **bare** graph sums in bf16 and differs from both by 0.0625."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 300)
    dst = rng.integers(0, 50, 300)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    gj = dgl.graph((src, dst), num_nodes=50)
    gt = dt.graph((src, dst), num_nodes=50)
    xj, xt = bf16_pair(x)
    bare = f32(dgl.gspmm(gj, "copy_lhs", "sum", xj))
    prep = f32(dgl.gspmm(dgl.prepare_spmm(gj), "copy_lhs", "sum", xj))
    port = f32(dt.gspmm(gt, "copy_lhs", "sum", xt))
    np.testing.assert_array_equal(port, prep)
    assert float(np.abs(port - bare).max()) == 0.0625


def test_plain_versions_accumulate_in_f32():
    """300 ones into one row: a bf16 running sum sticks at 256 (256 + 1
    rounds back to 256), a float32 one reaches 300, which bf16 holds.
    K1's plain version (both of its modes, and a float32 result on
    request) and K5's plain dx sum in float32."""
    n = 300
    ones = torch.ones((n, 3), dtype=torch.bfloat16)
    indptr = torch.tensor([0, n], dtype=torch.int32)
    gidx = torch.arange(n, dtype=torch.int32)
    for out in (sk.segment_sum_plain(indptr, ones, gidx),
                sk.segment_sum_plain(indptr, ones)):
        assert out.dtype == torch.bfloat16
        assert out.float().tolist() == [[300.0] * 3]
    out32 = sk.segment_sum_plain(indptr, ones, gidx,
                                 out_dtype=torch.float32)
    assert out32.dtype == torch.float32 and out32.tolist() == [[300.0] * 3]
    # K5: one src row with n out-edges, each the max of its dst row
    csr_indptr = torch.tensor([0, n], dtype=torch.int32)
    dst_csr = torch.arange(n, dtype=torch.int32)
    eids = torch.arange(n, dtype=torch.int32)
    x = torch.full((1, 3), 2.0, dtype=torch.bfloat16)
    raw = torch.full((n, 3), 2.0, dtype=torch.bfloat16)
    g = torch.ones((n, 3), dtype=torch.bfloat16)
    dx, _ = smk.segment_max_bwd_plain(csr_indptr, dst_csr, eids, x, None,
                                      raw, g)
    assert dx.dtype == torch.bfloat16 and dx.float().tolist() == \
        [[300.0] * 3]
    # composed gspmm on a masked graph: the same rule
    gt = dt.graph((np.zeros(n, np.int64), np.zeros(n, np.int64)),
                  num_nodes=1)
    gm = gt.replace(edge_mask=torch.ones(n, dtype=torch.bool))
    assert dt.gspmm(gm, "copy_rhs", "sum", None, ones, "u", "e") \
        .float().tolist() == [[300.0] * 3]


def test_bf16_weighted_max_message_is_rounded():
    """K4/K5's plain versions form a weighted bf16 message as the kernels
    do: the float32 product rounded to bf16.  Two products that round to
    one bf16 value tie, and both edges take the cotangent."""
    x = torch.tensor([[1.0], [1.0]], dtype=torch.bfloat16)
    w = torch.tensor([1.0, 1.0 + 2.0 ** -10])      # rounds to 1.0 in bf16
    indptr = torch.tensor([0, 2], dtype=torch.int32)
    gidx = torch.tensor([0, 1], dtype=torch.int32)
    raw = smk.segment_max_plain(indptr, x, gidx, w)
    assert raw.dtype == torch.bfloat16 and raw.float().tolist() == [[1.0]]
    csr_indptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst_csr = torch.tensor([0, 0], dtype=torch.int32)
    eids = torch.tensor([0, 1], dtype=torch.int32)
    g = torch.ones((1, 1), dtype=torch.bfloat16)
    dx, dw = smk.segment_max_bwd_plain(csr_indptr, dst_csr, eids, x, w,
                                       raw, g)
    assert dx.float().tolist() == [[1.0], [1.0 + 2.0 ** -10]] or \
        dx.float().tolist() == [[1.0], [1.0]]
    assert dw.dtype == torch.float32 and dw.tolist() == [1.0, 1.0]


def test_bf16_width_rules():
    """The byte rules count the rows' own bytes: 64 bf16 columns to an L2
    line, slices of bf16 x twice as wide for the same bytes, 16-byte loads
    of 8 bf16 values for K4 and at most 4 values for K1 and K5 (their
    16-byte bf16 loads cost registers and time on the card)."""
    assert sk.line_cols(4) == 32 and sk.line_cols(2) == 64
    assert sk.slice_width(232_965, 602, False, 2) == 64     # 29.8 MB
    assert sk.slice_width(232_965, 602, False) == 32
    assert sk.padded_width(232_965, 602, None, 2) == 640
    assert sk.padded_width(232_965, 602, None) == 608
    assert sk.slice_width(1_000_000, 128, False, 2) == 128  # none fits
    buf = torch.zeros(4 * 640 + 8, dtype=torch.bfloat16)
    a = buf[:4 * 640].view(4, 640)
    assert sk.vector_width(640, a) == 8
    assert sk.vector_width(640, a, max_values=sk.SUM_MAX_VALUES) == 4
    assert sk.vector_width(602, buf[:4 * 602].view(4, 602)) == 2
    assert sk.vector_width(7, buf[:28].view(4, 7)) == 1
    assert sk.vector_width(640, buf[2:4 * 640 + 2].view(4, 640)) == 2
    w = torch.zeros(4 * 640 + 4)                    # float32 weight beside
    assert sk.vector_width(640, a, w[:4 * 640].view(4, 640)) == 8
    assert sk.vector_width(640, a, w[2:4 * 640 + 2].view(4, 640)) == 2
    x602 = buf[:4 * 602].view(4, 602)
    assert smk.max_bwd_load_widths(640, x602, None, a, a) == (4, 2)


@pytest.mark.parametrize("reuse,want", [(None, 32), (101.0, 32), (16.0, 32),
                                        (6.9, 602), (0.43, 602)])
def test_slice_reuse_rule(reuse, want):
    """Slices only where the edges far outnumber the rows walked and
    gathered (``SLICE_MIN_REUSE``): they won on the card at synthetic
    Reddit's 101 edges a row and lost at 6.9 and 0.43."""
    assert sk.slice_width(232_965, 602, False, 4, reuse) == want
    assert sk.padded_width(232_965, 602, None, 4, reuse) == \
        (608 if want == 32 else 602)
    assert smk.max_bwd_slice_width(232_965, 602, 0, False, 4, reuse) == want
    assert sk.edges_per_row(225_880, 524_288, 32_768) == 225_880 / 524_288
