"""K4 and K5 over bf16 rows: the packed walk's rule and load widths, and
bf16 gspmm max/min against the JAX package at the widths the packed walk
takes and at the odd ones it leaves to segment_max.cu's walk.

The rule (``max_route``) is a pure function of the operands' dtype, weight
kind and load width (``packed_widths``: the width and the alignment), so
it is held here at the real shapes (synthetic Reddit's 232,965 x 640 bf16
rows, bench.py's 1,000,000 x 128, the sampled GraphSAGE's masked layer-0
block at 602) without a card: meta tensors stand for the operands.  The
packed kernels themselves run only on the card (``chip_smoke.py``'s
``bf16_kernels`` and ``bf16_reddit`` hold them to their plain versions
there).

On the CPU, ``dt.gspmm`` and ``GspmmMax`` run K4's and K5's plain
versions (``segment_max_plain``, ``segment_max_bwd_plain``), which the
packed walk must equal on the card; here they are held against the JAX
package's prepared graph (its Pallas max kernels in interpret mode, as its
own tests run them) at F = 3, 8, 64 and 130 over rows with no in-edge,
relu ties at +0 and -0, rows whose every value is equal and values below
the NEG floor, and over NaN and infinite features against its bare graph
and a numpy gradient.  Tolerance: exact (the max of bf16 values is exact,
and so is which edges hit it; the cotangents are small integers, so every
sum of the gradient is exact), and a zero max signed as its row's zeros
are where they share one sign (the JAX kernel's one-hot select gives +0
there, so that sign is held against the features).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as smk

torch.set_num_threads(2)

BF16 = torch.bfloat16
REDDIT = (232_965, 640)          # gspmm pads Reddit's 602 columns to 640
BENCH = (1_000_000, 128)
MASKED = (524_288, 602)          # the masked block: no slice, no padding


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape", [REDDIT, BENCH, MASKED])
@pytest.mark.parametrize("dtype,w_kind,want", [
    (BF16, 0, "packed"),
    (BF16, 1, "walk"),
    (BF16, 2, "walk"),
    (torch.float32, 0, "walk"),
])
def test_route_rule(shape, dtype, w_kind, want):
    """Unweighted bf16 rows take the packed walk at every shape a path runs
    (K4 over x, K5 over raw and g); float32 and weighted calls keep
    segment_max.cu's walk."""
    F = shape[1]
    x = _meta(shape, dtype)
    assert smk.max_route(dtype, w_kind, smk.packed_widths(F, x)) == want
    assert smk.max_route(dtype, w_kind, smk.packed_widths(F, x, x)) == want


@pytest.mark.parametrize("F,want", [(640, 8), (128, 8), (602, 2), (130, 2),
                                    (4, 4), (7, 1), (1, 1), (41, 1)])
def test_packed_widths(F, want):
    """16-byte loads where 8 divides F (not bound by SUM_MAX_VALUES, which
    keeps the widening walk's K5 at 4), else 4 or 2; 1 at an odd width,
    where the packed walk does not run."""
    x = _meta((10, F))
    assert smk.packed_widths(F, x) == smk.packed_widths(F, x, x) == want
    assert (smk.max_route(BF16, 0, want) == "packed") == (want >= 2)


def test_packed_widths_alignment():
    """A gathered array off its 16-byte boundary loads less at a time, and
    2 bytes off a 4-byte one cannot take bf16x2 pairs: the walk."""
    buf = torch.zeros(64 * 640 + 8, dtype=BF16)
    assert smk.packed_widths(640, buf[:64 * 640].view(64, 640)) == 8
    assert smk.packed_widths(640, buf[2:2 + 64 * 640].view(64, 640)) == 2
    off2 = buf[1:1 + 64 * 640].view(64, 640)
    assert smk.packed_widths(640, off2) == 1
    assert smk.max_route(BF16, 0, smk.packed_widths(640, off2)) == "walk"


def test_launch_names_and_routes():
    """The wrappers count the packed walk's launches apart
    (``segment_max_bf16.fwd.packed``, ``.bwd.packed``) and a launcher lists
    the routes that take its call; on CPU tensors the plain versions run
    and count nothing."""
    from dgl_hack_tpu_torch.ops.cuda.build import LAUNCHES
    _, _, gt = _graphs()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(gt.num_src_nodes, 64)).astype(
        np.float32)).to(BF16)
    LAUNCHES.reset()
    raw = smk.segment_max(gt.csc_indptr, x, gt.src)
    assert torch.equal(raw, smk.segment_max_plain(gt.csc_indptr, x, gt.src))
    assert not LAUNCHES.counts
    assert smk.gspmm_max_routes(gt, x) == ("packed", "packed")
    assert smk.gspmm_max_routes(gt, x[:, :7].contiguous()) == ("walk",
                                                               "walk")
    assert smk.gspmm_max_routes(gt, x.float()) == ("walk", "walk")
    w = torch.ones((gt.num_edges(), 1), dtype=BF16)
    assert smk.gspmm_max_routes(gt, x, w) == ("walk", "walk")


def _edge_features(rng, n, F, nonfinite=False):
    """Column c of kind c % 5: relu(z - 1.5) (ties at +0), -relu(z + 1.5)
    (ties at -0, as min over relu features), every row equal (every edge
    ties), values below the NEG floor (-3e30), normal; with ``nonfinite``,
    NaN in 1 entry of 20 and +-inf in 1 of 50 each, and no -3e30 (the JAX
    bare graph has no NEG floor).  Returns the features
    and the columns whose zeros share one sign."""
    z = rng.normal(size=(n, F)).astype(np.float32)
    x = z.copy()
    for c in range(F):
        kind = c % 5
        if kind == 0:
            x[:, c] = np.maximum(z[:, c] - 1.5, 0.0)
        elif kind == 1:
            x[:, c] = -np.maximum(z[:, c] + 1.5, 0.0)
        elif kind == 2:
            x[:, c] = 1.25
        elif kind == 3 and not nonfinite:
            x[rng.random(n) < 0.2, c] = -3e30
    if nonfinite:
        u = rng.random((n, F))
        x[u < 0.05] = np.nan
        x[(u >= 0.05) & (u < 0.07)] = np.inf
        x[(u >= 0.07) & (u < 0.09)] = -np.inf
    one_sign = np.array([c % 5 in (0, 1) for c in range(F)])
    return x, one_sign


_GRAPH = {}


def _graphs():
    """(JAX prepared, JAX bare, port) graphs: 300 nodes, 2,000 edges into
    the first 250 (rows 250.. have no in-edge), 400 of them into node 0."""
    if "g" not in _GRAPH:
        rng = np.random.default_rng(5)
        n, e = 300, 2000
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, 250, e).astype(np.int32)
        dst[:400] = 0
        gj = dgl.graph((src, dst), num_nodes=n)
        gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
        _GRAPH["g"] = (gp, gj, dt.graph((src, dst), num_nodes=n))
    return _GRAPH["g"]


def _both(gj, gt, reducer, x, cot):
    """(port out, port dx, JAX out, JAX dx) of gspmm ``reducer`` over bf16
    x and the cotangent cot (float32 arrays), as float32 numpy arrays."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(BF16)
    tj = jnp.asarray(cot).astype(jnp.bfloat16)
    tt = torch.from_numpy(cot).to(BF16)
    ref = dgl.gspmm(gj, "copy_lhs", reducer, xj)
    gx_ref = jax.grad(lambda xx: (dgl.gspmm(gj, "copy_lhs", reducer, xx)
                                  .astype(jnp.float32)
                                  * tj.astype(jnp.float32)).sum())(xj)
    xt.requires_grad_(True)
    out = dt.gspmm(gt, "copy_lhs", reducer, xt)
    (gx,) = torch.autograd.grad((out.float() * tt.float()).sum(), xt)
    assert out.dtype == gx.dtype == BF16
    return (out.detach().float().numpy(), gx.float().numpy(),
            np.asarray(ref.astype(jnp.float32)),
            np.asarray(gx_ref.astype(jnp.float32)))


@pytest.mark.parametrize("reducer", ["max", "min"])
@pytest.mark.parametrize("F", [3, 8, 64, 130])
def test_bf16_minmax_edge_cases(F, reducer):
    """bf16 gspmm max/min forward and gradient (the plain versions of K4
    and K5 on the CPU) against the JAX prepared graph: exact, empty rows
    0, and a zero result signed as its row's zeros are."""
    gp, _, gt = _graphs()
    rng = np.random.default_rng(F)
    x, one_sign = _edge_features(rng, gt.num_src_nodes, F)
    cot = rng.integers(-4, 5, size=(gt.num_dst_nodes, F)).astype(np.float32)
    o, gx, r, gx_ref = _both(gp, gt, reducer, x, cot)
    np.testing.assert_array_equal(o, r)
    # a zero max or min keeps the sign its row's zeros share (-0 in the
    # columns of kind 1); the JAX kernel's one-hot select sums to +0, so
    # the sign is held against the features' own zeros
    zero = (o[:250] == 0) & one_sign[None, :]
    assert zero.sum() > 0
    minus = np.broadcast_to(np.arange(F) % 5 == 1, zero.shape)
    np.testing.assert_array_equal(np.signbit(o[:250])[zero], minus[zero])
    assert (o[250:] == 0).all()
    np.testing.assert_array_equal(gx, gx_ref)


def _grad_ref(gt, x, cot, reducer):
    """The gradient of sum(gspmm(x) * cot) in float64 from numpy alone:
    every edge whose message equals its dst row's max (NaN kept, the NEG
    floor rounded to bf16 as both sides store it) takes that row's whole
    cotangent, where the row's output is not zeroed (max > NEG / 2)."""
    src, dst = gt.src.numpy(), gt.dst.numpy()
    neg = float(torch.tensor(-1e30).to(BF16))
    xs = np.asarray(x, np.float64) * (-1.0 if reducer == "min" else 1.0)
    m = np.where(xs < -1e30, neg, xs)
    raw = np.full((gt.num_dst_nodes, x.shape[1]), neg)
    np.maximum.at(raw, dst, m[src])
    g = np.where(raw > -5e29, cot, 0.0)
    dx = np.zeros_like(xs)
    np.add.at(dx, src, np.where(m[src] == raw[dst], g[dst], 0.0))
    return dx


@pytest.mark.parametrize("reducer", ["max", "min"])
@pytest.mark.parametrize("F", [3, 64])
def test_bf16_minmax_nonfinite(F, reducer):
    """NaN and +-inf features: a row that a NaN reaches has a NaN max,
    which the port's gspmm writes as 0 (``raw > MINMAX_NEG / 2`` is false)
    and whose gradient goes nowhere (a NaN equals nothing); an infinite
    max is itself.  The forward is held against the JAX bare graph
    (composed XLA), which keeps the NaN in those rows and agrees elsewhere;
    the gradient against ``_grad_ref`` (the bare graph splits a tie's
    cotangent; the port and the JAX kernel path give each tied edge all of
    it).  The JAX prepared graph's Pallas kernel is no reference here: its
    one-hot select multiplies a NaN or an infinity by 0 into other rows."""
    _, gj, gt = _graphs()
    rng = np.random.default_rng(F + 1)
    x, _ = _edge_features(rng, gt.num_src_nodes, F, nonfinite=True)
    cot = rng.integers(-4, 5, size=(gt.num_dst_nodes, F)).astype(np.float32)
    o, gx, r, _ = _both(gj, gt, reducer, x, cot)
    src, dst = gt.src.numpy(), gt.dst.numpy()
    hit = np.zeros((gt.num_dst_nodes, F), bool)
    np.logical_or.at(hit, dst, np.isnan(x[src]))
    assert hit.sum() > 0 and (~hit).sum() > 0 and np.isinf(o).any()
    np.testing.assert_array_equal(o[~hit], r[~hit])
    assert (o[hit] == 0).all() and np.isnan(r[hit]).all()
    xb = torch.from_numpy(x).to(BF16).double().numpy()
    np.testing.assert_array_equal(gx, _grad_ref(gt, xb, cot, reducer))
