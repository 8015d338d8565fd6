"""The dense-hub hybrid: the port against the JAX package's.

Mirrors ``tests/test_hybrid_spmm.py``: on a graph where a few dst nodes
take most edges, ``prepare_spmm(..., dense_threshold=...)`` densifies the
hub windows (a bf16 count matrix C times x) and leaves the rest to K1 (its
plain version here, on the CPU).  Inputs are made from a seed with numpy
and go through both packages.

Tolerances: float32 results <= 1e-4 * max|ref| against the JAX hybrid,
whose dense product and Pallas remainder take the f32x2 split (~2^-16
relative error; the port's products run in full float32), and against
the JAX bare graph as in the JAX test; bf16 results within one bf16 ulp
of the JAX hybrid (both sum in float32 and round once).  Window choices
are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.pallas.spmm_kernel import \
    select_dense_windows as jax_select

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
from dgl_hack_tpu_torch.ops.cuda.build import LAUNCHES

torch.set_num_threads(2)

TOL = 1e-4


def assert_close(out, ref, tol=TOL, what=""):
    out = np.asarray(out, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _edges(rng, num_nodes=500, num_edges=4000):
    """A handful of dst nodes receive most edges (test_hybrid_spmm.py)."""
    src = rng.integers(0, num_nodes, num_edges).astype(np.int32)
    hub = rng.integers(0, 40, num_edges).astype(np.int32)
    tail = rng.integers(0, num_nodes, num_edges).astype(np.int32)
    take_hub = rng.random(num_edges) < 0.8
    dst = np.where(take_hub, hub, tail).astype(np.int32)
    return src, dst


def _pair(src, dst, n, **kw):
    """(JAX bare, JAX prepared, port bare, port prepared) graphs."""
    gj = dgl.graph((src, dst), num_nodes=n)
    gt = dt.graph((src, dst), num_nodes=n)
    kw = dict(te=256, bc=8, wc=2, **kw)
    return gj, dgl.prepare_spmm(gj, **kw), gt, dt.prepare_spmm(gt, **kw)


def _jax_rows(gp):
    return np.asarray(gp.spmm_hybrid_arrays[-1])


@pytest.mark.parametrize("reducer", ["sum", "mean"])
def test_hybrid_copy_u(rng, reducer):
    src, dst = _edges(rng)
    gj, gjp, gt, gtp = _pair(src, dst, 500, weighted=False,
                             dense_threshold=200)
    hyb = gtp.derived["hybrid"]
    np.testing.assert_array_equal(hyb.rows.numpy(), _jax_rows(gjp))
    x = rng.normal(size=(500, 128)).astype(np.float32)
    ref = dgl.gspmm(gjp, "copy_lhs", reducer, jnp.asarray(x))
    bare = dgl.gspmm(gj, "copy_lhs", reducer, jnp.asarray(x))
    LAUNCHES.reset()
    out = dt.gspmm(gtp, "copy_lhs", reducer, torch.from_numpy(x))
    assert_close(out, ref, what="vs JAX hybrid")
    assert_close(out, bare, what="vs JAX bare")
    # the hybrid's remainder went through K1's plain version (a CPU
    # tensor launches no kernel and counts nothing)
    assert LAUNCHES.counts == {}


def test_hybrid_grad(rng):
    src, dst = _edges(rng, 300, 2500)
    gj, gjp, gt, gtp = _pair(src, dst, 300, weighted=False,
                             dense_threshold=150)
    assert "hybrid" in gtp.derived
    x = rng.normal(size=(300, 32)).astype(np.float32)
    tgt = rng.normal(size=(300, 32)).astype(np.float32)

    def loss_j(graph, x_):
        return ((dgl.gspmm(graph, "copy_lhs", "sum", x_) - tgt) ** 2).sum()
    gx_ref = jax.grad(loss_j, argnums=1)(gjp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    loss = ((dt.gspmm(gtp, "copy_lhs", "sum", xt)
             - torch.from_numpy(tgt)) ** 2).sum()
    (gx,) = torch.autograd.grad(loss, xt)
    assert_close(gx, gx_ref, what="dx")


def test_hybrid_all_windows_dense(rng):
    """threshold=1: every nonempty window goes dense, the remainder is
    empty."""
    src, dst = _edges(rng, 200, 1500)
    gj, gjp, gt, gtp = _pair(src, dst, 200, weighted=False,
                             dense_threshold=1)
    hyb = gtp.derived["hybrid"]
    assert hyb.rem.num_edges() == 0
    np.testing.assert_array_equal(hyb.rows.numpy(), _jax_rows(gjp))
    x = rng.normal(size=(200, 16)).astype(np.float32)
    ref = dgl.gspmm(gjp, "copy_lhs", "sum", jnp.asarray(x))
    assert_close(dt.gspmm(gtp, "copy_lhs", "sum", torch.from_numpy(x)), ref)


def test_hybrid_multigraph_duplicate_edges(rng):
    """Duplicate (u, v) pairs: C carries their counts exactly."""
    src = np.repeat(rng.integers(0, 50, 100), 5).astype(np.int32)
    dst = np.repeat(rng.integers(0, 8, 100), 5).astype(np.int32)
    gj, gjp, gt, gtp = _pair(src, dst, 50, weighted=False,
                             dense_threshold=1)
    C = gtp.derived["hybrid"].C.float().numpy()
    np.testing.assert_array_equal(
        C, np.asarray(gjp.spmm_hybrid_arrays[-2]).astype(np.float32))
    assert C.max() >= 5
    x = rng.normal(size=(50, 16)).astype(np.float32)
    ref = dgl.gspmm(gjp, "copy_lhs", "sum", jnp.asarray(x))
    assert_close(dt.gspmm(gtp, "copy_lhs", "sum", torch.from_numpy(x)), ref)


@pytest.mark.parametrize("op", ["copy_lhs", "mul"])
def test_hybrid_weighted_falls_back_to_full_plan(rng, op):
    """u_mul_e does not take the dense path (C is unweighted): the port's
    full plan (the graph's own arrays) serves it, copy_u the hybrid."""
    src, dst = _edges(rng)
    gj, gjp, gt, gtp = _pair(src, dst, 500, weighted=True,
                             dense_threshold=200)
    assert "hybrid" in gtp.derived and gjp.spmm_plan_arrays is not None
    assert {"k1_plan_csc", "k1_plan_csr"} <= set(gtp.derived)
    x = rng.normal(size=(500, 64)).astype(np.float32)
    w = rng.normal(size=(gt.num_edges(), 1)).astype(np.float32)
    args_j = (jnp.asarray(x),) if op == "copy_lhs" else \
        (jnp.asarray(x), jnp.asarray(w), "u", "e")
    args_t = (torch.from_numpy(x),) if op == "copy_lhs" else \
        (torch.from_numpy(x), torch.from_numpy(w), "u", "e")
    ref = dgl.gspmm(gjp, op, "sum", *args_j)
    assert_close(dt.gspmm(gtp, op, "sum", *args_t), ref)


def test_hybrid_3d_features(rng):
    src, dst = _edges(rng, 200, 1500)
    gj, gjp, gt, gtp = _pair(src, dst, 200, weighted=False,
                             dense_threshold=100)
    x = rng.normal(size=(200, 4, 8)).astype(np.float32)
    ref = dgl.gspmm(gjp, "copy_lhs", "sum", jnp.asarray(x))
    out = dt.gspmm(gtp, "copy_lhs", "sum", torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    assert_close(out, ref)


def test_hybrid_multigraph_over_exact_range_not_densified(rng):
    """A (dst, src) pair repeated past bf16's exact integers (256) keeps
    its window sparse, as in the JAX package; the result stays exact."""
    src = np.repeat(rng.integers(0, 20, 4), 300).astype(np.int32)
    dst = np.repeat(rng.integers(0, 4, 4), 300).astype(np.int32)
    gj, gjp, gt, gtp = _pair(src, dst, 20, weighted=False,
                             dense_threshold=1)
    assert "hybrid" not in gtp.derived
    assert gjp.spmm_hybrid_arrays is None
    x = rng.normal(size=(20, 8)).astype(np.float32)
    ref = dgl.gspmm(gj, "copy_lhs", "sum", jnp.asarray(x))
    assert_close(dt.gspmm(gtp, "copy_lhs", "sum", torch.from_numpy(x)), ref)


@pytest.mark.parametrize("threshold,budget", [
    (400, 2 * 1000 * 2), (400, 1 * 1000 * 2), (1, 8 * 1000 * 2),
    (1500, 1 << 30), (3000, 1 << 30)])
def test_select_dense_windows_budget(threshold, budget):
    """Heaviest windows first under the budget; the same ids as the JAX
    function (test_hybrid_spmm.py's case and more)."""
    indptr = np.array([0, 1000, 1000, 1500, 1500, 1500, 3000, 3000, 3001])
    kw = dict(num_src=1000, num_dst=8, tr=1, threshold=threshold,
              budget_bytes=budget)
    np.testing.assert_array_equal(sk.select_dense_windows(indptr, **kw),
                                  jax_select(indptr, **kw))


def test_select_dense_windows_budget_values():
    indptr = np.array([0, 1000, 1000, 1500, 1500, 1500, 3000, 3000, 3001])
    assert list(sk.select_dense_windows(
        indptr, 1000, 8, 1, threshold=400, budget_bytes=2 * 1000 * 2)) \
        == [0, 5]
    assert list(sk.select_dense_windows(
        indptr, 1000, 8, 1, threshold=400, budget_bytes=1 * 1000 * 2)) == [5]


@pytest.mark.parametrize("reducer", ["sum", "mean"])
def test_hybrid_bf16(rng, reducer):
    """bf16 features: K1's remainder and the dense product sum in float32
    and the rows round once, as the JAX hybrid does (its dense dot takes
    bf16 operands with a float32 result, spmm_kernel.py:1358-1362)."""
    src, dst = _edges(rng, 300, 2500)
    gj, gjp, gt, gtp = _pair(src, dst, 300, weighted=False,
                             dense_threshold=150)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(dgl.gspmm(gjp, "copy_lhs", reducer, xb), np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    out = dt.gspmm(gtp, "copy_lhs", reducer, xt)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert np.all(np.abs(out - ref) <= bf16_ulp(ref)), \
        float(np.abs(out - ref).max())


def test_hybrid_bf16_grad(rng):
    """dx in bf16: K1 over the remainder's CSR in float32 plus Cᵀ g in
    float32, rounded once (_gspmm_hybrid_bwd)."""
    src, dst = _edges(rng, 300, 2500)
    gj, gjp, gt, gtp = _pair(src, dst, 300, weighted=False,
                             dense_threshold=150)
    x = rng.normal(size=(300, 32)).astype(np.float32)
    t = rng.normal(size=(300, 32)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = jnp.asarray(t).astype(jnp.bfloat16)
    gx_ref = jax.grad(lambda xx: (dgl.gspmm(gjp, "copy_lhs", "sum", xx)
                                  .astype(jnp.float32)
                                  * tb.astype(jnp.float32)).sum())(xb)
    gx_ref = np.asarray(gx_ref, np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    xt.requires_grad_(True)
    tt = torch.from_numpy(np.array(tb.astype(jnp.float32))).bfloat16()
    out = dt.gspmm(gtp, "copy_lhs", "sum", xt)
    (gx,) = torch.autograd.grad((out.float() * tt.float()).sum(), xt)
    assert gx.dtype == torch.bfloat16
    gx = gx.float().numpy()
    assert np.all(np.abs(gx - gx_ref) <= bf16_ulp(gx_ref)), \
        float(np.abs(gx - gx_ref).max())


def test_dense_count_matmul(rng):
    """C @ x and its transpose as the backward, in float32."""
    C = torch.from_numpy(rng.integers(0, 4, (6, 40)).astype(np.float32)) \
        .bfloat16()
    x = torch.tensor(rng.normal(size=(40, 5)).astype(np.float32),
                     requires_grad=True)
    out = sk.dense_count_matmul(C, x)
    assert out.dtype == torch.float32
    ref = C.double() @ x.detach().double()
    assert_close(out.detach(), ref, 1e-6)
    g = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    (gx,) = torch.autograd.grad((out * g).sum(), x)
    assert_close(gx, C.double().t() @ g.double(), 1e-6)


def test_graph_carries_hybrid(rng):
    """prepare_spmm returns a graph whose own cache holds the hybrid; the
    bare graph's cache is left without it.  replace() without a structure
    change and to() carry it; a structure change, a masked graph and
    dense_hub=False drop it."""
    src, dst = _edges(rng, 200, 1500)
    gt = dt.graph((src, dst), num_nodes=200)
    gp = dt.prepare_spmm(gt, dense_threshold=100)
    assert "hybrid" in gp.derived and "hybrid" not in gt.derived
    assert gp.derived is not gt.derived
    assert gp.local_var().derived["hybrid"] is gp.derived["hybrid"]
    moved = gp.to("cpu")
    assert moved.derived is not gp.derived
    assert torch.equal(moved.derived["hybrid"].rows,
                       gp.derived["hybrid"].rows)
    assert "hybrid" not in gp.replace(
        edge_mask=torch.ones(gp.num_edges(), dtype=torch.bool)).derived
    assert "hybrid" not in dt.prepare_spmm(gp, dense_hub=False).derived
    masked = gt.replace(edge_mask=torch.from_numpy(rng.random(1500) < 0.7))
    assert "hybrid" not in dt.prepare_spmm(masked,
                                           dense_threshold=1).derived


def test_default_breakeven_uses_the_card():
    """The default threshold is the card's breakeven: the C read at the
    card's memory rate and the float32 product at flat_width, against
    K1's measured time per edge; at least 4 tr."""
    N, tr = 1_000_000, 128
    read = tr * N * 2 / sk.CARD_BYTES_PER_S
    gemm = 2.0 * tr * N * 128 / sk.DENSE_FP32_OPS_PER_S
    want = int(max(read, gemm) / (sk.K1_NS_PER_EDGE * 1e-9))
    assert sk._dense_breakeven(N, tr, 128) == max(4 * tr, want)
    assert sk._dense_breakeven(10, tr) == 4 * tr
