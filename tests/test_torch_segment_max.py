"""gspmm max/min of the PyTorch port (K4, K5 and GspmmMax) against the JAX
package's Pallas max kernel, on the CPU with inputs made from a seed.

The JAX side runs on a ``prepare_spmm``'d graph, so its max kernel runs
in interpret mode.  On the CPU the port runs GspmmMax through K4's and
K5's plain versions.  Tolerances (max abs error / max |reference|):

* copy_u forward: bitwise equal (the max is exact on both sides);
* weighted and dst-side forwards: 1e-6 (the JAX kernel's weighted
  messages pass through its exact one-hot select; the products agree);
* gradients: 1e-5 (the sums run in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
from dgl_hack_tpu_torch.ops.cuda.segment_max_kernel import (
    MINMAX_NEG, segment_max_bwd_plain, segment_max_plain)

torch.set_num_threads(2)

FWD_TOL = 1e-6
GRAD_TOL = 1e-5


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _graphs(src, dst, n):
    gj = dgl.graph((src, dst), num_nodes=n)
    return gj, dgl.prepare_spmm(gj, te=256, bc=8, wc=2), dt.graph(
        (src, dst), num_nodes=n)


def _random(rng, n=300, e=2000, empty_from=260):
    return _graphs(rng.integers(0, n, e), rng.integers(0, empty_from, e), n)


def _both(gj, gt, op, reducer, lhs, rhs, lt="u", rt="e", t=None):
    """Forward and the gradients of sum(out * t) through both packages."""
    args = [a for a in (lhs, rhs) if a is not None]

    def fwd_j(*a):
        return dgl.gspmm(gj, op, reducer, *a, lt, rt) if len(a) == 2 \
            else dgl.gspmm(gj, op, reducer, a[0])
    out_j = fwd_j(*map(jnp.asarray, args))
    if t is None:
        t = np.random.default_rng(7).normal(size=out_j.shape).astype(
            np.float32)
    grads_j = jax.grad(lambda *a: (fwd_j(*a) * t).sum(),
                       argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    out_t = dt.gspmm(gt, op, reducer, *ins, lt, rt) if len(ins) == 2 \
        else dt.gspmm(gt, op, reducer, ins[0])
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(t)).sum(), ins)
    return ((np.asarray(out_j), [np.asarray(g) for g in grads_j]),
            (out_t.detach().numpy(), [g.numpy() for g in grads_t]))


def _check_grads(res_j, res_t, names=("dx", "dw")):
    for name, a, b in zip(names, res_t[1], res_j[1]):
        assert_close(a, b, GRAD_TOL, name)


@pytest.mark.parametrize("reducer", ["max", "min"])
def test_copy_u_minmax_bitwise(reducer):
    rng = np.random.default_rng(1)
    _, gp, gt = _random(rng)
    x = rng.normal(size=(300, 40)).astype(np.float32)
    rj, rt = _both(gp, gt, "copy_lhs", reducer, x, None)
    np.testing.assert_array_equal(rt[0], rj[0])
    assert not rt[0][260:].any()                  # zero in-degree rows
    _check_grads(rj, rt)


@pytest.mark.parametrize("wshape", ["scalar", "col", "full"])
@pytest.mark.parametrize("reducer", ["max", "min"])
def test_u_mul_e_minmax(reducer, wshape):
    rng = np.random.default_rng(2)
    _, gp, gt = _random(rng)
    E, F = gt.num_edges(), 16
    x = rng.normal(size=(300, F)).astype(np.float32)
    w = rng.normal(size={"scalar": (E,), "col": (E, 1),
                         "full": (E, F)}[wshape]).astype(np.float32)
    rj, rt = _both(gp, gt, "mul", reducer, x, w)
    assert_close(rt[0], rj[0], FWD_TOL, "forward")
    assert not rt[0][260:].any()
    _check_grads(rj, rt)


def test_minmax_neg_rule():
    """Messages are clamped at MINMAX_NEG; a row whose max is at or below
    MINMAX_NEG / 2 gives 0 (and passes no gradient), one above keeps it."""
    rng = np.random.default_rng(3)
    n = 40
    src = np.concatenate([rng.integers(30, 40, 60), rng.integers(20, 30, 60),
                          rng.integers(10, 20, 60), rng.integers(0, 40, 200)])
    dst = np.concatenate([rng.integers(0, 10, 60), rng.integers(10, 20, 60),
                          rng.integers(20, 30, 60), rng.integers(30, 40, 200)])
    _, gp, gt = _graphs(src, dst, n)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    x[30:40] = -1e31                 # clamped to -1e30: rows 0..9 give 0
    x[20:30] = -6e29                 # below -5e29: rows 10..19 give 0
    x[10:20] = -4e29                 # above -5e29: rows 20..29 keep it
    rj, rt = _both(gp, gt, "copy_lhs", "max", x, None)
    np.testing.assert_array_equal(rt[0], rj[0])
    assert not rt[0][:20].any()
    np.testing.assert_array_equal(rt[0][20:30], np.float32(-4e29))
    assert not rt[1][0][20:40].any()              # no gradient to them
    _check_grads(rj, rt)


@pytest.mark.parametrize("reducer", ["max", "min"])
def test_ties_get_full_cotangent(reducer):
    """Integer features on a graph with repeated neighbours tie often.  The
    port gives every tied edge the full cotangent, as the JAX kernel path
    does; the JAX bare graph (composed path) splits it among the ties."""
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 30, 400), rng.integers(0, 25, 400)
    gj, gp, gt = _graphs(src, dst, 30)
    x = rng.integers(0, 3, size=(30, 4)).astype(np.float32)
    t = np.ones((30, 4), np.float32)
    rj, rt = _both(gp, gt, "copy_lhs", reducer, x, None, t=t)
    np.testing.assert_array_equal(rt[0], rj[0])
    np.testing.assert_array_equal(rt[1][0], rj[1][0])
    # the composed path splits: its dx sums to one per covered (v, f)
    rb, _ = _both(gj, gt, "copy_lhs", reducer, x, None, t=t)
    covered = 25 * 4
    assert abs(float(rb[1][0].sum()) - covered) < 1e-3
    assert float(rt[1][0].sum()) > covered + 10


V_SIDE = [("add", "u", "v"), ("sub", "u", "v"), ("sub", "v", "u"),
          ("mul", "u", "v")]


@pytest.mark.parametrize("reducer", ["max", "min"])
@pytest.mark.parametrize("op,lt,rt", V_SIDE)
def test_v_side_minmax(op, lt, rt, reducer):
    """The dst-side max/min rewrite against the JAX package's, whose copy
    reduce runs its max kernel; y of both signs for mul."""
    rng = np.random.default_rng(5)
    _, gp, gt = _random(rng)
    F = 6
    lhs = rng.normal(size=(300, F)).astype(np.float32)
    rhs = rng.uniform(-1.5, 1.5, size=(300, F)).astype(np.float32)
    rj, rtt = _both(gp, gt, op, reducer, lhs, rhs, lt, rt)
    assert_close(rtt[0], rj[0], FWD_TOL, "forward")
    assert not rtt[0][260:].any()
    _check_grads(rj, rtt, ("dlhs", "drhs"))


def _loop_max(indptr, gidx, x, w):
    raw = np.full((len(indptr) - 1, x.shape[1]), MINMAX_NEG, np.float32)
    for r in range(len(indptr) - 1):
        for j in range(indptr[r], indptr[r + 1]):
            m = x[gidx[j]] * (1.0 if w is None else
                              (w[j] if w.ndim == 2 else w[j:j + 1]))
            raw[r] = np.maximum(raw[r], np.maximum(m, MINMAX_NEG))
    return raw


@pytest.mark.parametrize("wkind", ["none", "scalar", "full"])
def test_plain_versions_in_chunks(monkeypatch, wkind):
    """K4's, K5's and K1's plain versions give the same answer when their
    row blocks are tiny (many chunks) as in one block, and K4's matches a
    numpy loop."""
    rng = np.random.default_rng(6)
    _, _, gt = _random(rng, n=80, e=600, empty_from=70)
    E, F = 600, 5
    x = torch.from_numpy(rng.normal(size=(80, F)).astype(np.float32))
    w = None if wkind == "none" else torch.from_numpy(
        rng.normal(size=(E,) if wkind == "scalar" else (E, F))
        .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(80, F)).astype(np.float32))
    dst_csr = sk.rev_gidx(gt)

    def run():
        raw = segment_max_plain(gt.csc_indptr, x, gt.src, w)
        grads = segment_max_bwd_plain(gt.csr_indptr, dst_csr, gt.csr_eids,
                                      x, w, raw, g)
        s = sk.segment_sum_plain(gt.csr_indptr, g, dst_csr, gt.csr_eids, w)
        return raw, grads, s
    whole = run()
    monkeypatch.setattr(sk, "PLAIN_CHUNK_ELEMS", 3 * F)
    assert len(list(sk.row_chunks(gt.csc_indptr, F))) > 60
    parts = run()
    np.testing.assert_array_equal(parts[0].numpy(), whole[0].numpy())
    np.testing.assert_array_equal(
        whole[0].numpy(), _loop_max(gt.host("csc_indptr"), gt.host("src"),
                                    x.numpy(), None if w is None
                                    else w.numpy()))
    for a, b in zip(parts[1], whole[1]):
        if b is not None:
            assert_close(a.numpy(), b.numpy(), GRAD_TOL)
    assert_close(parts[2].numpy(), whole[2].numpy(), GRAD_TOL)
