"""gspmm parity between the PyTorch port and the JAX package.

Two paths of the port are checked, on the CPU, with inputs made from a
seed with numpy:

* ``dt.gspmm`` on CPU tensors (the composed plain path) against the JAX
  bare graph (composed XLA, exact f32): max abs error <= 1e-5 * max|ref|,
  only the summation order differs;
* ``GspmmSum`` (the autograd.Function around K1, running K1's plain
  version on the CPU) against the JAX prepared graph (Pallas in interpret
  mode, f32x2 split): <= 1e-4 * max|ref|, since f32x2 carries ~2^-16
  relative error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda.spmm_kernel import (
    gspmm_sum, prepare_spmm, segment_sum)

torch.set_num_threads(2)

BARE_TOL = 1e-5
PALLAS_TOL = 1e-4


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _graphs(rng, num_nodes=300, num_edges=2000, hub=0, empty_from=None):
    src = rng.integers(0, num_nodes, num_edges)
    hi = num_nodes if empty_from is None else empty_from
    dst = rng.integers(0, hi, num_edges)
    if hub:
        dst[:hub] = 0
    gj = dgl.graph((src, dst), num_nodes=num_nodes)
    gt = dt.graph((src, dst), num_nodes=num_nodes)
    return gj, gt


def _run_both(gj, gt, op, reducer, x, w, jax_graph=None, port_fn=None):
    """Forward and grads (dx, dw) of sum(out * t) through both packages."""
    rng = np.random.default_rng(7)
    xj = jnp.asarray(x)
    wj = None if w is None else jnp.asarray(w)
    gjj = gj if jax_graph is None else jax_graph

    def fwd(xx, ww):
        return dgl.gspmm(gjj, op, reducer, xx, ww, "u", "e")
    out_j = fwd(xj, wj)
    t = rng.normal(size=out_j.shape).astype(np.float32)
    argn = (0,) if w is None else (0, 1)
    grads_j = jax.grad(lambda xx, ww: (fwd(xx, ww) * t).sum(),
                       argnums=argn)(xj, wj)

    xt = torch.tensor(x, requires_grad=True)
    wt = None if w is None else torch.tensor(w, requires_grad=True)
    if port_fn is None:
        out_t = dt.gspmm(gt, op, reducer, xt, wt, "u", "e")
    else:
        out_t = port_fn(gt, xt, wt)
    ins = [xt] if w is None else [xt, wt]
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(t)).sum(), ins)
    return (out_j, grads_j), (out_t.detach(), [g.numpy() for g in grads_t])


def _check(res_j, res_t, tol):
    (out_j, grads_j), (out_t, grads_t) = res_j, res_t
    assert_close(out_t.numpy(), out_j, tol, "forward")
    for name, a, b in zip(("dx", "dw"), grads_t, grads_j):
        assert_close(a, b, tol, name)


@pytest.mark.parametrize("F", [7, 16, 64])
@pytest.mark.parametrize("reducer", ["sum", "mean"])
def test_copy_u_plain_vs_bare(reducer, F):
    rng = np.random.default_rng(F)
    gj, gt = _graphs(rng, empty_from=250)          # rows 250.. are empty
    x = rng.normal(size=(300, F)).astype(np.float32)
    rj, rt = _run_both(gj, gt, "copy_lhs", reducer, x, None)
    _check(rj, rt, BARE_TOL)
    assert float(rt[0][250:].abs().max()) == 0.0


@pytest.mark.parametrize("wshape", ["scalar_col", "full", "heads"])
def test_u_mul_e_plain_vs_bare(wshape):
    rng = np.random.default_rng(1)
    gj, gt = _graphs(rng)
    E = gt.num_edges()
    if wshape == "heads":                           # (N,H,D) x (E,H,1)
        x = rng.normal(size=(300, 4, 8)).astype(np.float32)
        w = rng.normal(size=(E, 4, 1)).astype(np.float32)
    else:
        x = rng.normal(size=(300, 16)).astype(np.float32)
        w = rng.normal(size=(E, 1) if wshape == "scalar_col"
                       else (E, 16)).astype(np.float32)
    _check(*_run_both(gj, gt, "mul", "sum", x, w), BARE_TOL)


def test_u_mul_e_vector_plain_vs_bare():
    """1-D node data with one weight per edge: (N,) x (E,)."""
    rng = np.random.default_rng(2)
    gj, gt = _graphs(rng)
    x = rng.normal(size=(300,)).astype(np.float32)
    w = rng.normal(size=(gt.num_edges(),)).astype(np.float32)
    _check(*_run_both(gj, gt, "mul", "sum", x, w), BARE_TOL)


@pytest.mark.parametrize("reducer", ["max", "min", "prod"])
def test_other_reducers_plain_vs_bare(reducer):
    """max/min (through GspmmMax's plain versions on the CPU) and prod (the
    composed path) against the JAX bare graph."""
    rng = np.random.default_rng(3)
    gj, gt = _graphs(rng, empty_from=280)
    x = rng.uniform(0.5, 1.5, size=(300, 5)).astype(np.float32)
    out_j = dgl.gspmm(gj, "copy_lhs", reducer, jnp.asarray(x))
    out_t = dt.gspmm(gt, "copy_lhs", reducer, torch.from_numpy(x))
    assert_close(out_t.numpy(), out_j, BARE_TOL, reducer)


def _kernel_path(gt, xt, wt):
    return gspmm_sum(gt, xt, wt)


@pytest.mark.parametrize("case", ["copy_u", "scalar", "scalar_col", "full"])
def test_kernel_function_vs_prepared(case):
    """GspmmSum (K1 plain version on CPU) against the JAX Pallas kernel."""
    rng = np.random.default_rng(4)
    gj, gt = _graphs(rng, empty_from=260)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
    E = gt.num_edges()
    x = rng.normal(size=(300, 32)).astype(np.float32)
    w = {"copy_u": None,
         "scalar": rng.normal(size=(E,)).astype(np.float32),
         "scalar_col": rng.normal(size=(E, 1)).astype(np.float32),
         "full": rng.normal(size=(E, 32)).astype(np.float32)}[case]
    op = "copy_lhs" if w is None else "mul"
    rj, rt = _run_both(gj, gt, op, "sum", x, w, jax_graph=gp,
                       port_fn=_kernel_path)
    _check(rj, rt, PALLAS_TOL)


def test_kernel_function_hub_split_across_chunks():
    """A hub row larger than a whole Pallas chunk (te=256, bc=8)."""
    rng = np.random.default_rng(5)
    gj, gt = _graphs(rng, num_nodes=100, num_edges=3000, hub=2500)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2, flat=False)
    assert gp.spmm_plan_meta[0][4] >= 2
    x = rng.normal(size=(100, 16)).astype(np.float32)
    _check(*_run_both(gj, gt, "copy_lhs", "sum", x, None, jax_graph=gp,
                      port_fn=_kernel_path), PALLAS_TOL)


def test_kernel_function_odd_width_mean():
    """F=7 (GCN's output width on Cora) through K1 with mean."""
    rng = np.random.default_rng(6)
    gj, gt = _graphs(rng, empty_from=270)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
    x = rng.normal(size=(300, 7)).astype(np.float32)

    def port_mean(g, xt, wt):
        deg = g.in_degrees().to(torch.float32).clamp(min=1)
        return gspmm_sum(g, xt) / deg[:, None]

    _check(*_run_both(gj, gt, "copy_lhs", "mean", x, None, jax_graph=gp,
                      port_fn=port_mean), PALLAS_TOL)


@pytest.mark.parametrize("mode", ["fwd", "rev", "edge"])
def test_segment_sum_wrapper_modes(mode):
    """The three K1 call sites on the CPU against a numpy loop."""
    rng = np.random.default_rng(8)
    _, gt = _graphs(rng, num_nodes=80, num_edges=500, empty_from=70)
    gt = prepare_spmm(gt)
    F = 5
    if mode == "fwd":
        x = rng.normal(size=(80, F)).astype(np.float32)
        w = rng.normal(size=(500,)).astype(np.float32)
        out = segment_sum(gt.csc_indptr, torch.from_numpy(x), gt.src,
                          w=torch.from_numpy(w))
        indptr, gidx, eid = gt.host("csc_indptr"), gt.host("src"), None
    elif mode == "rev":
        x = rng.normal(size=(80, F)).astype(np.float32)
        w = rng.normal(size=(500, F)).astype(np.float32)
        out = segment_sum(gt.csr_indptr, torch.from_numpy(x),
                          gt.derived["dst_csr"], gt.csr_eids,
                          torch.from_numpy(w), site="rev")
        indptr = gt.host("csr_indptr")
        gidx = gt.host("dst")[gt.host("csr_eids")]
        eid = gt.host("csr_eids")
    else:
        x = rng.normal(size=(500, F)).astype(np.float32)
        w = None
        out = segment_sum(gt.csc_indptr, torch.from_numpy(x), site="edge")
        indptr, gidx, eid = gt.host("csc_indptr"), None, None
    ref = np.zeros((len(indptr) - 1, F), np.float32)
    for r in range(len(indptr) - 1):
        for j in range(indptr[r], indptr[r + 1]):
            m = x[j if gidx is None else gidx[j]].copy()
            if w is not None:
                e = j if eid is None else eid[j]
                m = m * w[e]
            ref[r] += m
    assert_close(out.numpy(), ref, BARE_TOL, mode)


def test_masked_graph_plain_vs_bare():
    """Padded edges contribute nothing on the CPU composed path."""
    rng = np.random.default_rng(9)
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    mask = rng.random(400) > 0.3
    gj = dgl.graph((src, dst), num_nodes=50, edge_mask=mask)
    gt = dt.graph((src, dst), num_nodes=50, edge_mask=mask)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    for red in ("sum", "mean"):
        out_j = dgl.gspmm(gj, "copy_lhs", red, jnp.asarray(x))
        out_t = dt.gspmm(gt, "copy_lhs", red, torch.from_numpy(x))
        assert_close(out_t.numpy(), out_j, BARE_TOL, red)


V_SIDE = [("add", "u", "v", "sum"), ("sub", "u", "v", "mean"),
          ("sub", "v", "u", "sum"), ("mul", "e", "v", "sum"),
          ("div", "v", "e", "mean"), ("div", "u", "v", "sum"),
          ("dot", "u", "v", "sum"), ("add", "v", "v", "sum")]


def _v_side_inputs(rng, gt, lt, rt, F=6):
    size = {"u": gt.num_src_nodes, "v": gt.num_dst_nodes,
            "e": gt.num_edges()}
    lhs = rng.uniform(0.5, 1.5, size=(size[lt], F)).astype(np.float32)
    rhs = rng.uniform(0.5, 1.5, size=(size[rt], F)).astype(np.float32)
    return lhs, rhs


@pytest.mark.parametrize("op,lt,rt,reducer", V_SIDE)
def test_v_side_plain_vs_bare(op, lt, rt, reducer):
    """Dst-side operands (the per-node decomposition) against the JAX bare
    graph, forward and both grads; rows 260.. have no in-edges."""
    rng = np.random.default_rng(10)
    gj, gt = _graphs(rng, empty_from=260)
    lhs, rhs = _v_side_inputs(rng, gt, lt, rt)

    def fwd_j(a, b):
        return dgl.gspmm(gj, op, reducer, a, b, lt, rt)
    out_j = fwd_j(jnp.asarray(lhs), jnp.asarray(rhs))
    t = rng.normal(size=out_j.shape).astype(np.float32)
    grads_j = jax.grad(lambda a, b: (fwd_j(a, b) * t).sum(), argnums=(0, 1))(
        jnp.asarray(lhs), jnp.asarray(rhs))

    a = torch.tensor(lhs, requires_grad=True)
    b = torch.tensor(rhs, requires_grad=True)
    out_t = dt.gspmm(gt, op, reducer, a, b, lt, rt)
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(t)).sum(), (a, b))
    assert_close(out_t.detach().numpy(), out_j, BARE_TOL, "forward")
    for name, gt_, gj_ in zip(("dlhs", "drhs"), grads_t, grads_j):
        assert_close(gt_.numpy(), gj_, BARE_TOL, name)
    assert float(out_t[260:].detach().abs().max()) == 0.0


class _CudaTagged(torch.Tensor):
    """A CPU tensor that reports is_cuda, to drive gspmm's CUDA dispatch
    on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def _untag(t):
    return None if t is None else t.as_subclass(torch.Tensor)


@pytest.mark.parametrize("op,lt,rt,reducer",
                         [c for c in V_SIDE if "u" in c[1:3]])
def test_v_side_reaches_kernel_on_cuda(monkeypatch, op, lt, rt, reducer):
    """On CUDA data a dst-side combo whose other operand is 'u' reduces
    through K1's wrapper and never through the composed path."""
    import importlib
    spmm_mod = importlib.import_module("dgl_hack_tpu_torch.ops.spmm")
    calls = []

    def recorder(g, x, w=None):
        calls.append(tuple(x.shape))
        return gspmm_sum(g, _untag(x), _untag(w))
    monkeypatch.setattr(spmm_mod, "gspmm_sum", recorder)
    rng = np.random.default_rng(11)
    _, gt = _graphs(rng, empty_from=260)
    lhs, rhs = _v_side_inputs(rng, gt, lt, rt)
    ref = dt.gspmm(gt, op, reducer, torch.from_numpy(lhs),
                   torch.from_numpy(rhs), lt, rt)
    spmm_mod.LAUNCHES.reset()
    out = dt.gspmm(gt, op, reducer,
                   torch.from_numpy(lhs).as_subclass(_CudaTagged),
                   torch.from_numpy(rhs).as_subclass(_CudaTagged), lt, rt)
    assert calls, "K1's wrapper was not reached"
    assert spmm_mod.LAUNCHES.counts.get("plain.gspmm_composed", 0) == 0
    assert_close(_untag(out).numpy(), ref.numpy(), BARE_TOL, "forward")


MAX_DISPATCH = [("copy_lhs", "u", "e", 1), ("mul", "u", "e", 1),
                ("add", "u", "v", 1), ("sub", "u", "v", 1),
                ("sub", "v", "u", 1), ("mul", "u", "v", 2)]


@pytest.mark.parametrize("reducer", ["max", "min"])
@pytest.mark.parametrize("op,lt,rt,launches", MAX_DISPATCH)
def test_max_min_reach_kernel_on_cuda(monkeypatch, op, lt, rt, launches,
                                      reducer):
    """On CUDA data copy_u, u_mul_e and the dst-side add/sub/mul max/min
    reduce through K4's wrapper (twice for mul, which needs both extrema
    of the other operand) and K5's in the backward, and launch nothing
    plain; the result is the CPU one."""
    import importlib
    smk = importlib.import_module(
        "dgl_hack_tpu_torch.ops.cuda.segment_max_kernel")
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = smk.segment_max, smk.segment_max_bwd

    def fwd(indptr, x, gidx, w=None, **kw):
        calls["fwd"] += 1
        return real_fwd(indptr, _untag(x), gidx, _untag(w), **kw)

    def bwd(*args, **kw):
        calls["bwd"] += 1
        return real_bwd(*(_untag(a) if isinstance(a, torch.Tensor) else a
                          for a in args), **kw)
    monkeypatch.setattr(smk, "segment_max", fwd)
    monkeypatch.setattr(smk, "segment_max_bwd", bwd)
    rng = np.random.default_rng(12)
    _, gt = _graphs(rng, empty_from=260)
    lhs, rhs = _v_side_inputs(rng, gt, lt, rt)
    if op == "copy_lhs":
        rhs = None
    ref = dt.gspmm(gt, op, reducer, torch.from_numpy(lhs),
                   None if rhs is None else torch.from_numpy(rhs), lt, rt)
    calls.update(fwd=0, bwd=0)
    ins = [torch.from_numpy(a).as_subclass(_CudaTagged).requires_grad_()
           for a in (lhs, rhs) if a is not None]
    smk.LAUNCHES.reset()
    out = dt.gspmm(gt, op, reducer, *ins, lt, rt) if rhs is not None \
        else dt.gspmm(gt, op, reducer, ins[0])
    out.sum().backward()
    assert calls == {"fwd": launches, "bwd": launches}, calls
    assert not [k for k in smk.LAUNCHES.counts if k.startswith("plain.")]
    assert_close(_untag(out).detach().numpy(), ref.numpy(), BARE_TOL,
                 "forward")
