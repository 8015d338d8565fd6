"""GAT edge phase parity between the PyTorch port and the JAX package.

* ``gat_attention_fused`` (the autograd.Function around K2/K3/K1, running
  their plain versions on the CPU) against the JAX fused op on a prepared
  graph (Pallas in interpret mode, f32x2 split), in both
  ``DGL_TPU_GAT_SOFTMAX`` modes: max abs error <= 1e-4 * max|ref|, forward
  and the grads of fsrc, el, er and attn_w.
* ``dt.gat_attention`` on CPU tensors (the composed plain path) against the
  JAX composed op on the bare graph: <= 1e-5 * max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.gat import gat_attention as jax_gat

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
from dgl_hack_tpu_torch.utils.env import get_config

torch.set_num_threads(2)

BARE_TOL = 1e-5
PALLAS_TOL = 1e-4


@pytest.fixture(params=["shift", "exact"])
def softmax_mode(request, monkeypatch):
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", request.param)
    return request.param


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _graphs(rng, num_nodes=200, num_edges=1500, isolated=0):
    src = rng.integers(0, num_nodes, num_edges)
    dst = rng.integers(0, num_nodes - isolated, num_edges)
    return (dgl.graph((src, dst), num_nodes=num_nodes),
            dt.graph((src, dst), num_nodes=num_nodes))


def _inputs(rng, N, E, H, D, scale=1.0, with_w=True):
    fsrc = rng.normal(size=(N, H, D)).astype(np.float32)
    el = (scale * rng.normal(size=(N, H))).astype(np.float32)
    er = (scale * rng.normal(size=(N, H))).astype(np.float32)
    w = ((rng.random((E, H)) > 0.3).astype(np.float32) / 0.7
         if with_w else None)
    t = rng.normal(size=(N, H, D)).astype(np.float32)
    return fsrc, el, er, w, t


def _jax_run(g, fsrc, el, er, w, t):
    args = [jnp.asarray(a) for a in (fsrc, el, er)]
    if w is not None:
        args.append(jnp.asarray(w))

    def loss(*a):
        out = jax_gat(g, a[0], a[1], a[2], 0.2, a[3] if len(a) > 3 else None)
        return (out * t).sum(), out
    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(
        range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_run(fn, fsrc, el, er, w, t):
    ins = [torch.tensor(a, requires_grad=True) for a in (fsrc, el, er)]
    if w is not None:
        ins.append(torch.tensor(w, requires_grad=True))
    out = fn(*ins[:3], ins[3] if w is not None else None)
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), ins)
    return out.detach().numpy(), [x.numpy() for x in grads]


def _compare(rj, rt, tol):
    assert_close(rt[0], rj[0], tol, "forward")
    for name, a, b in zip(("dfsrc", "del", "der", "dattn_w"), rt[1], rj[1]):
        assert_close(a, b, tol, name)


@pytest.mark.parametrize("H,D", [(8, 8), (1, 7)])
def test_fused_vs_jax_prepared(softmax_mode, H, D):
    rng = np.random.default_rng(H * 10 + D)
    gj, gt = _graphs(rng)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
    ins = _inputs(rng, 200, gt.num_edges(), H, D)
    rj = _jax_run(gp, *ins)
    rt = _port_run(lambda f, a, b, w: gk.gat_attention_fused(
        gt, f, a, b, 0.2, w, softmax=get_config().gat_softmax), *ins)
    _compare(rj, rt, PALLAS_TOL)


def test_fused_without_attn_w(monkeypatch):
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", "shift")
    rng = np.random.default_rng(11)
    gj, gt = _graphs(rng)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
    ins = _inputs(rng, 200, gt.num_edges(), 2, 16, with_w=False)
    rj = _jax_run(gp, *ins)
    rt = _port_run(lambda f, a, b, w: gk.gat_attention_fused(
        gt, f, a, b, 0.2, None, softmax=get_config().gat_softmax), *ins)
    _compare(rj, rt, PALLAS_TOL)


def test_fused_isolated_nodes(monkeypatch):
    """Zero in-degree rows come out exactly 0 with zero gradients for er
    (exact mode: their shift is the -1e30 fill)."""
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", "exact")
    rng = np.random.default_rng(12)
    gj, gt = _graphs(rng, isolated=40)
    gp = dgl.prepare_spmm(gj, te=128, bc=8, wc=2)
    ins = _inputs(rng, 200, gt.num_edges(), 4, 4)
    rj = _jax_run(gp, *ins)
    rt = _port_run(lambda f, a, b, w: gk.gat_attention_fused(
        gt, f, a, b, 0.2, w, softmax=get_config().gat_softmax), *ins)
    _compare(rj, rt, PALLAS_TOL)
    assert float(np.abs(rt[0][160:]).max()) == 0.0
    assert float(np.abs(rt[1][2][160:]).max()) == 0.0


def test_fused_large_spread_exact(monkeypatch):
    """Per-dst logit spread > 100: the port's exact mode agrees with the
    JAX exact mode (online max), where 'shift' would underflow.  The JAX
    side runs its one-hot selects at full precision (SPMM_MODE=highest):
    f32x2 rounds the selected max by ~2^-16 * |logit|, which at logits of
    ~100 alone exceeds the 1e-4 bound."""
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", "exact")
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    rng = np.random.default_rng(13)
    gj, gt = _graphs(rng)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
    ins = _inputs(rng, 200, gt.num_edges(), 2, 8, scale=60.0)
    logit = ins[1][gt.host("src")] + ins[2][gt.host("dst")]
    assert float(np.ptp(logit)) > 100.0
    rj = _jax_run(gp, *ins)
    rt = _port_run(lambda f, a, b, w: gk.gat_attention_fused(
        gt, f, a, b, 0.2, w, softmax="exact"), *ins)
    assert np.isfinite(rt[0]).all()
    assert_close(rt[0], rj[0], PALLAS_TOL, "forward")
    assert_close(rt[1][0], rj[1][0], PALLAS_TOL, "dfsrc")
    assert_close(rt[1][3], rj[1][3], PALLAS_TOL, "dattn_w")
    # the softmax is near one-hot here, so dlogit = a * (da - sds) cancels
    # to ~1e-3 of its terms: the logit grads are held to 1e-4 of the term
    # scale max|da| (= max|dattn_w| for 0/1 dropout weights)
    term = float(np.abs(rj[1][3]).max())
    for name, i in (("del", 1), ("der", 2)):
        err = float(np.abs(rt[1][i] - rj[1][i]).max())
        assert err <= PALLAS_TOL * term, f"{name}: {err} vs {term}"


def test_plain_kernels_match_composed_autograd():
    """K2/K3 plain versions (the per-edge math of the CUDA kernels) against
    torch autograd through the composed path, in both modes."""
    rng = np.random.default_rng(30)
    _, gt = _graphs(rng, isolated=10)
    gt = dt.prepare_spmm(gt)
    fsrc, el, er, w, t = _inputs(rng, 200, gt.num_edges(), 3, 4)
    for mode in ("shift", "exact"):
        rc = _port_run(lambda f, a, b, ww: dt.gat_attention(
            gt, f, a, b, 0.2, ww), fsrc, el, er, w, t)
        rk = _port_run(lambda f, a, b, ww: gk.gat_attention_fused(
            gt, f, a, b, 0.2, ww, softmax=mode), fsrc, el, er, w, t)
        _compare(rc, rk, BARE_TOL)


BAD_SHAPES = {
    "el (N, H, 1)": lambda f, a, b: (f, a[:, :, None], b),
    "fsrc (N, H*D)": lambda f, a, b: (f.reshape(f.shape[0], -1), a, b),
}


@pytest.mark.parametrize("case", sorted(BAD_SHAPES))
def test_bad_operand_shapes_rejected(case):
    """Operands other than (N, H, D) / (N, H) / (N, H): the JAX package's
    composed path fails on them, and the port raises a ValueError that
    names the expected shapes, before it dispatches by device."""
    rng = np.random.default_rng(14)
    gj, gt = _graphs(rng)
    fsrc, el, er, _, _ = _inputs(rng, 200, gt.num_edges(), 2, 4,
                                 with_w=False)
    bad = BAD_SHAPES[case](fsrc, el, er)
    with pytest.raises(Exception):
        np.asarray(jax_gat(gj, *map(jnp.asarray, bad), 0.2))
    with pytest.raises(ValueError, match=r"fsrc \(N_src, H, D\), el "
                       r"\(N_src, H\) and er \(N_dst, H\)"):
        dt.gat_attention(gt, *map(torch.from_numpy, bad), 0.2)


def test_operand_check_ties_widths():
    """The port also names the shapes for operands the JAX composed path
    would broadcast: an er of another head count, an el of another node
    count."""
    rng = np.random.default_rng(15)
    _, gt = _graphs(rng)
    fsrc, el, er, _, _ = _inputs(rng, 200, gt.num_edges(), 2, 4,
                                 with_w=False)
    f, a, b = map(torch.from_numpy, (fsrc, el, er))
    for args in ((f, a, b[:, :1]), (f, a[:-1], b), (f[:-1], a[:-1], b)):
        with pytest.raises(ValueError, match="gat_attention takes"):
            dt.gat_attention(gt, *args, 0.2)
    assert dt.gat_attention(gt, f, a, b, 0.2).shape == fsrc.shape
