"""gSDDMM parity between the PyTorch port and the JAX package.

``dt.gsddmm`` on CPU tensors runs ``GsddmmFn`` (the autograd.Function
around K6, running K6's and K1's plain versions on the CPU) for the
combinations K6 computes.  It is held against the JAX package's
``gsddmm`` on a ``prepare_spmm``'d graph with the sddmm kernel switched
on (``DGL_TPU_SDDMM_KERNEL=1``, Pallas in interpret mode, as
tests/test_pallas_sddmm.py runs it) and ``DGL_TPU_SPMM_MODE=highest``, so
the JAX backward's plan reductions are exact f32.  Forward and the
gradients of both operands: max abs error <= 1e-6 * max|ref| for the
elementwise ops (the row select is exact; the sums differ in order only),
1e-5 for dot.  Inputs are made from a seed with numpy; dst rows 25.. of
the 30-node graphs have no in-edges.

On CUDA data the eligible combinations must reach K6's wrapper and launch
nothing plain; the rest compose and count ``plain.gsddmm_composed``; a
masked graph reaches K6 over every edge, as the JAX package computes it
without the mask.  The dst-side swap, multi-head dot, blocks and
``out_order='eid'`` are in test_torch_sddmm_heads.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import sddmm_kernel as k6

torch.set_num_threads(2)

ELEM_TOL, DOT_TOL = 1e-6, 1e-5
N = 30


@pytest.fixture(autouse=True)
def _jax_sddmm_kernel(monkeypatch):
    monkeypatch.setenv("DGL_TPU_SDDMM_KERNEL", "1")
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    monkeypatch.delenv("DGL_TPU_DISABLE_PALLAS", raising=False)


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _edges(rng, num_edges=160, num_src=N, num_dst=N):
    src = rng.integers(0, num_src, num_edges)
    dst = rng.integers(0, num_dst - 5, num_edges)     # 5 empty dst rows
    return src, dst


def _graphs(rng, block=False):
    if block:
        src, dst = _edges(rng, num_src=N + 7)
        gj = dgl.block((src, dst), num_src=N + 7, num_dst=N)
        gt = dt.block((src, dst), num_src=N + 7, num_dst=N)
    else:
        src, dst = _edges(rng)
        gj = dgl.graph((src, dst), num_nodes=N)
        gt = dt.graph((src, dst), num_nodes=N)
    gp = dgl.prepare_spmm(gj, dense_hub=False)
    assert gp.sddmm_plan_arrays is not None
    return gp, gt


def _operand(rng, g, target, feat):
    rows = {"u": g.num_src_nodes, "v": g.num_dst_nodes,
            "e": g.num_edges()}[target]
    mag = rng.uniform(0.5, 2.0, (rows,) + feat)
    return (mag * rng.choice((-1.0, 1.0), mag.shape)).astype(np.float32)


def _run_both(gp, gt, op, lhs, rhs, lt, rt, tol, out_order="internal"):
    """Forward and the gradients of sum(out * t) for the operands given,
    through both packages."""
    args = [a for a in (lhs, rhs) if a is not None]

    def place(vals):
        it = iter(vals)
        return [None if a is None else next(it) for a in (lhs, rhs)]

    def fwd_j(*xs):
        a, b = place(xs)
        return dgl.gsddmm(gp, op, a, b, lt, rt, out_order)
    out_j = fwd_j(*map(jnp.asarray, args))
    t = np.random.default_rng(7).normal(size=out_j.shape).astype(np.float32)
    grads_j = jax.grad(lambda *xs: (fwd_j(*xs) * t).sum(),
                       argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))

    ts = [torch.tensor(a, requires_grad=True) for a in args]
    a, b = place(ts)
    out_t = dt.gsddmm(gt, op, a, b, lt, rt, out_order)
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(t)).sum(), ts)
    assert_close(out_t.detach().numpy(), out_j, tol, "forward")
    for i, (g_t, g_j) in enumerate(zip(grads_t, grads_j)):
        assert_close(g_t.numpy(), g_j, tol, f"grad {i}")
    return out_t


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot",
                                "copy_rhs"])
def test_u_op_v(op):
    rng = np.random.default_rng(1)
    gp, gt = _graphs(rng)
    x = None if op == "copy_rhs" else _operand(rng, gt, "u", (8,))
    y = _operand(rng, gt, "v", (8,))
    out = _run_both(gp, gt, op, x, y, "u", "v",
                    DOT_TOL if op == "dot" else ELEM_TOL)
    assert out.shape == ((gt.num_edges(), 1) if op == "dot"
                         else (gt.num_edges(), 8))
    assert float(out.detach().abs().max()) > 0


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot"])
def test_e_op_v(op):
    rng = np.random.default_rng(2)
    gp, gt = _graphs(rng)
    _run_both(gp, gt, op, _operand(rng, gt, "e", (6,)),
              _operand(rng, gt, "v", (6,)), "e", "v",
              DOT_TOL if op == "dot" else ELEM_TOL)


def test_zero_in_degree_rows_get_no_gradient():
    rng = np.random.default_rng(6)
    _, gt = _graphs(rng)
    y = torch.tensor(_operand(rng, gt, "v", (4,)), requires_grad=True)
    x = torch.tensor(_operand(rng, gt, "u", (4,)))
    dt.gsddmm(gt, "mul", x, y).sum().backward()
    assert float(y.grad[N - 5:].abs().max()) == 0.0


def test_plain_version_in_chunks(monkeypatch):
    """The plain version works in edge blocks; the blocks change nothing."""
    rng = np.random.default_rng(8)
    _, gt = _graphs(rng)
    x = torch.from_numpy(_operand(rng, gt, "u", (6,)))
    y = torch.from_numpy(_operand(rng, gt, "v", (6,)))
    whole = [k6.sddmm_plain(op, gt.dst, y, x, gt.src, 3)
             for op in ("add", "div", "dot")]
    monkeypatch.setattr(k6, "PLAIN_CHUNK_ELEMS", 6 * 7)
    for op, ref in zip(("add", "div", "dot"), whole):
        assert torch.equal(k6.sddmm_plain(op, gt.dst, y, x, gt.src, 3), ref)


class _CudaTagged(torch.Tensor):
    """A CPU tensor that reports is_cuda, to drive gsddmm's CUDA dispatch
    on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def _untag(t):
    return None if t is None else t.as_subclass(torch.Tensor)


def _tagged(a):
    return None if a is None else \
        torch.from_numpy(a).as_subclass(_CudaTagged).requires_grad_()


@pytest.mark.parametrize("op,lt,rt,heads", [
    ("dot", "u", "v", (4, 8)), ("add", "u", "v", (8,)),
    ("div", "e", "v", (8,)), ("sub", "v", "u", (8,)),
    ("copy_lhs", "v", "e", (8,)), ("mul", "v", "e", (2, 3))])
def test_eligible_reach_kernel_on_cuda(monkeypatch, op, lt, rt, heads):
    """On CUDA data a combination with a 'v' operand (after the swap)
    runs K6's wrapper, forward and backward, and nothing plain."""
    calls = []
    real = k6.sddmm

    def recorder(op_, dst, rhs, lhs=None, src=None, dot_d=0, *, site="fwd"):
        calls.append((op_, site))
        return real(op_, dst, _untag(rhs), _untag(lhs), src, dot_d,
                    site=site)
    real_k1 = k6.segment_sum

    def k1(indptr, x, gidx=None, eid=None, w=None, *, site="fwd",
           plan=None):
        calls.append(("segment_sum", site))
        return real_k1(indptr, _untag(x), gidx, eid, _untag(w), site=site,
                       plan=plan)
    monkeypatch.setattr(k6, "sddmm", recorder)
    monkeypatch.setattr(k6, "segment_sum", k1)
    rng = np.random.default_rng(9)
    _, gt = _graphs(rng)
    a = _operand(rng, gt, lt, heads)
    b = None if op == "copy_lhs" else _operand(rng, gt, rt, heads)
    ref = dt.gsddmm(gt, op, torch.from_numpy(a),
                    None if b is None else torch.from_numpy(b), lt, rt)
    k6.LAUNCHES.reset()
    ins = [_tagged(a), _tagged(b)]
    out = dt.gsddmm(gt, op, *ins, lt, rt)
    out.sum().backward()
    assert calls and calls[0][1] == "fwd", calls
    if op in ("dot", "mul", "div"):
        assert ("mul", "bwd") in calls, calls
    assert [c for c in calls if c[0] == "segment_sum"], calls
    assert not [k for k in k6.LAUNCHES.counts if k.startswith("plain.")]
    assert_close(_untag(out).detach().numpy(), ref.numpy(), 0.0)


@pytest.mark.parametrize("op", ["dot", "add"])
def test_graph_without_csr_reaches_kernel_on_cuda(monkeypatch, op):
    """A graph built without CSR still runs K6's forward and the rhs
    gradient (both CSC only) on CUDA data; the gradient of a node lhs
    needs the CSR direction and raises, as gspmm's backward does."""
    calls = []
    real = k6.sddmm

    def recorder(op_, dst, rhs, lhs=None, src=None, dot_d=0, *, site="fwd"):
        calls.append((op_, site))
        return real(op_, dst, _untag(rhs), _untag(lhs), src, dot_d,
                    site=site)
    real_k1 = k6.segment_sum

    def k1(indptr, x, gidx=None, eid=None, w=None, *, site="fwd",
           plan=None):
        calls.append(("segment_sum", site))
        return real_k1(indptr, _untag(x), gidx, eid, _untag(w), site=site,
                       plan=plan)
    monkeypatch.setattr(k6, "sddmm", recorder)
    monkeypatch.setattr(k6, "segment_sum", k1)
    rng = np.random.default_rng(13)
    src, dst = _edges(rng)
    gt = dt.graph((src, dst), num_nodes=N, build_csr=False)
    assert gt.csr_eids is None
    x, y = _operand(rng, gt, "u", (4, 5)), _operand(rng, gt, "v", (4, 5))
    ref = dt.gsddmm(dt.graph((src, dst), num_nodes=N), op,
                    torch.from_numpy(x), torch.from_numpy(y))
    calls.clear()
    k6.LAUNCHES.reset()
    xt = torch.from_numpy(x).as_subclass(_CudaTagged)
    yt = _tagged(y)
    out = dt.gsddmm(gt, op, xt, yt)
    assert calls == [(op, "fwd")], calls
    assert_close(_untag(out).detach().numpy(), ref.numpy(), 0.0)
    out.sum().backward()
    assert not [k for k in k6.LAUNCHES.counts if k.startswith("plain.")]
    assert float(_untag(yt.grad).abs().max()) > 0
    out = dt.gsddmm(gt, op, _tagged(x), _tagged(y))
    with pytest.raises(ValueError, match="CSR"):
        out.sum().backward()


@pytest.mark.parametrize("op,lt,rt,shapes", [
    ("add", "u", "e", ((6,), (6,))),              # no 'v' operand
    ("mul", "v", "v", ((6,), (6,))),              # both sides 'v'
    ("copy_lhs", "u", "v", ((6,), None)),         # a plain gather
    ("mul", "u", "v", ((2, 3), (2, 1))),          # broadcast shapes
    ("div", "v", "u", ((6,), (6,)))])             # v / u does not swap
def test_others_compose_on_cuda(monkeypatch, op, lt, rt, shapes):
    monkeypatch.setattr(k6, "sddmm", None)        # must not be reached
    rng = np.random.default_rng(10)
    _, gt = _graphs(rng)
    a = _operand(rng, gt, lt, shapes[0])
    b = None if shapes[1] is None else _operand(rng, gt, rt, shapes[1])
    ref = dt.gsddmm(gt, op, torch.from_numpy(a),
                    None if b is None else torch.from_numpy(b), lt, rt)
    k6.LAUNCHES.reset()
    out = dt.gsddmm(gt, op, _tagged(a), _tagged(b), lt, rt)
    assert k6.LAUNCHES.counts == {"plain.gsddmm_composed": 1}
    assert_close(_untag(out).detach().numpy(), ref.numpy(), 0.0)


def test_integer_data_composes_on_cuda():
    rng = np.random.default_rng(11)
    _, gt = _graphs(rng)
    x = torch.from_numpy(rng.integers(0, 5, (N, 3))).as_subclass(_CudaTagged)
    k6.LAUNCHES.reset()
    out = dt.gsddmm(gt, "add", x, x, "u", "v")
    assert k6.LAUNCHES.counts == {"plain.gsddmm_composed": 1}
    assert out.dtype == torch.int64


def test_masked_graph_reaches_kernel_on_cuda(monkeypatch):
    """A masked graph on CUDA data runs K6 over every edge, the padded ones
    included (the mask is not read), and launches nothing plain; the
    result is the CPU's, which is the JAX package's composed path."""
    calls = []
    real = k6.sddmm

    def recorder(op_, dst, rhs, lhs=None, src=None, dot_d=0, *, site="fwd"):
        calls.append((op_, site, dst))
        return real(op_, dst, _untag(rhs), _untag(lhs), src, dot_d,
                    site=site)
    monkeypatch.setattr(k6, "sddmm", recorder)
    rng = np.random.default_rng(12)
    src, dst = _edges(rng)
    mask = np.ones(src.shape[0], bool)
    mask[::7] = False
    gt = dt.graph((src, dst), num_nodes=N, edge_mask=mask)
    x = _operand(rng, gt, "u", (4,))
    ref = dt.gsddmm(gt, "dot", torch.from_numpy(x), torch.from_numpy(x))
    gj = dgl.graph((src, dst), num_nodes=N, edge_mask=mask)
    assert_close(ref.numpy(), np.asarray(dgl.gsddmm(
        gj, "dot", jnp.asarray(x), jnp.asarray(x))), DOT_TOL)
    calls.clear()
    k6.LAUNCHES.reset()
    out = dt.gsddmm(gt, "dot", _tagged(x), _tagged(x), "u", "v")
    assert [c[:2] for c in calls] == [("dot", "fwd")]
    assert calls[0][2] is gt.dst
    assert not [k for k in k6.LAUNCHES.counts if k.startswith("plain.")]
    assert out.shape == (gt.num_edges(), 1)
    assert_close(_untag(out).detach().numpy(), ref.numpy(), 0.0)
