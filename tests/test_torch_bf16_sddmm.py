"""bf16 gsddmm: the port (``GsddmmFn`` over the plain versions of K6 and
K1) against the JAX package's sddmm kernel path.

The JAX side runs ``gsddmm`` on a **prepared** graph with its sddmm kernel
switched on (``DGL_TPU_SDDMM_KERNEL=1``, Pallas in interpret mode, one-hot
selects at full precision: ``DGL_TPU_SPMM_MODE=highest``), as
``tests/test_torch_sddmm.py`` does in float32: ``_sddmm_kernel`` upcasts
its operands, ``gsddmm_pallas`` rounds the float32 result once to rhs's
dtype for copy_rhs and dot and to lhs's for add, sub, mul and div, and its
VJP computes in float32 and rounds each gradient once to its operand's
dtype.  The port runs ``dt.gsddmm`` on the CPU.  Inputs are made from a
seed with numpy (div's rhs kept away from 0).

Tolerance (``ulp``): within one bf16 ulp of each element, at the larger of
the two, plus ``SUM_TOL`` * max|ref|.  Both sides compute the same float32
function of the same bf16 values and round once; an elementwise op is one
IEEE operation, so those come out equal, and a dot or a gradient's sum
over edges may differ in its float32 order (``SUM_TOL``, the K1 and K6
float32 tolerance), which may move a value across a rounding boundary: one
ulp more.  Result and gradient dtypes equal the JAX ones.
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

N, E = 120, 900
SUM_TOL = 2e-5


@pytest.fixture(autouse=True)
def _jax_kernel(monkeypatch):
    monkeypatch.setenv("DGL_TPU_SDDMM_KERNEL", "1")
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")


def bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_ulp(out, ref, what=""):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    allow = bf16_ulp(np.maximum(np.abs(out), np.abs(ref))) \
        + SUM_TOL * float(np.abs(ref).max())
    err = float((np.abs(out - ref) / allow).max())
    assert err <= 1.0, f"{what}: {err:.3g} of the bound"


_GRAPHS = {}


def graphs():
    """(JAX prepared, port) graphs of N nodes and E random edges."""
    if not _GRAPHS:
        rng = np.random.default_rng(0)
        src = rng.integers(0, N, E)
        dst = rng.integers(0, N, E)
        gj = dgl.graph((src, dst), num_nodes=N)
        _GRAPHS["g"] = (dgl.prepare_spmm(gj, dense_hub=False),
                        dt.graph((src, dst), num_nodes=N))
    return _GRAPHS["g"]


def operands(op, lhs_target, shape, seed):
    """lhs (or None for copy_rhs), rhs and the cotangent's seed, numpy
    float32 arrays of bf16 values."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return np.asarray(jnp.asarray(a.astype(np.float32)).astype(
            jnp.bfloat16).astype(jnp.float32))
    rows = N if lhs_target == "u" else E
    lhs = None if op == "copy_rhs" else bf(rng.normal(size=(rows,) + shape))
    rhs = rng.normal(size=(N,) + shape)
    if op == "div":
        rhs = np.sign(rhs) * (0.5 + np.abs(rhs))
    return lhs, bf(rhs), seed + 1


def run_both(op, lhs, rhs, lhs_target, dtypes, seed):
    """(JAX, port) output and gradients as float32 numpy arrays, with
    their dtypes; ``dtypes`` = (lhs's, rhs's) as names."""
    gp, gt = graphs()
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    args_j = [jnp.asarray(rhs).astype(jd[dtypes[1]])]
    args_t = [torch.tensor(rhs).to(td[dtypes[1]]).requires_grad_(True)]
    if lhs is not None:
        args_j.insert(0, jnp.asarray(lhs).astype(jd[dtypes[0]]))
        args_t.insert(0, torch.tensor(lhs).to(td[dtypes[0]])
                      .requires_grad_(True))

    def call_j(*a):
        if lhs is None:
            return dgl.gsddmm(gp, op, None, a[0], lhs_target, "v")
        return dgl.gsddmm(gp, op, a[0], a[1], lhs_target, "v")
    out_j = call_j(*args_j)
    t = np.random.default_rng(seed).normal(size=out_j.shape).astype(
        np.float32)

    def f(*a):
        o = call_j(*a)
        return (o.astype(jnp.float32) * jnp.asarray(t)).sum()
    grads_j = jax.grad(f, tuple(range(len(args_j))))(*args_j)
    out_t = dt.gsddmm(gt, op, args_t[0] if lhs is not None else None,
                      args_t[-1], lhs_target, "v")
    grads_t = torch.autograd.grad(
        (out_t.float() * torch.from_numpy(t)).sum(), args_t)
    res_j = [out_j, *grads_j]
    res_t = [out_t, *grads_t]
    return ([np.asarray(x.astype(jnp.float32)) for x in res_j],
            [str(x.dtype) for x in res_j],
            [x.detach().float().numpy() for x in res_t],
            [str(x.dtype).replace("torch.", "") for x in res_t])


CASES = [("copy_rhs", "u")] + [(op, t) for op in ("add", "sub", "mul", "div")
                               for t in ("u", "e")]


@pytest.mark.parametrize("op,lhs_target", CASES)
def test_bf16_gsddmm_vs_jax(op, lhs_target):
    """Every elementwise op with an 'u' and an 'e' lhs at F = 16: the
    result and the gradients in bf16, within the ``ulp`` rule of the JAX
    kernel path's (the result equal to it)."""
    lhs, rhs, seed = operands(op, lhs_target, (16,), 7)
    rj, dj, rt, dtp = run_both(op, lhs, rhs, lhs_target,
                               ("bfloat16", "bfloat16"), seed)
    assert dtp == dj == ["bfloat16"] * len(rj)
    np.testing.assert_array_equal(rt[0], rj[0])
    for i, (a, b) in enumerate(zip(rt, rj)):
        assert_ulp(a, b, f"{op} {lhs_target} #{i}")


@pytest.mark.parametrize("H,D,lhs_target", [(1, 16, "u"), (4, 16, "u"),
                                            (4, 16, "e"), (2, 7, "u")])
def test_bf16_dot_vs_jax(H, D, lhs_target):
    """dot over (N, H, D) operands (one scalar per head; (1, 16) and
    (4, 16) take K6's vector path on the card, (2, 7) the general one):
    result (E, H, 1) and gradients in bf16 within the ``ulp`` rule."""
    lhs, rhs, seed = operands("dot", lhs_target, (H, D), 8)
    rj, dj, rt, dtp = run_both("dot", lhs, rhs, lhs_target,
                               ("bfloat16", "bfloat16"), seed)
    assert dtp == dj == ["bfloat16"] * 3
    assert rt[0].shape == (E, H, 1)
    for i, (a, b) in enumerate(zip(rt, rj)):
        assert_ulp(a, b, f"dot H={H} D={D} #{i}")


@pytest.mark.parametrize("op,dtypes", [
    ("mul", ("bfloat16", "float32")), ("mul", ("float32", "bfloat16")),
    ("dot", ("bfloat16", "float32")), ("dot", ("float32", "bfloat16"))])
def test_mixed_operands_follow_jax_dtype(op, dtypes):
    """A bf16 operand beside a float32 one: the result's dtype is JAX's
    (lhs's for mul, rhs's for dot), each gradient its operand's, and the
    values within the ``ulp`` rule (where the result is float32, within
    ``SUM_TOL`` of max|ref|)."""
    shape = (2, 8)
    lhs, rhs, seed = operands(op, "u", shape, 9)
    rj, dj, rt, dtp = run_both(op, lhs, rhs, "u", dtypes, seed)
    assert dtp == dj
    assert dj[0] == (dtypes[0] if op == "mul" else dtypes[1])
    assert dj[1:] == list(dtypes)
    for i, (a, b) in enumerate(zip(rt, rj)):
        assert_ulp(a, b, f"{op} {dtypes} #{i}")


def test_plain_version_sums_in_f32():
    """A dot of 300 bf16 ones: a bf16 running sum sticks at 256 (256 + 1
    rounds back to 256); K6's plain version sums in float32 and rounds
    300 once (bf16 holds it), as the kernel does."""
    ones = torch.ones((1, 300), dtype=torch.bfloat16)
    idx = torch.zeros(1, dtype=torch.int32)
    out = k6.sddmm_plain("dot", idx, ones, ones, idx, dot_d=300)
    assert out.dtype == torch.bfloat16 and out.float().item() == 300.0
    assert k6.result_dtype("dot", ones, ones.float()) == torch.float32
    assert k6.result_dtype("mul", ones, ones.float()) == torch.bfloat16
    assert k6.result_dtype("copy_rhs", None, ones) == torch.bfloat16
