"""bf16 and the packed z in the fused GAT edge phase: the port against the
JAX package's fused path.

The JAX side runs on a **prepared** graph (its Pallas kernels in interpret
mode, one-hot selects at full precision: ``DGL_TPU_SPMM_MODE=highest``):
``gat_attention_pallas`` upcasts bf16 operands into a float32 z, computes
in float32 and rounds the result once to fsrc's dtype; its custom VJP
rounds each gradient once to its operand's dtype.  The port runs both of
its CPU routes: ``dt.gat_attention`` (the composed path) and
``gat_attention_fused`` (``GatFused`` over the plain versions of K2/K3).
Inputs are made from a seed with numpy.

Tolerances, stated per case:

* ``ulp`` (bf16 operands): within one bf16 ulp of each element, at the
  larger of the two, plus ``PALLAS_TOL`` * max|ref|.  Both sides compute
  the same float32 function of the same bf16 values and round once, so
  they differ by the float32 routes' own difference (``PALLAS_TOL``, as
  ``tests/test_torch_gat.py`` holds them in float32), which may move a
  value across a rounding boundary: one ulp more;
* ``packed`` (``DGL_TPU_GAT_PACKED=1``, float32 operands): the JAX
  package's own tolerances for its packed path
  (``tests/test_pallas_gat.py``: forward rtol = atol = 2e-3 against the
  oracle at bf16-rounded features, gradients 5e-3 of max(1, max|ref|)),
  and ``PALLAS_TOL`` between the port and that oracle, which is the
  port's own function.  The port rounds the same float32 features to
  bf16 as the JAX package does (round to nearest even).

The JAX **bare** graph runs the composed path in bf16; the port departs
from it on purpose (``test_probe_departs_from_bare``).  gsddmm's bf16 path
is held in ``tests/test_torch_bf16_sddmm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.nn import GATConv as JGATConv
from dgl_hack_tpu.ops.gat import gat_attention as jax_gat

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.nn import GATConv
from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk

torch.set_num_threads(2)

PALLAS_TOL = 1e-4
PACKED_FWD_TOL, PACKED_GRAD_TOL = 2e-3, 5e-3
N, E = 200, 1500
ROUTES = ("gat_attention", "fused")


@pytest.fixture(params=["shift", "exact"])
def softmax_mode(request, monkeypatch):
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", request.param)
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    return request.param


def bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def ulp_excess(out, ref):
    """max |out - ref| / (one bf16 ulp + PALLAS_TOL * max|ref|): <= 1 is
    the ``ulp`` rule."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    allow = bf16_ulp(np.maximum(np.abs(out), np.abs(ref))) \
        + PALLAS_TOL * float(np.abs(ref).max())
    return float((np.abs(out - ref) / allow).max())


def assert_ulp(out, ref, what=""):
    err = ulp_excess(out, ref)
    assert err <= 1.0, f"{what}: {err:.3g} of the bound"


def assert_close(out, ref, tol, what="", floor=1e-30):
    """max abs error <= tol * max(floor, max|ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


_GRAPHS = {}


def graphs(seed=0, flat=False):
    """(JAX bare, JAX prepared, port) graphs of N nodes and E random
    edges, cached per setting."""
    key = (seed, flat)
    if key not in _GRAPHS:
        rng = np.random.default_rng(seed)
        src = rng.integers(0, N, E)
        dst = rng.integers(0, N, E)
        gj = dgl.graph((src, dst), num_nodes=N)
        _GRAPHS[key] = (gj, dgl.prepare_spmm(gj, te=256, bc=8, wc=2,
                                             flat=flat),
                        dt.graph((src, dst), num_nodes=N))
    return _GRAPHS[key]


def inputs(seed, H, D, with_w, bf16):
    """fsrc, el, er, attn_w (or None) and the cotangent, standard normal
    (attn_w a 0/1 dropout mask over 0.7), as numpy float32 arrays of
    bf16 values where ``bf16``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((N, H, D), (N, H), (N, H))]
    arrs.append((rng.random((E, H)) > 0.3).astype(np.float32) / 0.7
                if with_w else None)
    arrs.append(rng.normal(size=(N, H, D)).astype(np.float32))
    if bf16:
        arrs = [None if a is None else np.asarray(
            jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in arrs]
    return arrs


def jax_run(g, arrs, dtype, loss="dot"):
    """The JAX fused op's output and gradients (float32 numpy) and their
    dtypes.  ``loss``: 'dot' = sum(out * cotangent), 'square' =
    sum(out ** 2) (the JAX package's packed tests)."""
    fsrc, el, er, w, t = arrs
    args = [jnp.asarray(a).astype(dtype) for a in (fsrc, el, er)]
    if w is not None:
        args.append(jnp.asarray(w).astype(dtype))
    tj = jnp.asarray(t).astype(dtype).astype(jnp.float32)

    def f(*a):
        out = jax_gat(g, a[0], a[1], a[2], 0.2, a[3] if len(a) > 3 else None)
        o32 = out.astype(jnp.float32)
        return ((o32 * tj).sum() if loss == "dot" else (o32 * o32).sum()), out
    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(len(args))),
                                         has_aux=True)(*args)
    res = [out, *grads]
    return ([np.asarray(x.astype(jnp.float32)) for x in res],
            [str(x.dtype) for x in res])


def port_run(route, gt, arrs, dtype, mode, loss="dot", packed=False):
    """The same through one of the port's CPU routes."""
    fsrc, el, er, w, t = arrs
    ins = [torch.tensor(a).to(dtype).requires_grad_(True)
           for a in (fsrc, el, er) + (() if w is None else (w,))]
    if route == "gat_attention":
        out = dt.gat_attention(gt, *ins[:3], 0.2,
                               ins[3] if w is not None else None)
    else:
        out = gk.gat_attention_fused(gt, *ins[:3], 0.2,
                                     ins[3] if w is not None else None,
                                     softmax=mode, packed=packed)
    o32 = out.float()
    scalar = (o32 * torch.tensor(t).to(dtype).float()).sum() \
        if loss == "dot" else (o32 * o32).sum()
    grads = torch.autograd.grad(scalar, ins)
    res = [out, *grads]
    return ([x.detach().float().numpy() for x in res],
            [str(x.dtype).replace("torch.", "") for x in res])


NAMES = ("out", "dfsrc", "del", "der", "dattn_w")
_JAX = {}


def jax_cached(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


# ---------------------------------------------------------------------------
# bf16 operands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_w", [True, False])
@pytest.mark.parametrize("route", ROUTES)
def test_bf16_vs_jax_prepared(softmax_mode, route, with_w):
    """bf16 fsrc, el, er (and attn_w) at H = 4, D = 8: the output and every
    gradient in bf16, each within the ``ulp`` rule of the JAX prepared
    graph's, through both CPU routes and both softmax modes."""
    _, gp, gt = graphs()
    arrs = inputs(1, 4, 8, with_w, bf16=True)
    ref, ref_dt = jax_cached(("bf16", softmax_mode, with_w), lambda: jax_run(
        gp, arrs, jnp.bfloat16))
    out, out_dt = port_run(route, gt, arrs, torch.bfloat16, softmax_mode)
    assert out_dt == ref_dt == ["bfloat16"] * len(ref)
    for name, a, b in zip(NAMES, out, ref):
        assert_ulp(a, b, f"{route} {name}")


def test_repair_probe(monkeypatch):
    """The probe of the bf16 GAT repair (N = 200, E = 1,500, H = 4, D = 8,
    standard normal inputs, DGL_TPU_SPMM_MODE=highest): the composed CPU
    path ran in bf16 with F.leaky_relu and missed the JAX prepared graph
    by 0.0156 in the output, 0.0195 in dfsrc, 0.344 in del and 0.340 in
    der (25 to 147 times the ``ulp`` rule).  Computing in float32,
    rounding once and taking jax.nn.leaky_relu's slope of 1 at a logit of
    exactly 0 (bf16 logits hit 0; F.leaky_relu's slope there is 0.2)
    brings every value within the rule."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", "shift")
    _, gp, gt = graphs()
    arrs = inputs(0, 4, 8, False, bf16=True)
    ref, _ = jax_run(gp, arrs, jnp.bfloat16)
    out, _ = port_run("gat_attention", gt, arrs, torch.bfloat16, "shift")
    for name, a, b in zip(NAMES, out, ref):
        assert_ulp(a, b, name)


def test_probe_departs_from_bare(monkeypatch):
    """On the same probe the JAX **bare** graph (its composed path, which
    computes in bf16 throughout) departs from the prepared graph and the
    port: the output by 0.0234375, and every gradient by more than 8 times
    the ``ulp`` rule somewhere."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", "shift")
    gj, gp, gt = graphs()
    arrs = inputs(0, 4, 8, False, bf16=True)
    bare, _ = jax_run(gj, arrs, jnp.bfloat16)
    out, _ = port_run("gat_attention", gt, arrs, torch.bfloat16, "shift")
    assert float(np.abs(out[0] - bare[0]).max()) == 0.0234375
    for name, a, b in zip(NAMES[1:], out[1:], bare[1:]):
        assert ulp_excess(a, b) > 8.0, name


def test_bf16_mixed_operands(monkeypatch):
    """A float32 fsrc beside bf16 el and er: the result is float32 (fsrc's
    dtype) and el's and er's gradients bf16, in both packages."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    _, gp, gt = graphs()
    arrs = inputs(2, 2, 8, False, bf16=True)
    fsrc, el, er, _, t = arrs
    lj, rj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (el, er))

    def f(fs, a, b):
        out = jax_gat(gp, fs, a, b, 0.2)
        return (out * jnp.asarray(t)).sum(), out
    (_, ref), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        jnp.asarray(fsrc), lj, rj)
    ins = [torch.tensor(fsrc, requires_grad=True)] + [
        torch.tensor(a).bfloat16().requires_grad_(True) for a in (el, er)]
    for route in ROUTES:
        out = dt.gat_attention(gt, *ins, 0.2) if route == "gat_attention" \
            else gk.gat_attention_fused(gt, *ins, 0.2)
        pg = torch.autograd.grad((out * torch.tensor(t)).sum(), ins)
        assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
        assert_close(out.detach().numpy(), ref, PALLAS_TOL, route)
        assert [str(x.dtype) for x in pg] == [
            "torch.float32", "torch.bfloat16", "torch.bfloat16"]
        assert [str(x.dtype) for x in grads] == [
            "float32", "bfloat16", "bfloat16"]
        for name, a, b in zip(NAMES[1:], pg, grads):
            assert_ulp(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                       f"{route} {name}")


# ---------------------------------------------------------------------------
# DGL_TPU_GAT_PACKED=1 (the JAX package's packed tests, mirrored)
# ---------------------------------------------------------------------------
def oracle(g, fsrc, el, er):
    """The JAX package's oracle (``test_pallas_gat.py:_oracle``): the
    composed path on the bare graph."""
    e = dgl.gsddmm(g, "add", el[:, :, None], er[:, :, None], "u", "v")
    a = dgl.edge_softmax(g, jax.nn.leaky_relu(e, 0.2))
    return dgl.gspmm(g, "mul", "sum", fsrc, a, "u", "e")


def quantized(a):
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


@pytest.mark.parametrize("flat", [False, True])
def test_gat_packed_forward(softmax_mode, flat, monkeypatch):
    """``test_gat_packed_forward``: H = 4, D = 16; the port with packing on
    (both routes) against the JAX packed path within its own tolerance
    against the oracle at bf16-rounded features, and against that oracle
    within ``PALLAS_TOL``; the JAX packed path against it too."""
    monkeypatch.setenv("DGL_TPU_GAT_PACKED", "1")
    gj, gp, gt = graphs(flat=flat)
    arrs = inputs(3, 4, 16, False, bf16=False)
    ref, _ = jax_cached(("packed", softmax_mode, flat), lambda: jax_run(
        gp, arrs, jnp.float32, loss="square"))
    ref_q = np.asarray(oracle(gj, quantized(arrs[0]), *map(jnp.asarray,
                                                            arrs[1:3])))
    np.testing.assert_allclose(ref[0], ref_q, rtol=PACKED_FWD_TOL,
                               atol=PACKED_FWD_TOL)
    for route in ROUTES:
        out, _ = port_run(route, gt, arrs, torch.float32, softmax_mode,
                          loss="square", packed=True)
        np.testing.assert_allclose(out[0], ref[0], rtol=PACKED_FWD_TOL,
                                   atol=PACKED_FWD_TOL)
        assert_close(out[0], ref_q, PALLAS_TOL, route)


def test_gat_packed_odd_width(softmax_mode, monkeypatch):
    """``test_gat_packed_odd_width``: H = 1, D = 16 (z rows of 17 floats)
    still packs; and an odd H * D (H = 1, D = 7: the output layer's case)
    runs unpacked in both packages: with packing on each equals its own
    unpacked run bit for bit."""
    gj, gp, gt = graphs()
    arrs = inputs(4, 1, 16, False, bf16=False)
    monkeypatch.setenv("DGL_TPU_GAT_PACKED", "1")
    ref_q = np.asarray(oracle(gj, quantized(arrs[0]), *map(jnp.asarray,
                                                            arrs[1:3])))
    for route in ROUTES:
        out, _ = port_run(route, gt, arrs, torch.float32, softmax_mode,
                          loss="square", packed=True)
        assert_close(out[0], ref_q, PALLAS_TOL, route)
    odd = inputs(5, 1, 7, False, bf16=False)
    runs = {}
    for packed in ("1", "0"):
        monkeypatch.setenv("DGL_TPU_GAT_PACKED", packed)
        runs[packed] = (jax_run(gp, odd, jnp.float32)[0], {
            route: port_run(route, gt, odd, torch.float32, softmax_mode,
                            packed=packed == "1")[0] for route in ROUTES})
    for i, name in enumerate(NAMES[:4]):
        np.testing.assert_array_equal(runs["1"][0][i], runs["0"][0][i])
        for route in ROUTES:
            np.testing.assert_array_equal(runs["1"][1][route][i],
                                          runs["0"][1][route][i])
            assert_close(runs["1"][1][route][i], runs["1"][0][i], PALLAS_TOL,
                         f"{route} {name}")


@pytest.mark.parametrize("route", ROUTES)
def test_gat_packed_grads(softmax_mode, route, monkeypatch):
    """``test_gat_packed_grads`` and ``test_gat_packed_fwd_bwd_combo``
    (the fused backward): the gradients of sum(out ** 2) with packing on,
    the port's against the JAX packed path's and both against the oracle
    differentiated at bf16-rounded features (straight through the
    rounding; the JAX oracle's astype rounds dfsrc to bf16 on the way
    back), within 5e-3 of max(1, max|ref|); the port's against the oracle
    whose rounding passes the gradient through unrounded, as
    ``_gat_fused_bwd`` does, within ``PALLAS_TOL``: K3 differentiates the
    function K2 ran."""
    monkeypatch.setenv("DGL_TPU_GAT_PACKED", "1")
    gj, gp, gt = graphs()
    arrs = inputs(3, 4, 16, False, bf16=False)
    ref, _ = jax_cached(("packed", softmax_mode, False), lambda: jax_run(
        gp, arrs, jnp.float32, loss="square"))

    def loss_oracle(f, a, b, straight=False):
        q = f.astype(jnp.bfloat16).astype(jnp.float32)
        if straight:          # the rounding's gradient is the identity
            q = f + jax.lax.stop_gradient(q - f)
        out = oracle(gj, q, a, b)
        return (out * out).sum()
    ins = tuple(map(jnp.asarray, arrs[:3]))
    ref_q = jax.grad(loss_oracle, (0, 1, 2))(*ins)
    ref_st = jax.grad(lambda *a: loss_oracle(*a, straight=True),
                      (0, 1, 2))(*ins)
    out, _ = port_run(route, gt, arrs, torch.float32, softmax_mode,
                      loss="square", packed=True)
    for name, a, b, q, st in zip(NAMES[1:], out[1:], ref[1:], ref_q, ref_st):
        for x, y in ((a, b), (a, q), (b, q)):
            y = np.asarray(y)
            scale = max(1.0, float(np.abs(y).max()))
            np.testing.assert_allclose(x / scale, y / scale,
                                       rtol=PACKED_GRAD_TOL,
                                       atol=PACKED_GRAD_TOL, err_msg=name)
        assert_close(a, np.asarray(st), PALLAS_TOL, f"{route} {name}",
                     floor=1.0)


def test_gatconv_packed_from_jax_params(monkeypatch):
    """``GATConv(8, 4)`` with ``DGL_TPU_GAT_PACKED=1`` in both packages,
    the port's from the JAX module's parameters (``interop``): the output
    and the gradients of the input and every parameter within the JAX
    package's packed tolerance (its projections' float32 features may
    round to bf16 one ulp apart where the two matmuls differ in the last
    bit)."""
    monkeypatch.setenv("DGL_TPU_GAT_PACKED", "1")
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    gj, gp, gt = graphs()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(N, 12)).astype(np.float32)
    t = rng.normal(size=(N, 4, 8)).astype(np.float32)
    layer = JGATConv(out_feats=8, num_heads=4)
    params = layer.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))

    def f(p, xx):
        out = layer.apply(p, gp, xx)
        return (out * jnp.asarray(t)).sum(), out
    (_, ref), (gparams, gx) = jax.value_and_grad(f, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    mod = GATConv(8, 4)
    xt = torch.tensor(x, requires_grad=True)
    mod(gt, xt)                                   # materialise the lazy fc
    mod.load_state_dict(flax_to_state_dict(params))
    out = mod(gt, xt)
    (out * torch.tensor(t)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=PACKED_FWD_TOL, atol=PACKED_FWD_TOL)
    grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, gparams))
    pairs = [("x", xt.grad, np.asarray(gx))] + [
        (k, dict(mod.named_parameters())[k].grad, v.numpy())
        for k, v in grads.items()]
    for name, a, b in pairs:
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale,
                                   rtol=PACKED_GRAD_TOL,
                                   atol=PACKED_GRAD_TOL, err_msg=name)
