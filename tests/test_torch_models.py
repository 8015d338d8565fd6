"""Layers, models and training of the PyTorch port against the JAX package,
from the same parameters (converted with ``interop``) and the same inputs.

Tolerance: layer and model outputs on the CPU composed path agree with
the JAX bare graph to 1e-5 * max|ref| (exact f32, summation order
differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.models import GAT as JGAT
from dgl_hack_tpu.models import GCN as JGCN
from dgl_hack_tpu.nn import GATConv as JGATConv
from dgl_hack_tpu.nn import GraphConv as JGraphConv

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.interop import (dense_module_names,
                                        flax_to_state_dict,
                                        state_dict_to_flax)
from dgl_hack_tpu_torch.models import GAT, GCN
from dgl_hack_tpu_torch.nn import GATConv, GraphConv

torch.set_num_threads(2)

TOL = 1e-5

# Variables either package reads at call time to pick a path or a
# precision; a test elsewhere in the same worker process must not decide
# what is compared here.
_PATH_ENV = ("DGL_TPU_GAT_SOFTMAX", "DGL_TPU_SPMM_MODE",
             "DGL_TPU_DISABLE_PALLAS", "DGL_TPU_SDDMM_KERNEL",
             "DGL_TPU_GAT_PACKED", "DGL_TPU_GAT_BWD_FUSED",
             "DGL_TPU_GAT_BWD_WIDE", "DGL_TPU_GAT_BWD_PACK",
             "DGL_TPU_NO_REWRITE")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Each case runs on the packages' defaults, with torch at 2 threads
    and the JAX reference finished before the port starts (see
    ``_jax_ref``)."""
    for var in _PATH_ENV:
        monkeypatch.delenv(var, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_ref(module, params, g, x):
    """The JAX layer's output, computed to the end on the host: JAX
    dispatches asynchronously, and the port must not run beside it."""
    return np.asarray(jax.block_until_ready(
        module.apply(params, g, jnp.asarray(x))))


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _graph(rng, n=120, e=700):
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 5, e)
    return dgl.graph((src, dst), num_nodes=n), dt.graph((src, dst),
                                                         num_nodes=n)


def _port_apply(module, params, g, x):
    module.load_state_dict(flax_to_state_dict(_np_tree(params)))
    module.eval()
    with torch.no_grad():
        return module(g, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("in_feats,out_feats,norm",
                         [(20, 6, "both"), (6, 20, "both"), (9, 9, "right"),
                          (9, 4, "none")])
def test_graphconv_from_jax_params(in_feats, out_feats, norm):
    rng = np.random.default_rng(in_feats * out_feats)
    gj, gt = _graph(rng)
    x = rng.normal(size=(120, in_feats)).astype(np.float32)
    layer = JGraphConv(out_feats, norm=norm)
    params = layer.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))
    ref = _jax_ref(layer, params, gj, x)
    out = _port_apply(GraphConv(out_feats, norm=norm), params, gt, x)
    assert_close(out, ref, TOL)


def _gat_f64(params, src, dst, x, heads, out_feats):
    """The GATConv layer in float64 numpy, from the JAX parameters."""
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               params["params"])
    n = x.shape[0]
    f = (x.astype(np.float64) @ p["fc"]["kernel"]).reshape(n, heads,
                                                             out_feats)
    el, er = (f * p["attn_l"]).sum(-1), (f * p["attn_r"]).sum(-1)
    e = el[src] + er[dst]
    e = np.where(e > 0, e, 0.2 * e)
    emax = np.full((n, heads), -np.inf)
    np.maximum.at(emax, dst, e)
    a = np.exp(e - emax[dst])
    den = np.zeros((n, heads))
    np.add.at(den, dst, a)
    a = a / den[dst]
    out = np.zeros((n, heads, out_feats))
    np.add.at(out, dst, a[:, :, None] * f[src])
    if "res_fc" in p:
        out += (x.astype(np.float64) @ p["res_fc"]["kernel"]).reshape(
            out.shape)
    return out


def _gat_diagnosis(out, ref, rerun_port, rerun_jax, exact):
    """What a failing GATConv comparison needs for a diagnosis: each
    side's error against float64, where the worst gap is and the values
    there, and whether each side repeats itself."""
    gap = np.abs(out - ref)
    over = gap > TOL * np.abs(ref).max()
    at = np.unravel_index(int(gap.argmax()), gap.shape)
    return "; ".join([
        f"port vs f64 {np.abs(out - exact).max():.3e}",
        f"jax vs f64 {np.abs(ref - exact).max():.3e}",
        f"worst gap at (node, head, feature) {tuple(map(int, at))}: "
        f"port {out[at]!r}, jax {ref[at]!r}, f64 {exact[at]!r}",
        f"{int(over.sum())} entries over the limit, in nodes "
        f"{sorted(set(np.nonzero(over)[0].tolist()))[:20]}",
        f"port repeats bitwise: {np.array_equal(out, rerun_port)}",
        f"jax repeats bitwise: {np.array_equal(ref, rerun_jax)}",
        f"torch threads {torch.get_num_threads()}"])


@pytest.mark.parametrize("heads,out_feats,residual",
                         [(4, 8, False), (1, 7, False), (2, 5, True)])
def test_gatconv_from_jax_params(heads, out_feats, residual):
    """On a mismatch the failure text carries each side's error against a
    float64 numpy layer and whether each side repeats itself: the [4-8-False]
    case once failed in a full parallel run (8.19e-5 against a 1.80e-5
    limit) and never again in isolation, for a cause not yet known."""
    rng = np.random.default_rng(heads + out_feats)
    gj, gt = _graph(rng)
    x = rng.normal(size=(120, 12)).astype(np.float32)
    layer = JGATConv(out_feats, heads, residual=residual)
    params = layer.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))
    ref = _jax_ref(layer, params, gj, x)
    port = GATConv(out_feats, heads, residual=residual)
    out = _port_apply(port, params, gt, x)
    assert out.shape == (120, heads, out_feats)
    scale = float(np.abs(ref).max())
    assert float(np.abs(out - ref).max()) <= TOL * scale, _gat_diagnosis(
        out, ref, _port_apply(port, params, gt, x),
        _jax_ref(layer, params, gj, x),
        _gat_f64(params, gt.src.numpy(), gt.dst.numpy(), x, heads,
                 out_feats))


def test_models_from_jax_params():
    rng = np.random.default_rng(5)
    gj, gt = _graph(rng)
    x = rng.normal(size=(120, 10)).astype(np.float32)
    for jm, pm in ((JGCN(16, 3, dropout=0.5), GCN(16, 3, dropout=0.5)),
                   (JGAT(8, 3, heads=(4, 2)), GAT(8, 3, heads=(4, 2)))):
        params = jm.init(jax.random.PRNGKey(2), gj, jnp.asarray(x))
        ref = _jax_ref(jm, params, gj, x)
        assert_close(_port_apply(pm, params, gt, x), ref, TOL,
                     type(pm).__name__)


def test_interop_round_trip():
    rng = np.random.default_rng(6)
    gj, _ = _graph(rng)
    x = jnp.asarray(rng.normal(size=(120, 10)).astype(np.float32))
    params = _np_tree(JGAT(8, 3, heads=(4, 1), residual=True).init(
        jax.random.PRNGKey(3), gj, x))
    model = GAT(8, 3, heads=(4, 1), residual=True)
    state = flax_to_state_dict(params)
    model.load_state_dict(state)
    # Dense kernels transpose into nn.Linear weights; the rest keep layout
    np.testing.assert_array_equal(
        model.gat0.fc.weight.detach().numpy(),
        params["params"]["gat0"]["fc"]["kernel"].T)
    assert model.gat0.attn_l.shape == (1, 4, 8)
    back = state_dict_to_flax(model.state_dict(), dense_module_names(model))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
