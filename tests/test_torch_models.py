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
    ref = layer.apply(params, gj, jnp.asarray(x))
    out = _port_apply(GraphConv(out_feats, norm=norm), params, gt, x)
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("heads,out_feats,residual",
                         [(4, 8, False), (1, 7, False), (2, 5, True)])
def test_gatconv_from_jax_params(heads, out_feats, residual):
    rng = np.random.default_rng(heads + out_feats)
    gj, gt = _graph(rng)
    x = rng.normal(size=(120, 12)).astype(np.float32)
    layer = JGATConv(out_feats, heads, residual=residual)
    params = layer.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))
    ref = layer.apply(params, gj, jnp.asarray(x))
    out = _port_apply(GATConv(out_feats, heads, residual=residual), params,
                      gt, x)
    assert out.shape == (120, heads, out_feats)
    assert_close(out, ref, TOL)


def test_models_from_jax_params():
    rng = np.random.default_rng(5)
    gj, gt = _graph(rng)
    x = rng.normal(size=(120, 10)).astype(np.float32)
    for jm, pm in ((JGCN(16, 3, dropout=0.5), GCN(16, 3, dropout=0.5)),
                   (JGAT(8, 3, heads=(4, 2)), GAT(8, 3, heads=(4, 2)))):
        params = jm.init(jax.random.PRNGKey(2), gj, jnp.asarray(x))
        ref = jm.apply(params, gj, jnp.asarray(x))
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
