"""The propagation, edge and other layers of the port's ``nn/conv.py``
(SGConv, APPNPConv, TAGConv, ChebConv, AGNNConv, EdgeConv,
GatedGraphConv, NNConv, DenseGraphConv), the SGC/APPNP/TAGCN example
models and ``add_self_loop``/``remove_self_loop``, against the JAX
package from the same parameters (``interop``) and inputs.

Tolerances (``test_torch_glob.compare``): outputs within 1e-5 of max|ref|
and the gradients of the inputs and of every parameter within 1e-4 of
their max|ref| (float32; sums in another order).  The JAX side runs on bare graphs, its composed
XLA path; the port's CPU tensors run the kernels' plain versions.  A
graph with duplicate edges gives EdgeConv and NNConv(max) tied maxima,
whose cotangent both packages split evenly.
"""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dgl_hack_tpu as dgl
from dgl_hack_tpu import nn as jnn

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import nn as tnn
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.models import APPNP, SGC, TAGCN
from test_torch_glob import (FWD_TOL, _feat, _np_tree, assert_close,
                             compare)

torch.set_num_threads(2)


def _graphs(seed=0, n=40, e=220):
    """Random graph with a dst hub (node 0), zero-in-degree nodes (the
    last three) and duplicate edges (the last 20 repeat the first 20), in
    user order other than CSC."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 3, e)
    dst[::4] = 0
    src[-20:], dst[-20:] = src[:20], dst[:20]
    return (dgl.graph((src, dst), num_nodes=n),
            dt.graph((src, dst), num_nodes=n), src, dst)


@pytest.mark.parametrize("k", [3])
def test_sgconv(k):
    jg, tg, *_ = _graphs()
    compare(jnn.SGConv(5, k=k), tnn.SGConv(5, k=k), jg, tg, [_feat(40)],
            what="SGConv")


@pytest.mark.parametrize("k,alpha", [(4, 0.3)])
def test_appnpconv(k, alpha):
    jg, tg, *_ = _graphs()
    compare(jnn.APPNPConv(k, alpha), tnn.APPNPConv(k, alpha), jg, tg,
            [_feat(40)], what="APPNPConv")


def test_appnpconv_edge_drop():
    """With edge_drop in training, each step drops edges through an (E, 1)
    weight, drawn from the generator; deterministic runs ignore it."""
    _, tg, *_ = _graphs()
    x = torch.from_numpy(_feat(40).astype(np.float32))
    m = tnn.APPNPConv(3, 0.1, edge_drop=0.5)
    gen = torch.Generator().manual_seed(0)
    det = m(tg, x, deterministic=True)
    drop = m(tg, x, deterministic=False, generator=gen)
    again = m(tg, x, deterministic=False,
              generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drop).all() and not torch.equal(det, drop)
    assert torch.equal(drop, again)
    assert torch.equal(det, tnn.APPNPConv(3, 0.1)(tg, x))


@pytest.mark.parametrize("k", [2])
def test_tagconv(k):
    jg, tg, *_ = _graphs()
    compare(jnn.TAGConv(5, k=k, activation=fnn.relu),
            tnn.TAGConv(5, k=k, activation=F.relu), jg, tg, [_feat(40)],
            what="TAGConv")


@pytest.mark.parametrize("k", [1, 4])
def test_chebconv(k):
    jg, tg, *_ = _graphs()
    compare(jnn.ChebConv(5, k=k), tnn.ChebConv(5, k=k), jg, tg,
            [_feat(40)], what="ChebConv")


@pytest.mark.parametrize("learn_beta", [True, False])
def test_agnnconv(learn_beta):
    jg, tg, *_ = _graphs()
    compare(jnn.AGNNConv(init_beta=1.5, learn_beta=learn_beta),
            tnn.AGNNConv(init_beta=1.5, learn_beta=learn_beta), jg, tg,
            [_feat(40)], what="AGNNConv")


def test_edgeconv_with_ties():
    jg, tg, *_ = _graphs()
    compare(jnn.EdgeConv(5), tnn.EdgeConv(5), jg, tg, [_feat(40)],
            what="EdgeConv")


def test_edgeconv_tie_splits_evenly():
    """Two identical edges 0->1: each gets half of node 1's cotangent in
    both packages (the gradient of x[0] is the sum of the halves)."""
    src, dst = np.array([0, 0, 2]), np.array([1, 1, 1])
    jg = dgl.graph((src, dst), num_nodes=3)
    tg = dt.graph((src, dst), num_nodes=3)
    x = np.array([[3.0], [0.0], [-5.0]], np.float32)
    compare(jnn.EdgeConv(1), tnn.EdgeConv(1), jg, tg, [x], seed=2,
            what="EdgeConv tie")


@pytest.mark.parametrize("n_etypes,in_feats", [(1, 6), (3, 4)])
def test_gatedgraphconv(n_etypes, in_feats):
    jg, tg, *_ = _graphs()
    et = np.random.default_rng(5).integers(0, n_etypes, tg.num_edges())
    compare(jnn.GatedGraphConv(6, 2, n_etypes),
            tnn.GatedGraphConv(6, 2, n_etypes), jg, tg,
            [_feat(40, in_feats)], extra=[et], what="GatedGraphConv")


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("residual", [False, True])
def test_nnconv(agg, residual):
    jg, tg, *_ = _graphs()
    ef = np.random.default_rng(6).normal(size=(tg.num_edges(), 3))
    compare(jnn.NNConv(4, edge_func=fnn.Dense(6 * 4), aggregator_type=agg,
                       residual=residual),
            tnn.NNConv(4, edge_func=tnn.Dense(6 * 4), aggregator_type=agg,
                       residual=residual),
            jg, tg, [_feat(40), ef], what=f"NNConv {agg}")


@pytest.mark.parametrize("norm", ["both", "right", "none"])
@pytest.mark.parametrize("out_feats", [3, 9])
def test_densegraphconv(norm, out_feats):
    _, _, src, dst = _graphs()
    adj = np.zeros((40, 40), np.float32)
    np.add.at(adj, (dst, src), 1.0)
    jm = jnn.DenseGraphConv(out_feats, norm=norm)
    tm = tnn.DenseGraphConv(out_feats, norm=norm)
    x = _feat(40).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(adj), jnp.asarray(x))
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    assert_close(tm(torch.from_numpy(adj), torch.from_numpy(x))
                 .detach().numpy(),
                 np.asarray(jm.apply(params, jnp.asarray(adj),
                                     jnp.asarray(x))), FWD_TOL)


class _JSGC(fnn.Module):
    @fnn.compact
    def __call__(self, g, x):
        return jnn.SGConv(out_feats=4, k=2)(g, x)


class _JAPPNP(fnn.Module):
    @fnn.compact
    def __call__(self, g, x):
        x = jax.nn.relu(fnn.Dense(8)(x))
        x = fnn.Dense(4)(x)
        return jnn.APPNPConv(k=3, alpha=0.1)(g, x)


class _JTAGCN(fnn.Module):
    @fnn.compact
    def __call__(self, g, h):
        h = jnn.TAGConv(8, k=2, activation=fnn.relu)(g, h)
        return jnn.TAGConv(4, k=2)(g, h)


@pytest.mark.parametrize("kind", ["sgc", "appnp", "tagcn"])
def test_example_models(kind):
    """The models of the SGC, APPNP and TAGCN example CLIs (dropout off)
    against the modules the JAX examples define."""
    jg, tg, *_ = _graphs()
    jm, tm = {"sgc": (_JSGC(), SGC(4, k=2)),
              "appnp": (_JAPPNP(), APPNP(8, 4, k=3, alpha=0.1,
                                         dropout=0.0)),
              "tagcn": (_JTAGCN(), TAGCN(8, 4, k=2, dropout=0.0))}[kind]
    compare(jm, tm.eval(), jg, tg, [_feat(40)], what=kind)


def test_self_loop_transforms_match_jax():
    jg, tg, src, dst = _graphs()
    src[:5] = dst[:5]                         # a few loops
    jg = dgl.graph((src, dst), num_nodes=40)
    tg = dt.graph((src, dst), num_nodes=40)
    for name in ("add_self_loop", "remove_self_loop"):
        a, b = getattr(dgl, name)(jg), getattr(dt, name)(tg)
        np.testing.assert_array_equal(np.stack(b.host_edges()),
                                      np.stack(a.host_edges()))
        np.testing.assert_array_equal(b.csc_indptr.numpy(),
                                      np.asarray(a.csc_indptr))
    both = dt.add_self_loop(dt.remove_self_loop(tg))
    s, d = both.host_edges()
    assert (s == d).sum() == 40
