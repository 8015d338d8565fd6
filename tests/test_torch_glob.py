"""The global poolings of the port's ``nn/glob.py`` (SumPooling,
WeightAndSum, AvgPooling, MaxPooling, SortPooling, GlobalAttentionPooling,
Set2Set; the set transformer is in ``test_torch_set_transformer.py``) and
the modules of ``nn/utils.py`` (Sequential, WeightBasis, Identity) against
the JAX package, from the same parameters (``interop``: LSTM gates,
LayerNorm scales) and inputs, on a batch of graphs of 2 to 9 nodes.

Tolerances: outputs within 1e-5 of max|ref|; the gradients of the node
features and of every parameter within 1e-4 of their max|ref| (float32;
sums, softmax and LayerNorm statistics in another order).  The gradients
of GlobalAttentionPooling's gate bias and of the attention's key biases
are 0 up to rounding (a softmax is shift-invariant), so they are held
within 1e-4 of the gradient of their kernel, the scale of the terms that
cancel.
"""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu import nn as jnn
from dgl_hack_tpu.core import batch as jbatch

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import nn as tnn
from dgl_hack_tpu_torch.interop import flax_to_state_dict

torch.set_num_threads(2)

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
SIZES = (5, 2, 9, 4)


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(out[~fin], ref[~fin], err_msg=what)
    scale = max(float(np.abs(ref[fin]).max()), 1e-30) if fin.any() else 1.0
    err = float(np.abs(out[fin] - ref[fin]).max()) if fin.any() else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    jg, tg = [], []
    for n in SIZES:
        src, dst = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        jg.append(dgl.graph((src, dst), num_nodes=n))
        tg.append(dt.graph((src, dst), num_nodes=n))
    return jbatch.batch(jg), dt.batch(tg), jg[2], tg[2]


def compare(jmod, tmod, jg, tg, arrays, extra=(), seed=0, what="",
            scale_of=None):
    """Forward, and gradients of the inputs and of the parameters, of the
    JAX and the port's module on the same inputs: ``arrays`` are the float
    inputs after the graph, ``extra`` inputs without gradient; rows that
    are -inf in the output (top-k padding) carry no cotangent.
    ``scale_of`` maps a parameter whose exact gradient is 0 to the
    parameter whose gradient sets its scale; every attention key bias
    maps to its kernel."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    jx = [jnp.asarray(a) for a in arrays]
    jextra = [jnp.asarray(a) for a in extra]
    params = jmod.init(jax.random.PRNGKey(seed), jg, *jx, *jextra)
    tmod.load_state_dict(flax_to_state_dict(_np_tree(params)))

    @jax.jit
    def fwd_bwd(p, xs, cot):
        out, vjp = jax.vjp(lambda pp, xx: jmod.apply(pp, jg, *xx, *jextra),
                           p, xs)
        return out, vjp(cot)
    shape = jax.eval_shape(lambda: jmod.apply(params, jg, *jx, *jextra))
    cot = np.random.default_rng(seed + 1).normal(
        size=shape.shape).astype(np.float32)
    jout, (pgrad, xgrad) = fwd_bwd(params, jx, jnp.asarray(cot))
    pgrad = flax_to_state_dict(_np_tree(pgrad))
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tout = tmod(tg, *tx, *(torch.from_numpy(np.asarray(a)) for a in extra))
    fin = torch.isfinite(tout)
    (torch.where(fin, tout, 0.0) * torch.from_numpy(cot)).sum().backward()
    assert_close(tout.detach().numpy(), np.asarray(jout), FWD_TOL,
                 what + " forward")
    for i, (a, b) in enumerate(zip(tx, xgrad)):
        assert_close(a.grad.numpy(), np.asarray(b), GRAD_TOL,
                     f"{what} d input {i}")
    assert set(n for n, _ in tmod.named_parameters()) == set(pgrad)
    scale_of = dict(scale_of or {})
    for name in pgrad:
        if name.endswith("key.bias"):
            scale_of[name] = name[:-len("bias")] + "weight"
    for name, p in tmod.named_parameters():
        ref = pgrad[name].numpy()
        if name in scale_of:
            scale = float(pgrad[scale_of[name]].abs().max())
            err = float(np.abs(p.grad.numpy() - ref).max())
            assert err <= GRAD_TOL * scale, f"{what} d {name}: {err}"
            continue
        assert_close(p.grad.numpy(), ref, GRAD_TOL, f"{what} d {name}")


def _feat(n, f=6, seed=3):
    return np.random.default_rng(seed).normal(size=(n, f))


SIMPLE = {
    "sum": (jnn.SumPooling, tnn.SumPooling),
    "avg": (jnn.AvgPooling, tnn.AvgPooling),
    "max": (jnn.MaxPooling, tnn.MaxPooling),
    "weight_and_sum": (jnn.WeightAndSum, tnn.WeightAndSum),
}


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("kind", list(SIMPLE))
def test_simple_pooling(graphs, kind, batched):
    jb, tb, j1, t1 = graphs
    jg, tg = (jb, tb) if batched else (j1, t1)
    jcls, tcls = SIMPLE[kind]
    compare(jcls(), tcls(), jg, tg, [_feat(tg.num_nodes())], what=kind)


@pytest.mark.parametrize("k", [3, 7])
def test_sort_pooling(graphs, k):
    """k = 7 exceeds three of the four graphs: their missing rows are
    -inf in both packages."""
    jb, tb, *_ = graphs
    compare(jnn.SortPooling(k), tnn.SortPooling(k), jb, tb,
            [_feat(tb.num_nodes())], what="SortPooling")


@pytest.mark.parametrize("with_feat_nn", [False, True])
def test_global_attention_pooling(graphs, with_feat_nn):
    jb, tb, *_ = graphs
    jm = jnn.GlobalAttentionPooling(fnn.Dense(1),
                                    fnn.Dense(5) if with_feat_nn else None)
    tm = tnn.GlobalAttentionPooling(tnn.Dense(1),
                                    tnn.Dense(5) if with_feat_nn else None)
    compare(jm, tm, jb, tb, [_feat(tb.num_nodes())], what="GAP",
            scale_of={"gate_nn.bias": "gate_nn.weight"})


@pytest.mark.parametrize("n_iters", [1, 3])
def test_set2set(graphs, n_iters):
    jb, tb, *_ = graphs
    compare(jnn.Set2Set(6, n_iters), tnn.Set2Set(6, n_iters), jb, tb,
            [_feat(tb.num_nodes())], what="Set2Set")


def test_sequential(graphs):
    """Sequential of GraphConvs on one graph and on a list of graphs; its
    modules are ``layers_0`` ... as flax names them."""
    _, _, j1, t1 = graphs
    jm = jnn.Sequential((jnn.GraphConv(5), jnn.GraphConv(3)))
    tm = tnn.Sequential([tnn.GraphConv(5), tnn.GraphConv(3)])
    compare(jm, tm, j1, t1, [_feat(t1.num_nodes())], what="Sequential")
    x = torch.from_numpy(_feat(t1.num_nodes()).astype(np.float32))
    assert torch.equal(tm([t1, t1], x), tm(t1, x))
    with pytest.raises(ValueError, match="number of graphs"):
        tm([t1], x)


def test_weight_basis_and_identity():
    jm = jnn.WeightBasis((3, 4), 2, 5)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tnn.WeightBasis((3, 4), 2, 5)
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    out = tm()
    assert_close(out.detach().numpy(), np.asarray(jm.apply(params)),
                 FWD_TOL)
    fresh = tnn.WeightBasis((3, 4), 2, 5)
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == \
        {"weight": (2, 3, 4), "w_comp": (5, 2)}
    with pytest.raises(ValueError, match="#outputs"):
        tnn.WeightBasis((3,), 4, 4)
    x = torch.randn(3, 2)
    assert tnn.Identity()(x) is x
