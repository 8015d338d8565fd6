"""The port's ``nn/conv_extra.py`` layers against the JAX package's
(``dgl_hack_tpu.nn.conv_extra``): every layer from the same numpy inputs
and the same parameters (``interop.flax_to_state_dict``), outputs to rtol
1e-5, atol 1e-6 and every parameter's gradient to atol 1e-6 plus rtol 1e-5
of the layer's largest (``test_torch_chem.check_against_jax``), on a batch
of synthetic molecules whose internal and user edge orders differ, so that
a slip between the two orders of the edge features shows.  The kNN graph
factories give the JAX factories' edges, ties included."""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import dgl_hack_tpu as dgl
from dgl_hack_tpu.nn import conv_extra as jce

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.nn import conv_extra as tce

from test_torch_chem import TOL, _molecules, check_against_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mols():
    gj, gt = _molecules(6, seed=11)
    bj, bt = dgl.batch(gj), dt.batch(gt)
    assert bt.int2user is not None
    rng = np.random.default_rng(0)
    x = rng.normal(size=(bt.num_nodes(), 6)).astype(np.float32)
    pseudo = rng.normal(size=(bt.num_edges(), 2)).astype(np.float32)
    return bj, bt, x, pseudo


class JFlat(fnn.Module):
    """A JAX layer built by ``make`` inside a wrapper (so its parameters
    sit under its flax name), its outputs flattened into one vector."""
    make: object

    @fnn.compact
    def __call__(self, *args):
        out = self.make()(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return jnp.concatenate([o.reshape(-1) for o in outs])


class TFlat(nn.Module):
    """The port's counterpart of ``JFlat``: the layer under ``name``."""

    def __init__(self, name, layer):
        super().__init__()
        self.name = name
        self.add_module(name, layer)

    def forward(self, *args):
        out = getattr(self, self.name)(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return torch.cat([o.reshape(-1) for o in outs])


def _check(jmake, name, tlayer, j_args, t_args):
    check_against_jax(JFlat(jmake), TFlat(name, tlayer), j_args, t_args, TOL)


@pytest.mark.parametrize("agg,residual", [("sum", False), ("mean", True),
                                          ("max", False)])
def test_gmmconv_matches_jax(mols, agg, residual):
    """Pseudo-coordinates in user order; sum and mean through K1's
    edge-row mode's plain version, max through the scatter."""
    bj, bt, x, pseudo = mols
    jm = lambda: jce.GMMConv(5, dim=2, n_kernels=3, aggregator_type=agg,
                             residual=residual)
    _check(jm, "GMMConv_0",
           tce.GMMConv(5, dim=2, n_kernels=3, aggregator_type=agg,
                       residual=residual),
           [bj, jnp.asarray(x), jnp.asarray(pseudo)],
           [bt, torch.from_numpy(x), torch.from_numpy(pseudo)])


@pytest.mark.parametrize("batched", [False, True])
def test_dense_sage_matches_jax(batched):
    rng = np.random.default_rng(1)
    shape = (3, 9, 9) if batched else (9, 9)
    adj = (rng.random(shape) < 0.3).astype(np.float32)
    x = rng.normal(size=shape[:-1] + (4,)).astype(np.float32)
    _check(lambda: jce.DenseSAGEConv(6), "DenseSAGEConv_0",
           tce.DenseSAGEConv(6), [jnp.asarray(adj), jnp.asarray(x)],
           [torch.from_numpy(adj), torch.from_numpy(x)])


@pytest.mark.parametrize("k", [1, 3])
def test_dense_cheb_matches_jax(k):
    rng = np.random.default_rng(2)
    adj = (rng.random((10, 10)) < 0.3).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    _check(lambda: jce.DenseChebConv(5, k), "DenseChebConv_0",
           tce.DenseChebConv(5, k), [jnp.asarray(adj), jnp.asarray(x), 1.7],
           [torch.from_numpy(adj), torch.from_numpy(x), 1.7])


def test_knn_factories_match_jax():
    """Both factories' edges equal the JAX ones', on points with repeats
    (distance ties, which np.argsort breaks as it does in the JAX
    package)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    x[5] = x[2]
    x[11] = x[10]
    gj = jce.KNNGraph(4).apply({}, x)
    gt = tce.KNNGraph(4)(torch.from_numpy(x))
    for a, b in zip(gj.edges(), gt.edges()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    segs = [8, 5, 7]
    gj = jce.SegmentedKNNGraph(3).apply({}, x, segs)
    gt = tce.SegmentedKNNGraph(3)(x, segs)
    assert gt.num_nodes() == gj.num_nodes() == 20
    for a, b in zip(gj.edges(), gt.edges()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("features", [None, (6.0, 8.0, 9.0, 17.0)])
def test_atomic_conv_matches_jax(mols, features):
    """The radial pooling per atom type over the molecules' distances,
    gradients of the learned cutoffs, means and scalings included."""
    bj, bt, _, _ = mols
    opts = dict(interaction_cutoffs=(4.0, 2.5), rbf_kernel_means=(0.0, 1.5),
                rbf_kernel_scaling=(2.0,), features_to_use=features)
    _check(lambda: jce.AtomicConv(**opts), "AtomicConv_0",
           tce.AtomicConv(**opts),
           [bj, bj.ndata["atomic_number"], bj.edata_internal["distance"]],
           [bt, bt.ndata["atomic_number"], bt.edata_internal["distance"]])


@pytest.mark.parametrize("node_only", [False, True])
def test_weave_layer_matches_jax(mols, node_only):
    """Node and edge updates (edge outputs in user order); node_only
    builds the node Denses alone, as flax does."""
    bj, bt, x, _ = mols
    ej, et = bj.edata["e"], bt.edata["e"]
    widths = (5, 6, 7, 4, 3, 5)
    _check(lambda: jce.WeaveLayer(*widths), "WeaveLayer_0",
           tce.WeaveLayer(*widths), [bj, jnp.asarray(x), ej, node_only],
           [bt, torch.from_numpy(x), et, node_only])


@pytest.mark.parametrize("node_only", [False, True])
def test_weave_gnn_matches_jax(mols, node_only):
    bj, bt, x, _ = mols
    _check(lambda: jce.WeaveGNN(num_layers=3, hidden_feats=6), "WeaveGNN_0",
           tce.WeaveGNN(num_layers=3, hidden_feats=6),
           [bj, jnp.asarray(x), bj.edata["e"], node_only],
           [bt, torch.from_numpy(x), bt.edata["e"], node_only])


def test_wln_matches_jax(mols):
    """Shared parameters across 3 layers; edge features in user order."""
    bj, bt, x, _ = mols
    _check(lambda: jce.WLN(node_out_feats=7, n_layers=3), "WLN_0",
           tce.WLN(node_out_feats=7, n_layers=3),
           [bj, jnp.asarray(x), bj.edata["e"]],
           [bt, torch.from_numpy(x), bt.edata["e"]])


def test_wln_init_scale():
    """WLN's kernels are normal with std min(1/sqrt(in), 0.1), its biases
    zero."""
    torch.manual_seed(0)
    lin = tce.WLN(node_out_feats=400, n_layers=1).project_self
    lin(torch.zeros(3, 400))
    assert abs(float(lin.weight.detach().std()) - 0.05) < 0.002
    big = tce.WLN(node_out_feats=300, n_layers=1).project_edge_messages
    big(torch.zeros(2, 20))
    assert abs(float(big.weight.detach().std()) - 0.1) < 0.005
