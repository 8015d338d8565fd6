"""The bipartite layers of the PyTorch port against the JAX package, on a
block that the two packages' samplers draw alike (test_torch_sampling.py
holds them equal, and holds GraphSAGE over blocks to the JAX package).

The layers (GraphConv, GATConv, SAGEConv, GINConv, AGNNConv, EdgeConv,
NNConv) run on a padded block, its seeds drawn without replacement from a
graph of distinct edges, so no two real edges repeat a (src, dst) pair
and a max has no ties; they take (src, dst) feature pairs and the JAX
parameters (``interop``), and the JAX side runs its composed path on the
bare block.

Tolerances (max abs error / max |reference|): outputs 1e-5 and gradients
1e-4 (float32 sums in another order; softmax).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_hack_tpu import nn as jnn
from dgl_hack_tpu import sampling as jsampling

from dgl_hack_tpu_torch import nn as tnn
from dgl_hack_tpu_torch import sampling as tsampling
from dgl_hack_tpu_torch.interop import (dense_module_names,
                                        flax_to_state_dict,
                                        state_dict_to_flax)
from test_torch_sampling import (N, _highest_precision,  # noqa: F401
                                 assert_close, graphs, pinned_paths)

torch.set_num_threads(2)

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# bipartite layers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["native", "plain"])
def block_pair(graphs, request):
    """The outer block of one minibatch drawn without replacement: its
    seeds are distinct, seeds of fewer in-edges than the fanout leave
    padding, and seeds 290.. have no in-edges.  Drawn by both packages'
    native samplers, or by the port's plain version and the JAX numpy
    fallback (test_torch_sampling.pinned_paths), the paths pinned."""
    gj, gt = graphs
    seeds = np.concatenate([np.arange(0, 100, 2), [N - 4, N - 2]])
    sj = jsampling.MultiLayerNeighborSampler([6], replace=False, seed=13)
    st = tsampling.MultiLayerNeighborSampler([6], replace=False, seed=13)
    with pinned_paths(request.param) as calls:
        (bj,), _, _ = sj.sample_blocks(gj, seeds)
        (bt,), _, _ = st.sample_blocks(gt, seeds)
    calls.check()
    assert not bool(bt.edge_mask.all())
    return bj, bt


def _compare_layer(jmod, tmod, jb, tb, width=7, extra=(), seed=0):
    """Forward, and the gradients of both feature sides and of every
    parameter, of a layer on (feat_src, feat_dst) in both packages."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(tb.num_src_nodes, width)).astype(np.float32)
    xd = rng.normal(size=(tb.num_dst_nodes, width)).astype(np.float32)
    jextra = [jnp.asarray(a) for a in extra]
    jfeat = (jnp.asarray(xs), jnp.asarray(xd))
    params = jmod.init(jax.random.PRNGKey(seed), jb, jfeat, *jextra)

    def fwd(p, a, b):
        return jmod.apply(p, jb, (a, b), *jextra)

    @jax.jit
    def fwd_bwd(p, a, b, cot):
        out, vjp = jax.vjp(fwd, p, a, b)
        return out, vjp(cot)
    shape = jax.eval_shape(fwd, params, *jfeat).shape
    cot = rng.normal(size=shape).astype(np.float32)
    out_j, (gp, ga, gb) = fwd_bwd(params, *jfeat, jnp.asarray(cot))
    ga, gb = np.asarray(ga), np.asarray(gb)
    tmod.load_state_dict(flax_to_state_dict(_np_tree(params)))
    ta = torch.tensor(xs, requires_grad=True)
    tbd = torch.tensor(xd, requires_grad=True)
    out = tmod(tb, (ta, tbd), *map(torch.from_numpy, extra))
    (out * torch.from_numpy(cot)).sum().backward()
    assert_close(out.detach().numpy(), out_j, FWD_TOL, "forward")
    for t, ref, side in ((ta, ga, "feat_src"), (tbd, gb, "feat_dst")):
        got = np.zeros_like(ref) if t.grad is None else t.grad.numpy()
        assert_close(got, ref, GRAD_TOL, side)
    want = flax_to_state_dict(_np_tree(gp))
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(want)
    for name, grad in got.items():
        assert_close(grad.numpy(), want[name].numpy(), GRAD_TOL, name)
    return tmod


LAYERS = {
    "GraphConv": lambda: (jnn.GraphConv(5), tnn.GraphConv(5)),
    "GATConv": lambda: (jnn.GATConv(3, 2, residual=True),
                        tnn.GATConv(3, 2, residual=True)),
    "SAGEConv_mean": lambda: (jnn.SAGEConv(5, "mean"),
                              tnn.SAGEConv(5, "mean")),
    "SAGEConv_gcn": lambda: (jnn.SAGEConv(5, "gcn"), tnn.SAGEConv(5, "gcn")),
    "SAGEConv_pool": lambda: (jnn.SAGEConv(5, "pool"),
                              tnn.SAGEConv(5, "pool")),
    "GINConv_sum": lambda: (
        jnn.GINConv(fnn.Dense(5), "sum", init_eps=0.1, learn_eps=True),
        tnn.GINConv(torch.nn.LazyLinear(5), "sum", init_eps=0.1,
                    learn_eps=True)),
    "GINConv_max": lambda: (jnn.GINConv(None, "max", init_eps=0.2),
                            tnn.GINConv(None, "max", init_eps=0.2)),
    "AGNNConv": lambda: (jnn.AGNNConv(init_beta=1.5),
                         tnn.AGNNConv(init_beta=1.5)),
    "EdgeConv": lambda: (jnn.EdgeConv(4), tnn.EdgeConv(4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_bipartite_layer_matches_jax(block_pair, name):
    jmod, tmod = LAYERS[name]()
    out = _compare_layer(jmod, tmod, *block_pair)
    if name.startswith("GATConv"):
        assert tmod.fc is None and tmod.fc_src is not None


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_bipartite_nnconv_matches_jax(block_pair, agg):
    jb, tb = block_pair
    efeat = np.random.default_rng(14).normal(
        size=(tb.num_edges(), 3)).astype(np.float32)
    _compare_layer(jnn.NNConv(4, edge_func=fnn.Dense(7 * 4),
                              aggregator_type=agg, residual=True),
                   tnn.NNConv(4, edge_func=tnn.Dense(7 * 4),
                              aggregator_type=agg, residual=True),
                   jb, tb, extra=(efeat,))


def test_bipartite_gatconv_first_call_and_interop(block_pair):
    """Called first on a pair, GATConv takes fc_src and fc_dst; its state
    goes back to the JAX tree it came from, key for key."""
    jb, tb = block_pair
    layer = tnn.GATConv(4, 2, residual=True)
    xs = torch.randn(tb.num_src_nodes, 6)
    xd = torch.randn(tb.num_dst_nodes, 6)
    out = layer(tb, (xs, xd))
    assert out.shape == (tb.num_dst_nodes, 2, 4)
    assert layer.fc is None
    assert layer.fc_src.weight.shape == layer.fc_dst.weight.shape == (8, 6)
    params = _np_tree(jnn.GATConv(4, 2, residual=True).init(
        jax.random.PRNGKey(1), jb, (jnp.asarray(xs.numpy()),
                                    jnp.asarray(xd.numpy()))))
    fresh = tnn.GATConv(4, 2, residual=True)
    fresh.load_state_dict(flax_to_state_dict(params))
    np.testing.assert_array_equal(
        fresh.fc_src.weight.detach().numpy(),
        params["params"]["fc_src"]["kernel"].T)
    back = state_dict_to_flax(fresh.state_dict(), dense_module_names(fresh))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("first", ["pair", "single"])
def test_gatconv_refuses_the_other_layout(graphs, block_pair, first):
    """A GATConv set up for one input layout raises on the other, where
    the JAX layer would project with other weights."""
    gt, tb = graphs[1], block_pair[1]
    pair = (tb, (torch.randn(tb.num_src_nodes, 6),
                 torch.randn(tb.num_dst_nodes, 6)))
    single = (gt, torch.randn(gt.num_nodes(), 6))
    layer = tnn.GATConv(4, 2)
    layer(*(pair if first == "pair" else single))
    with pytest.raises(ValueError, match="GATConv"):
        layer(*(single if first == "pair" else pair))
