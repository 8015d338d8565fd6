"""``NodeFlow`` of the PyTorch port against the JAX package's, over the
same sampled blocks (both packages' native samplers, one seed): the layer
and block queries equal, ``prop_flow`` with sum, mean and max builtins
and with UDFs (message, reduce and apply-node) on unpadded and padded
(masked) blocks, ``apply_layer``, ``apply_block`` and ``copy_to_parent``,
as tests/test_sampling.py's ``test_nodeflow_compat`` drives the JAX one.

Tolerance (max abs error / max |reference|): 1e-5 for sums and means
(float32 sums in another order); max exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu import fn as jfn
from dgl_hack_tpu.sampling import MultiLayerNeighborSampler as JSampler
from dgl_hack_tpu.sampling.nodeflow import NodeFlow as JNodeFlow

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import fn as tfn
from dgl_hack_tpu_torch.sampling import MultiLayerNeighborSampler
from dgl_hack_tpu_torch.sampling import NodeFlow

torch.set_num_threads(2)

TOL = 1e-5
N = 60


def assert_close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-30), err


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, 500), rng.integers(0, N - 5, 500)
    return dgl.graph((src, dst), num_nodes=N), dt.graph((src, dst),
                                                        num_nodes=N)


def _flows(graphs, pad, seeds=np.arange(8)):
    gj, gt = graphs
    nj = JNodeFlow.from_sampler(gj, seeds, JSampler([3, 4], replace=True,
                                                    pad=pad, seed=1))
    nt = NodeFlow.from_sampler(gt, seeds, MultiLayerNeighborSampler(
        [3, 4], replace=True, pad=pad, seed=1), device="cpu")
    feats = np.random.default_rng(2).normal(size=(N, 5)).astype(np.float32)
    nj.copy_from_parent({"h": feats})
    nt.copy_from_parent({"h": feats})
    return nj, nt


def _udfs(lib):
    """A message, a reduce and an apply-node UDF in ``lib`` (jnp or
    torch)."""
    def message(edges):
        return {"m": edges.src["h"] * 2.0 + 1.0}

    def reduce(nodes):
        return {"h": nodes.mailbox["m"].sum(1)}

    def apply(nodes):
        return {"h": lib.tanh(nodes.data["h"])}
    return message, reduce, apply


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("how", ["sum", "mean", "max", "udf"])
def test_prop_flow_matches_jax(graphs, pad, how):
    nj, nt = _flows(graphs, pad)
    assert (nt.num_layers, nt.num_blocks) == (nj.num_layers, nj.num_blocks)
    for layer in range(nt.num_layers):
        np.testing.assert_array_equal(nt.layer_parent_nid(layer),
                                      np.asarray(nj.layer_parent_nid(layer)))
        assert_close(nt.layers(layer)["h"].numpy(), nj.layers(layer)["h"],
                     0.0)
    if how == "udf":
        nj.prop_flow(*_udfs(jnp))
        nt.prop_flow(*_udfs(torch))
    else:
        nj.prop_flow(jfn.copy_u("h", "m"), getattr(jfn, how)("m", "h"))
        nt.prop_flow(tfn.copy_u("h", "m"), getattr(tfn, how)("m", "h"))
    out, ref = nt.layers(2)["h"], nj.layers(2)["h"]
    assert out.shape == (8, 5) and bool(torch.isfinite(out).all())
    assert_close(out.numpy(), ref, 0.0 if how == "max" else TOL)
    assert_close(nt.layers(1)["h"].numpy(), nj.layers(1)["h"],
                 0.0 if how == "max" else TOL)


def test_nodeflow_api_matches_jax(graphs):
    """The id maps, block queries, apply_layer, apply_block and
    copy_to_parent (an existing field and a new one) of the JAX
    package's compat test, on padded blocks."""
    nj, nt = _flows(graphs, True)
    nj.prop_flow(jfn.copy_u("h", "m"), jfn.sum("m", "h"))
    nt.prop_flow(tfn.copy_u("h", "m"), tfn.sum("m", "h"))
    for layer in range(nt.num_layers):
        lid = nt.layer_nid(layer)
        np.testing.assert_array_equal(lid, nj.layer_nid(layer))
        assert nt.layer_size(layer) == nj.layer_size(layer)
        np.testing.assert_array_equal(nt.map_to_parent_nid(lid),
                                      nt.layer_parent_nid(layer))
    pn = nt.layer_parent_nid(1)
    np.testing.assert_array_equal(nt.map_from_parent_nid(1, pn[:3]),
                                  nj.map_from_parent_nid(1, pn[:3]))
    np.testing.assert_array_equal(nt.map_from_parent_nid(1, [N + 7]), [-1])
    for b in range(nt.num_blocks):
        assert nt.block_size(b) == nj.block_size(b) <= \
            nt.blocks[b].num_edges()
        for x, y in zip(nt.block_edges(b), nj.block_edges(b)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(nt.block_parent_eid(b),
                                      nj.block_parent_eid(b))
    nj.apply_layer(2, lambda b: {"h": b.data["h"] * 2.0, "g": b.data["h"]})
    nt.apply_layer(2, lambda b: {"h": b.data["h"] * 2.0, "g": b.data["h"]})
    assert_close(nt.layers(2)["h"].numpy(), nj.layers(2)["h"], TOL)
    with pytest.raises(TypeError, match="dict"):
        nt.apply_layer(2, lambda b: b.data["h"])
    nj.apply_block(1, jfn.u_add_v("h", "h", "e"))
    nt.apply_block(1, tfn.u_add_v("h", "h", "e"))
    assert_close(nt.blocks[1].edata_internal["e"].numpy(),
                 nj.blocks[1]._edge_frame["e"], TOL)
    parent = {"h": np.ones((N, 5), np.float32)}
    up_j, up_t = nj.copy_to_parent(parent), nt.copy_to_parent(parent)
    assert set(up_t) == set(up_j) == {"h", "g"}
    for k in up_t:
        assert_close(up_t[k].numpy(), up_j[k], TOL)
    np.testing.assert_array_equal(parent["h"], 1.0)    # not written in place
    got = up_t["h"].numpy()[nt.layer_parent_nid(2)]
    np.testing.assert_allclose(got, nt.layers(2)["h"].numpy())
    with pytest.raises(ValueError, match="parent frame"):
        nt.copy_to_parent({})


def test_nodeflow_takes_tensors_and_checks_layers(graphs):
    """copy_from_parent gathers from a tensor as from an array; the layer
    count must be one more than the block count."""
    nj, nt = _flows(graphs, False)
    feats = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N, 5)).astype(np.float32))
    nt.copy_from_parent({"h": feats}, fields=("h",))
    assert_close(nt.layers(0)["h"].numpy(), nj.layers(0)["h"], 0.0)
    assert nt.device == torch.device("cpu")
    with pytest.raises(ValueError, match="layers"):
        NodeFlow(nt.blocks, [np.arange(3)])
    assert jax.default_backend() == "cpu"
