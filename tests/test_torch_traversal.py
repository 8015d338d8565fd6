"""Traversals and frontier propagation in the PyTorch port, against the
JAX package (mirroring tests/test_traversal.py): every generator's
frontiers equal, in both directions, on graphs whose user edge order is
not their internal one; ``prop_nodes``/``prop_edges`` with builtin and UDF
pairs give the same features to 1e-5 of max|ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu import fn as jfn
from dgl_hack_tpu.core import propagate as jprop
from dgl_hack_tpu.core import traversal as jtrav

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import fn as tfn
from dgl_hack_tpu_torch.core import init as tinit
from dgl_hack_tpu_torch.core import propagate as tprop
from dgl_hack_tpu_torch.core import traversal as ttrav

torch.set_num_threads(2)


def _dag(seed=0, levels=6, width=5):
    """A DAG of ``levels`` levels: each node past the first level has an
    in-edge from the level before and one from any earlier level; edges
    listed in a shuffled (user) order."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for lv in range(1, levels):
        for k in range(width):
            v = lv * width + k
            src += [int(rng.integers((lv - 1) * width, lv * width)),
                    int(rng.integers(0, lv * width))]
            dst += [v, v]
    perm = rng.permutation(len(src))
    return np.asarray(src)[perm], np.asarray(dst)[perm], levels * width


def _cyclic(seed=1, n=14, e=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


GRAPHS = {"chain": (np.arange(4), np.arange(1, 5), 5),
          "tree": (np.array([0, 0, 1, 2]), np.array([1, 2, 3, 3]), 4),
          "dag": _dag(), "cyclic": _cyclic()}


def _pair(name):
    s, d, n = GRAPHS[name]
    return dgl.graph((s, d), num_nodes=n), dt.graph((s, d), num_nodes=n)


def _same_frontiers(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_match_jax(name, reverse):
    gj, gt = _pair(name)
    src = [0, GRAPHS[name][2] - 1]
    for gen in ("bfs_nodes_generator", "bfs_edges_generator",
                "dfs_edges_generator"):
        _same_frontiers(getattr(ttrav, gen)(gt, src, reverse),
                        getattr(jtrav, gen)(gj, src, reverse))
    if name != "cyclic":
        _same_frontiers(ttrav.topological_nodes_generator(gt, reverse),
                        jtrav.topological_nodes_generator(gj, reverse))


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("name", ["tree", "cyclic"])
def test_dfs_labeled_edges_match_jax(name, flags):
    gj, gt = _pair(name)
    for reverse in (False, True):
        ej, lj = jtrav.dfs_labeled_edges_generator(gj, [0, 3], reverse,
                                                   *flags)
        et, lt = ttrav.dfs_labeled_edges_generator(gt, [0, 3], reverse,
                                                   *flags)
        _same_frontiers(et, ej)
        _same_frontiers(lt, lj)


def test_chain_orders():
    """The orders tests/test_traversal.py pins, in the port."""
    _, gt = _pair("chain")
    assert [f.tolist() for f in ttrav.bfs_nodes_generator(gt, 0)] == \
        [[0], [1], [2], [3], [4]]
    assert [f.tolist() for f in ttrav.bfs_edges_generator(gt, 0)] == \
        [[0], [1], [2], [3]]
    assert [int(f[0]) for f in ttrav.dfs_edges_generator(gt, 0)] == \
        [0, 1, 2, 3]


def _acc_udf(pkg):
    """h = sum of the children's h + the node's own h (a Tree-LSTM-like
    accumulation over the mailbox)."""
    def reduce(nodes):
        m = nodes.mailbox["m"]
        mask = nodes.mask[..., None]
        mask = mask.astype(m.dtype) if pkg == "jax" else mask.to(m.dtype)
        return {"h": (m * mask).sum(1) * 0.5 + nodes.data["h"]}
    return reduce


def _msg_udf(edges):
    return {"m": edges.src["h"] * 0.5 + edges.data["w"]}


PROPS = {
    "topo_builtin": lambda p, f, g, pkg: p.prop_nodes_topo(
        g, f.copy_u("h", "m"), f.sum("m", "acc")),
    "topo_udf_msg": lambda p, f, g, pkg: p.prop_nodes_topo(
        g, _msg_udf, f.sum("m", "h")),
    "topo_udf_reduce": lambda p, f, g, pkg: p.prop_nodes_topo(
        g, f.copy_u("h", "m"), _acc_udf(pkg)),
    "topo_reverse": lambda p, f, g, pkg: p.prop_nodes_topo(
        g, f.copy_u("h", "m"), f.max("m", "acc"), reverse=True),
    "bfs": lambda p, f, g, pkg: p.prop_nodes_bfs(
        g, [0, 1], f.u_mul_e("h", "w", "m"), f.sum("m", "h")),
    "dfs_edges": lambda p, f, g, pkg: p.prop_edges_dfs(
        g, [0, 2], _msg_udf, f.sum("m", "h")),
    "prop_edges_bfs": lambda p, f, g, pkg: p.prop_edges(
        g, dgl_trav(pkg).bfs_edges_generator(g, [0]),
        f.copy_u("h", "m"), f.sum("m", "h")),
}


def dgl_trav(pkg):
    return jtrav if pkg == "jax" else ttrav


@pytest.mark.parametrize("prop", sorted(PROPS))
def test_propagation_matches_jax(prop):
    gj, gt = _pair("dag")
    n, e = gt.num_nodes(), gt.num_edges()
    rng = np.random.default_rng(3)
    h = rng.normal(size=(n, 2)).astype(np.float32)
    w = rng.normal(size=(e, 1)).astype(np.float32)
    gj.ndata["h"], gj.edata["w"] = jnp.asarray(h), jnp.asarray(w)
    gt.ndata["h"], gt.edata["w"] = torch.from_numpy(h), torch.from_numpy(w)
    PROPS[prop](jprop, jfn, gj, "jax")
    PROPS[prop](tprop, tfn, gt, "torch")
    assert set(gt.ndata.keys()) == set(gj.ndata.keys())
    for k in gt.ndata.keys():
        ref = np.asarray(gj.ndata[k])
        np.testing.assert_allclose(gt.ndata[k].numpy(), ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1))


def test_initializers():
    z = tinit.zero_initializer((3, 2))
    assert z.dtype == torch.float32 and z.shape == (3, 2) and not z.any()
    b = tinit.base_initializer((4,), torch.float64)
    assert b.dtype == torch.float64 and not b.any()
