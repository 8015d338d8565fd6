"""Batching and the readouts of the PyTorch port against the JAX package.

* batch/unbatch: the same structure, features, segment ids and graph
  counts as the JAX package's (exact).
* The twelve readouts, forward and gradient, with and without weights, on
  batched and unbatched graphs, including tied maxima: within 1e-5 of
  max|ref| (float32; the summation order differs).  The port's max, like
  the JAX one, splits the cotangent evenly between tied rows.
* ``sbm_mixture``: the same graphs, features and labels (exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.core import batch as jbatch
from dgl_hack_tpu.data import sbm_mixture as jax_sbm

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.core import batch as tbatch
from dgl_hack_tpu_torch.data import sbm_mixture

torch.set_num_threads(2)

TOL = 1e-5


def assert_close(out, ref, tol=TOL, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin, err_msg=what)
    np.testing.assert_array_equal(out[~fin], ref[~fin], err_msg=what)
    if fin.any():
        scale = max(float(np.abs(ref[fin]).max()), 1e-30)
        err = float(np.abs(out[fin] - ref[fin]).max())
        assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _graphs(seed=0, sizes=(5, 1, 9, 4, 7)):
    """Small random graphs in both packages, each with node features 'h'
    (N, 3) and edge features 'w' (E, 2) in user order; node 0 of each
    graph gets a hub of in-edges, so the CSC order differs from the user
    order."""
    rng = np.random.default_rng(seed)
    jg, tg = [], []
    for n in sizes:
        e = 3 * n
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        dst[::3] = 0
        h = rng.normal(size=(n, 3)).astype(np.float32)
        w = rng.normal(size=(e, 2)).astype(np.float32)
        a = dgl.graph((src, dst), num_nodes=n)
        b = dt.graph((src, dst), num_nodes=n)
        a.ndata["h"], a.edata["w"] = jnp.asarray(h), jnp.asarray(w)
        b.ndata["h"], b.edata["w"] = torch.from_numpy(h), torch.from_numpy(w)
        jg.append(a)
        tg.append(b)
    return jg, tg


def test_batch_matches_jax_and_round_trips():
    jg, tg = _graphs()
    jb, tb = jbatch.batch(jg), tbatch.batch(tg)
    assert tb.batch_num_nodes == jb.batch_num_nodes
    assert tb.batch_num_edges == jb.batch_num_edges
    for name in ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids",
                 "int2user", "user2int"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    np.testing.assert_array_equal(tb.ndata["h"].numpy(),
                                  np.asarray(jb.ndata["h"]))
    np.testing.assert_array_equal(tb.edata["w"].numpy(),
                                  np.asarray(jb.edata["w"]))
    np.testing.assert_array_equal(tbatch.node_segment_ids(tb).numpy(),
                                  np.asarray(jbatch.node_segment_ids(jb)))
    ids = tbatch.edge_segment_ids(tb).numpy()
    np.testing.assert_array_equal(ids, np.asarray(jbatch.edge_segment_ids(jb)))
    assert (np.diff(ids) >= 0).all()          # sorted in internal order
    assert tbatch.num_graphs(tb) == jbatch.num_graphs(jb) == len(tg)
    for a, b in zip(tbatch.unbatch(tb), tg):
        for name in ("src", "dst", "csc_indptr"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          getattr(b, name).numpy())
        np.testing.assert_array_equal(a.ndata["h"].numpy(),
                                      b.ndata["h"].numpy())
        np.testing.assert_array_equal(a.edata["w"].numpy(),
                                      b.edata["w"].numpy())
        np.testing.assert_array_equal(
            np.stack(a.host_edges()), np.stack(b.host_edges()))


def test_batch_carries_counts_through_to_and_replace():
    _, tg = _graphs()
    tb = tbatch.batch(tg)
    for g in (tb.to("cpu"), tb.replace()):
        assert g.batch_num_nodes == tb.batch_num_nodes
        assert g.batch_num_edges == tb.batch_num_edges
    assert tb.num_edges_static == tb.num_edges()


def test_batch_hetero_not_ported():
    """Ported since: batch_hetero refuses an empty list and unbatch_hetero
    a heterograph that batch_hetero did not make, as the JAX package's
    do (the round trip is in test_torch_heterograph.py)."""
    with pytest.raises(ValueError, match="at least one graph"):
        dt.batch_hetero([])
    with pytest.raises(ValueError, match="batch_hetero"):
        dt.unbatch_hetero(dt.heterograph({("a", "r", "b"): ([0], [0])}))


def _setup(batched, seed=0, ties=False):
    jg, tg = _graphs(seed)
    if batched:
        jg, tg = jbatch.batch(jg), tbatch.batch(tg)
    else:
        jg, tg = jg[2], tg[2]
    rng = np.random.default_rng(seed + 1)
    n, e = tg.num_nodes(), tg.num_edges()
    x = rng.normal(size=(n, 4)).astype(np.float32)
    ex = rng.normal(size=(e, 4)).astype(np.float32)
    if ties:          # whole columns tie inside every graph
        x[:, 1] = 0.5
        ex[:, 2] = -1.0
        x[::2, 3] = x[0, 3]
    nw = rng.uniform(0.1, 2.0, size=(n,)).astype(np.float32)
    ew = rng.uniform(0.1, 2.0, size=(e, 1)).astype(np.float32)
    cot_n = rng.normal(size=(n, 4)).astype(np.float32)
    return jg, tg, x, ex, nw, ew, cot_n


READOUTS = ["sum_nodes", "mean_nodes", "max_nodes", "sum_edges",
            "mean_edges", "max_edges", "softmax_nodes", "softmax_edges"]


def _jax_and_port(name, jg, tg, x, w, weighted):
    """Forward and the gradient of <out, cot> w.r.t. x (and w) in both
    packages; x is node or edge data as the readout takes it (internal
    order for edges)."""
    jf, tf = getattr(dgl.readout, name), getattr(dt.readout, name)
    rng = np.random.default_rng(7)

    def jfun(xx, ww):
        out = jf(jg, xx, ww) if weighted else jf(jg, xx)
        return out
    jout = np.asarray(jfun(jnp.asarray(x), jnp.asarray(w)))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jgrads = jax.grad(lambda xx, ww: (jfun(xx, ww) * cot).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tout = tf(tg, tx, tw) if weighted else tf(tg, tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    return (jout, tout.detach().numpy(),
            [np.asarray(g) for g in jgrads],
            [tx.grad.numpy(), np.zeros_like(w) if tw.grad is None
             else tw.grad.numpy()])


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("name", READOUTS)
@pytest.mark.parametrize("ties", [False, True])
def test_readout_matches_jax(name, batched, ties):
    jg, tg, x, ex, nw, ew, _ = _setup(batched, ties=ties)
    data = x if name.endswith("nodes") else ex
    w = nw if name.endswith("nodes") else ew
    cases = [False]
    if name.split("_")[0] in ("sum", "mean"):
        cases.append(True)
    for weighted in cases:
        jout, tout, jgr, tgr = _jax_and_port(name, jg, tg, data, w, weighted)
        what = f"{name} batched={batched} ties={ties} weighted={weighted}"
        assert_close(tout, jout, what=what)
        assert_close(tgr[0], jgr[0], what=what + " dx")
        if weighted:
            assert_close(tgr[1], jgr[1], what=what + " dw")


def test_max_ties_split_evenly():
    """x = [1, 1, 0.5 | 2] in two graphs: the cotangent of graph 0 splits
    between its two tied rows in both packages."""
    a = [dgl.graph(([0, 1], [1, 2]), num_nodes=3),
         dgl.graph(([], []), num_nodes=1)]
    b = [dt.graph(([0, 1], [1, 2]), num_nodes=3),
         dt.graph(([], []), num_nodes=1)]
    jb, tb = jbatch.batch(a), tbatch.batch(b)
    x = np.array([[1.0], [1.0], [0.5], [2.0]], np.float32)
    jg = jax.grad(lambda v: dgl.readout.max_nodes(jb, v).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    dt.readout.max_nodes(tb, tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tx.grad.numpy()[:, 0], [0.5, 0.5, 0, 1])


@pytest.mark.parametrize("batched", [True, False])
def test_broadcast_matches_jax(batched):
    jg, tg, *_ = _setup(batched)
    G = tbatch.num_graphs(tg)
    v = np.random.default_rng(3).normal(size=(G, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        dt.readout.broadcast_nodes(tg, torch.from_numpy(v)).numpy(),
        np.asarray(dgl.readout.broadcast_nodes(jg, jnp.asarray(v))))
    np.testing.assert_array_equal(
        dt.readout.broadcast_edges(tg, torch.from_numpy(v)).numpy(),
        np.asarray(dgl.readout.broadcast_edges(jg, jnp.asarray(v))))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("idx", [None, 1])
@pytest.mark.parametrize("kind", ["nodes", "edges"])
def test_topk_matches_jax(kind, idx, descending):
    """k = 6 exceeds the smallest graphs (1 and 4 nodes): their missing
    rows are -inf (+inf ascending) in both packages.  Column 1 has ties,
    which come in reverse index order when descending."""
    jg, tg, x, ex, *_ = _setup(True, ties=True)
    data = x if kind == "nodes" else ex
    jf = getattr(dgl.readout, f"topk_{kind}")
    tf = getattr(dt.readout, f"topk_{kind}")
    jout = np.asarray(jf(jg, jnp.asarray(data), 6, descending, idx))
    tout = tf(tg, torch.from_numpy(data), 6, descending, idx).numpy()
    np.testing.assert_array_equal(tout, jout)


def test_readouts_by_field_name():
    jg, tg = _graphs()
    jb, tb = jbatch.batch(jg), tbatch.batch(tg)
    assert_close(dt.sum_nodes(tb, "h").numpy(),
                 np.asarray(dgl.sum_nodes(jb, "h")))
    assert_close(dt.mean_edges(tb, "w").numpy(),
                 np.asarray(dgl.mean_edges(jb, "w")))


def test_sbm_mixture_matches_jax():
    kw = dict(num_graphs=12, nodes_per_graph=10, communities=(1, 4),
              p_in=0.6, p_out=0.05, seed=3)
    dj, dtt = jax_sbm(**kw), sbm_mixture(**kw)
    assert dj.num_classes == dtt.num_classes and dj.name == dtt.name
    np.testing.assert_array_equal(dj.labels, dtt.labels)
    for a, b, fa, fb in zip(dj.graphs, dtt.graphs, dj.features,
                            dtt.features):
        np.testing.assert_array_equal(np.asarray(a.src), b.src.numpy())
        np.testing.assert_array_equal(np.asarray(a.dst), b.dst.numpy())
        np.testing.assert_array_equal(fa, fb)
