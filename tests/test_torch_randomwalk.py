"""Random walks and the PinSAGE samplers of the PyTorch port against the
JAX package: from one numpy generator seed, the traces, the visited node
lists, the packed traces and the PinSAGE graphs (edges and visit-count
weights) must agree bit for bit.  One departure is pinned: ``random_walk``
reaching a dead end whose id is past every source raises in the JAX
package and ends the trace in the port."""
import numpy as np
import pytest

import dgl_hack_tpu as dgl
from dgl_hack_tpu import sampling as jsampling

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import sampling as tsampling

N, E = 120, 700


@pytest.fixture(scope="module")
def graphs():
    """A graph whose nodes 0..9 have no out-edges (walks end there)."""
    rng = np.random.default_rng(0)
    src = rng.integers(10, N, E)
    dst = rng.integers(0, N, E)
    return dgl.graph((src, dst), num_nodes=N), dt.graph((src, dst),
                                                         num_nodes=N)


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("restart_prob", [0.0, 0.3])
def test_random_walk_matches_jax(graphs, restart_prob):
    gj, gt = graphs
    nodes = np.concatenate([np.arange(10, N, 4), [0, 3]])
    rj, rt = _rngs(1)
    tj = jsampling.random_walk(gj, nodes, 6, restart_prob, rng=rj)
    tt = tsampling.random_walk(gt, nodes, 6, restart_prob, rng=rt)
    np.testing.assert_array_equal(tt, tj)
    assert tt.shape == (len(nodes), 7) and (tt[-2:, 1:] == -1).all()
    assert (tt == -1).any()
    if restart_prob == 0:
        assert (tt[:-2, 1] >= 0).all()
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


def test_random_walk_ends_at_the_last_node():
    """A walk that reaches a dead end whose id is past every source: the
    JAX package indexes past its CSR arrays there and raises; the port
    pads the trace with -1 and draws the same numbers."""
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 3])
    rj, rt = _rngs(8)
    with pytest.raises(IndexError):
        jsampling.random_walk(dgl.graph((src, dst), num_nodes=4), [0, 1], 5,
                              rng=rj)
    tt = tsampling.random_walk(dt.graph((src, dst), num_nodes=4), [0, 1], 5,
                              rng=rt)
    np.testing.assert_array_equal(tt, [[0, 1, 2, 3, -1, -1],
                                       [1, 2, 3, -1, -1, -1]])


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0), (4.0, 0.25)])
def test_node2vec_random_walk_matches_jax(graphs, p, q):
    gj, gt = graphs
    nodes = np.arange(0, N, 6)
    rj, rt = _rngs(2)
    tj = jsampling.node2vec_random_walk(gj, nodes, p, q, 5, rng=rj)
    tt = tsampling.node2vec_random_walk(gt, nodes, p, q, 5, rng=rt)
    np.testing.assert_array_equal(tt, tj)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("early_stop", [(0, 0), (3, 2)])
def test_random_walk_with_restart_matches_jax(graphs, early_stop):
    gj, gt = graphs
    nodes = [0, 5, 17, N - 1]
    rj, rt = _rngs(3)
    oj = jsampling.random_walk_with_restart(gj, nodes, 0.2, 12, *early_stop,
                                            rng=rj)
    ot = tsampling.random_walk_with_restart(gt, nodes, 0.2, 12, *early_stop,
                                            rng=rt)
    assert len(ot) == len(oj) == len(nodes)
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and len(np.unique(a)) == len(a)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


def _hetero(pkg, seed=4, users=50, items=30, e=260):
    """A user-item graph both ways, and an item-tag relation; users 45..
    interact with nothing (walks from them end)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users - 5, e).astype(np.int32)
    i = rng.integers(0, items, e).astype(np.int32)
    t = rng.integers(0, 6, items).astype(np.int32)
    return pkg.heterograph({
        ("user", "ui", "item"): (u, i),
        ("item", "iu", "user"): (i, u),
        ("item", "it", "tag"): (np.arange(items, dtype=np.int32), t),
    }, num_nodes_dict={"user": users, "item": items, "tag": 6})


@pytest.mark.parametrize("restart_prob", [0.0, 0.25])
def test_metapath_random_walk_and_pack_match_jax(restart_prob):
    hj, ht = _hetero(dgl), _hetero(dt)
    nodes = np.concatenate([np.tile(np.arange(0, 50, 3), 2), [47, 49]])
    path = ["ui", "iu", "ui", "iu", "ui", "it"]
    rj, rt = _rngs(5)
    tj, yj = jsampling.metapath_random_walk(hj, path, nodes, restart_prob,
                                            rng=rj)
    tt, yt = tsampling.metapath_random_walk(ht, path, nodes, restart_prob,
                                            rng=rt)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(yt, yj)
    assert tt.dtype == np.int64 and (tt[-2:, 1:] == -1).all()
    for a, b in zip(tsampling.pack_traces(tt, yt),
                    jsampling.pack_traces(tj, yj)):
        np.testing.assert_array_equal(a, b)
    vids, tys, lengths, offsets = tsampling.pack_traces(tt, yt)
    assert lengths.sum() == len(vids) == len(tys) == (tt >= 0).sum()
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


def _assert_same_pinsage(gj, gt, column="weights"):
    assert gt.num_src_nodes == gj.num_src_nodes
    for name in ("src", "dst", "csc_indptr", "int2user"):
        jv = getattr(gj, name)
        if jv is None:
            assert getattr(gt, name) is None, name
        else:
            np.testing.assert_array_equal(gt.host(name), np.asarray(jv))
    np.testing.assert_array_equal(gt.edata[column].numpy(),
                                  np.asarray(gj.edata[column]))


@pytest.mark.parametrize("restart_prob", [0.0, 0.5])
def test_pinsage_sampler_matches_jax(restart_prob):
    """PinSAGESampler (item -> user -> item) and RandomWalkNeighborSampler
    over an explicit two-hop metapath: the same neighbors and visit
    counts; at most num_neighbors per seed, none of another type."""
    hj, ht = _hetero(dgl), _hetero(dt)
    seeds = np.arange(0, 30, 2)
    sj = jsampling.PinSAGESampler(hj, "item", "user", 3, restart_prob, 12,
                                  4, seed=6)
    st = tsampling.PinSAGESampler(ht, "item", "user", 3, restart_prob, 12,
                                  4, seed=6)
    for _ in range(2):          # the generator carries over between calls
        gj, gt = sj(seeds), st(seeds)
        _assert_same_pinsage(gj, gt)
        per_seed = np.bincount(gt.host("dst"), minlength=30)
        assert per_seed.max() <= 4 and per_seed[1::2].sum() == 0
        assert (gt.edata["weights"].numpy() >= 1).all()
    rj = jsampling.RandomWalkNeighborSampler(
        hj, 2, restart_prob, 8, 3, metapath=["iu", "ui"],
        weight_column="w", seed=7)
    rt = tsampling.RandomWalkNeighborSampler(
        ht, 2, restart_prob, 8, 3, metapath=["iu", "ui"],
        weight_column="w", seed=7)
    _assert_same_pinsage(rj(seeds), rt(seeds), "w")


def test_pinsage_sampler_rejects_bad_metapaths():
    ht = _hetero(dt)
    with pytest.raises(ValueError, match="one ntype"):
        tsampling.RandomWalkNeighborSampler(ht, 2, 0.0, 4, 2,
                                            metapath=["ui"])
    with pytest.raises(ValueError, match="metapath required"):
        tsampling.RandomWalkNeighborSampler(ht, 2, 0.0, 4, 2)
    with pytest.raises(ValueError, match="exactly one etype"):
        tsampling.PinSAGESampler(ht, "item", "tag", 2, 0.0, 4, 2)
