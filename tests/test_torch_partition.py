"""The port's partitioning (``partition/partition.py``) and int64-id big
graphs (``core/biggraph.py``) against the JAX package's, on a power-law
graph of 3,000 nodes and 24,000 edges.

Every method gives the JAX assignment exactly, and prints the JAX line;
``partition_graph_with_halo`` at 0, 1 and 2 hops gives the same parts
(node and edge maps, masks, edges in both orders); the part files of
either package load in the other; ``metis_partition`` equals the JAX
one, and at ``extra_cached_hops=0`` every part has no edges in both
packages (the JAX function's behaviour, which the port keeps);
``BigGraph`` compacts and partitions ids above 2^31 as the JAX one does
through Fennel, and through the stateless hash, whose JAX branch raises
(its constant overflows np.int64), by that expression in wrapping 64-bit
arithmetic; ``spatial_plan`` gives the JAX plan (since
``parallel/halo.py`` was ported; tests/test_torch_spatial_plan.py holds
the plans field by field)."""
import importlib

import numpy as np
import pytest
import torch

from dgl_hack_tpu.core.biggraph import BigGraph as JBig
from dgl_hack_tpu.data import random_power_law_graph as jpower
from dgl_hack_tpu.data import synthetic_cora as jcora

from dgl_hack_tpu_torch.core.biggraph import BigGraph as TBig
from dgl_hack_tpu_torch.data import random_power_law_graph as tpower
from dgl_hack_tpu_torch.data import synthetic_cora as tcora

torch.set_num_threads(2)

# the modules (each package's partition/__init__ exports a function of
# the same name)
JP = importlib.import_module("dgl_hack_tpu.partition.partition")
TP = importlib.import_module("dgl_hack_tpu_torch.partition.partition")

METHODS = ("random", "range", "fennel", "fennel-nodes", "fennel-refine",
           "multilevel")


@pytest.fixture(scope="module")
def graphs():
    return jpower(3000, 8.0, seed=1), tpower(3000, 8.0, seed=1)


def same_graph(gj, gt):
    assert gj.num_nodes() == gt.num_nodes()
    for name in ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids"):
        np.testing.assert_array_equal(gj.host(name), gt.host(name), name)
    for a, b in zip(gj.host_edges(), gt.host_edges()):
        np.testing.assert_array_equal(a, b)


def same_parts(pj, pt):
    assert len(pj) == len(pt)
    for a, b in zip(pj, pt):
        assert a.part_id == b.part_id
        for f in ("node_map", "edge_map", "inner_node", "inner_edge"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, f)
        same_graph(a.graph, b.graph)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("k", [1, 4, 7])
def test_partition_matches_jax(graphs, capsys, method, k):
    gj, gt = graphs
    pj = JP.partition(gj, k, method=method, seed=3)
    line_j = capsys.readouterr().out
    pt = TP.partition(gt, k, method=method, seed=3)
    line_t = capsys.readouterr().out
    assert pt.dtype == pj.dtype == np.int32
    np.testing.assert_array_equal(pj, pt)
    assert line_t == line_j
    if k > 1:
        assert line_t.startswith(f"partition[{method}] k={k}: edge-cut ")


def test_partition_parts_named(graphs):
    gj, gt = graphs
    with pytest.raises(ValueError, match="unknown partition method"):
        TP.partition(gt, 2, method="metis")
    np.testing.assert_array_equal(
        JP.refine_partition(gj, JP.random_partition(gj, 5), 5, seed=1),
        TP.refine_partition(gt, TP.random_partition(gt, 5), 5, seed=1))


@pytest.mark.parametrize("hops", [0, 1, 2])
def test_halo_matches_jax(graphs, hops):
    gj, gt = graphs
    parts = JP.partition(gj, 4, method="fennel")
    same_parts(JP.partition_graph_with_halo(gj, parts, hops),
               TP.partition_graph_with_halo(gt, parts, hops))


def test_halo_of_a_card_graph_reads_host_arrays(graphs):
    """A graph whose tensors were replaced (as on the card) partitions
    from its host arrays, ``g.host(...)``."""
    gj, gt = graphs
    moved = gt.to("cpu")
    parts = TP.partition(moved, 3)
    same_parts(JP.partition_graph_with_halo(gj, parts, 1),
               TP.partition_graph_with_halo(moved, parts, 1))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_part_files_read_across(graphs, tmp_path, writer):
    gj, gt = graphs
    parts = JP.partition(gj, 3, method="fennel")
    pj = JP.partition_graph_with_halo(gj, parts, 1)
    pt = TP.partition_graph_with_halo(gt, parts, 1)
    prefix = str(tmp_path / "g")
    (JP.save_partitions if writer == "jax" else TP.save_partitions)(
        prefix, pj if writer == "jax" else pt)
    same_parts(pj, [TP.load_partition(prefix, i) for i in range(3)])
    same_parts([JP.load_partition(prefix, i) for i in range(3)], pt)


@pytest.mark.parametrize("hops", [0, 1])
def test_metis_partition_matches_jax(hops):
    """examples/train_cluster_gcn.py's call on synthetic Cora."""
    gj, gt = jcora(seed=0).graph, tcora(seed=0).graph
    same_parts(JP.metis_partition(gj, 8, extra_cached_hops=hops),
               TP.metis_partition(gt, 8, extra_cached_hops=hops))


def test_metis_partition_zero_hops_has_no_edges():
    """extra_cached_hops=0 runs the halo loop no time, so every part holds
    its owned nodes and no edge, in both packages; one hop holds each
    part's in-edges and their sources."""
    gj, gt = jcora(seed=0).graph, tcora(seed=0).graph
    for pkg, g in ((JP, gj), (TP, gt)):
        p0 = pkg.metis_partition(g, 8, extra_cached_hops=0)
        assert [p.graph.num_edges() for p in p0] == [0] * 8
        assert sum(p.graph.num_nodes() for p in p0) == g.num_nodes()
        assert all(p.inner_node.all() for p in p0)
        p1 = pkg.metis_partition(g, 8, extra_cached_hops=1)
        assert all(p.graph.num_edges() > 0 for p in p1)
        assert sum(int(p.inner_edge.sum()) for p in p1) == g.num_edges()


def _big_edges():
    """A graph whose conceptual node and edge ids lie above 2^31."""
    rng = np.random.default_rng(11)
    ids = np.int64(2**31) + np.int64(7) * rng.permutation(900)
    s = ids[rng.integers(0, 900, 5000)]
    d = ids[rng.integers(0, 900, 5000)]
    eids = np.int64(3) * 2**32 + np.arange(5000, dtype=np.int64) * 5
    return s, d, eids


def test_biggraph_compact_matches_jax():
    s, d, e = _big_edges()
    bj, bt = JBig(s, d, e), TBig(s, d, e)
    for a, b in zip(bj.compact(), bt.compact()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    (gj, uj), (gt, ut) = bj.compact_graph(), bt.compact_graph()
    assert ut.dtype == np.int64 and ut.min() >= 2**31
    np.testing.assert_array_equal(uj, ut)
    same_graph(gj, gt)


def test_biggraph_fennel_partition_matches_jax(capsys):
    """'fennel' partitions the compacted graph (fewer than 2^31 edges)."""
    s, d, e = _big_edges()
    pj = JBig(s, d, e).partition(4, method="fennel", seed=2)
    line_j = capsys.readouterr().out
    pt = TBig(s, d, e).partition(4, method="fennel", seed=2)
    assert capsys.readouterr().out == line_j
    assert len(pj) == len(pt) == 4
    for a, b in zip(pj, pt):
        for f in ("node_map64", "edge_map64", "inner_node"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        same_graph(a.graph, b.graph)
        assert b.node_map64.dtype == np.int64 and b.node_map64.min() >= 2**31
        assert b.edge_map64.min() >= 3 * 2**32
    assert sum(p.graph.num_edges() for p in pt) == 5000


def test_biggraph_hash_partition():
    """Any other method (and 'fennel' past 2^31 edges) takes the stateless
    hash of the int64 ids.  The JAX module's constant overflows np.int64,
    so its branch raises; the port's hash is the same expression in
    wrapping 64-bit arithmetic, held here to Python integers, and each
    part holds the edges whose dst it owns, with their conceptual ids."""
    s, d, e = _big_edges()
    with pytest.raises(OverflowError):
        JBig(s, d, e).partition(4, method="random")
    big = TBig(s, d, e)
    parts = big.partition(4, method="random")
    uids = big.compact()[0]

    def part_of(u):
        h = (int(u) * 0x9E3779B97F4A7C15) % 2**64
        return ((h - 2**64 if h >= 2**63 else h) >> 40) % 4
    want = {int(u): part_of(u) for u in uids}
    assert len(set(want.values())) == 4
    seen = []
    for p in parts:
        owned = p.node_map64[p.inner_node]
        assert all(want[int(u)] == p.part_id for u in owned)
        assert p.inner_node[:len(owned)].all()          # owned first
        ls, ld = p.graph.host_edges()
        pos = (p.edge_map64 - 3 * 2**32) // 5
        np.testing.assert_array_equal(p.node_map64[ls], s[pos])
        np.testing.assert_array_equal(p.node_map64[ld], d[pos])
        assert all(want[int(v)] == p.part_id for v in d[pos])
        seen.append(pos)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(5000))


def test_biggraph_spatial_plan_raises():
    """Named when the port's ``spatial_plan`` raised ``'multi-gpu'``; it
    now builds the plan, equal to the JAX one over the compacted graph,
    and raises nothing."""
    s, d, e = _big_edges()
    jp, ju = JBig(s, d, e).spatial_plan(2, method="fennel", seed=0)
    tp, tu = TBig(s, d, e).spatial_plan(2, method="fennel", seed=0)
    np.testing.assert_array_equal(tu, ju)
    for name in ("src_ext", "dst_loc", "edge_mask", "send_idx", "owned_ids",
                 "in_deg", "out_deg", "rsrc", "lsrc"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
