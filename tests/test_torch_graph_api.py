"""The rest of ``Graph``'s API and ``core/transform.py`` in the PyTorch
port, against the JAX package: the frame views' ``pop``/``update``/
``internal``, ``structure_only``, ``from_scipy``, the networkx round trip,
``reverse``, the structure queries, DGL's method surface and every graph
transform (mirroring tests/test_transform.py and tests/test_graph.py).
Graphs are compared array by array (every structure array equal), node
and edge ids exactly, matrices and eigenvalues to 1e-5.

Also the repair of ``Graph.replace``, which handed the new graph its
parent's host cache, so that ``host()`` of a replaced field returned the
parent's array (and ``prepare_rgcn`` on ``g.replace(edge_mask=m)`` built
its pairs from the parent's edges).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.rgcn import prepare_rgcn as jprepare_rgcn

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import fn as tfn

torch.set_num_threads(2)

N, E = 30, 120
STRUCT = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids", "int2user",
          "user2int", "edge_mask")


def assert_same_graph(jg, tg, what=""):
    assert (jg.num_src_nodes, jg.num_dst_nodes, jg.is_block) == \
        (tg.num_src_nodes, tg.num_dst_nodes, tg.is_block), what
    for name in STRUCT:
        jv = getattr(jg, name)
        if jv is None:
            assert getattr(tg, name) is None, (what, name)
        else:
            np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                          np.asarray(jv),
                                          err_msg=f"{what} {name}")


def _edges(seed=0, n=N, e=E):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 3, e)
    src[:4], dst[:4] = dst[:4], dst[:4]          # loops
    src[-6:], dst[-6:] = src[:6], dst[:6]        # parallel edges
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.fixture(scope="module")
def graphs():
    src, dst = _edges()
    return dgl.graph((src, dst), num_nodes=N), dt.graph((src, dst),
                                                         num_nodes=N)


# ---------------------------------------------------------------------------
# the replace repair
# ---------------------------------------------------------------------------
def test_replace_gives_the_new_graph_its_own_host_cache():
    src, dst = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])
    m = np.array([True, False, True, False])
    g = dt.graph((src, dst), edge_mask=np.ones(4, bool))
    g.host("edge_mask")
    g.host("src")
    h = g.replace(edge_mask=torch.from_numpy(m))
    np.testing.assert_array_equal(h.host("edge_mask"), m)
    np.testing.assert_array_equal(g.host("edge_mask"), np.ones(4, bool))
    h2 = g.replace(src=torch.tensor([3, 2, 1, 0], dtype=torch.int32))
    np.testing.assert_array_equal(h2.host("src"), [3, 2, 1, 0])
    np.testing.assert_array_equal(h2.host("dst"), g.host("dst"))
    # the other direction: a parent with no mask
    g2 = dt.graph((src, dst))
    h3 = g2.replace(edge_mask=torch.from_numpy(m))
    np.testing.assert_array_equal(h3.host("edge_mask"), m)
    assert g2.host("edge_mask") is None
    # to() keeps the cache (the same arrays)
    assert g.to("cpu").host("src") is g.host("src")


def test_prepare_rgcn_on_a_replaced_mask_matches_jax():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    etypes = rng.integers(0, 5, 300)
    m = rng.random(300) > 0.4
    gt = dt.graph((src, dst), num_nodes=40, edge_mask=np.ones(300, bool))
    gt.host("edge_mask")                       # the parent's, read first
    ht = gt.replace(edge_mask=torch.from_numpy(m[gt.host("int2user")]))
    gj = dgl.graph((src, dst), num_nodes=40, edge_mask=m)
    pt = dt.prepare_rgcn(ht, etypes, 5, prepare=False)
    pj = jprepare_rgcn(gj, etypes, 5, prepare=False)
    assert pt.num_pairs == pj.num_pairs
    for name in ("pair_dst", "pair_etype", "edge_perm"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)))
    np.testing.assert_array_equal(pt.pair_graph.src.numpy(),
                                  np.asarray(pj.pair_graph.src))


# ---------------------------------------------------------------------------
# frames and constructors
# ---------------------------------------------------------------------------
def test_frame_views_pop_update_internal(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(1)
    a = rng.normal(size=(N, 2)).astype(np.float32)
    b = rng.normal(size=(E, 3)).astype(np.float32)
    res = {}
    for name, g, conv in (("jax", gj.local_var(), jnp.asarray),
                          ("torch", gt.local_var(), torch.from_numpy)):
        g.ndata.update({"a": conv(a), "c": conv(a * 2)})
        g.edata.update({"b": conv(b)})
        popped = g.ndata.pop("c")
        res[name] = (np.asarray(popped), np.asarray(g.ndata["a"]),
                     np.asarray(g.edata["b"]),
                     np.asarray(g.edata.internal("b")),
                     sorted(g.ndata.keys()))
    for x, y in zip(res["torch"], res["jax"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert "c" not in gt.ndata and "a" not in gt.ndata


def test_structure_only_and_dst_sorted(graphs):
    _, gt = graphs
    g = gt.local_var()
    g.ndata["x"] = torch.ones(N)
    s = g.structure_only()
    assert s.dst_sorted and "x" not in s.ndata and "x" in g.ndata
    assert s.src is g.src and s.derived is g.derived


def test_from_scipy_matches_jax():
    src, dst = _edges(2)
    a = sp.coo_matrix((np.ones(E), (src, dst)), shape=(N, N)).tocsr()
    assert_same_graph(dgl.from_scipy(a), dt.from_scipy(a))


def test_networkx_round_trip_matches_jax():
    import networkx as nx
    nxg = nx.DiGraph([(0, 1), (1, 2), (2, 0), (2, 3)])
    for n, v in enumerate(np.eye(4, 2)):
        nxg.nodes[n]["h"] = v
    for k, (u, v) in enumerate(nxg.edges()):
        nxg.edges[u, v]["w"] = np.float32(k)
    gj = dgl.from_networkx(nxg, node_attrs=["h"], edge_attrs=["w"])
    gt = dt.from_networkx(nxg, node_attrs=["h"], edge_attrs=["w"])
    assert_same_graph(gj, gt)
    np.testing.assert_array_equal(gt.ndata["h"].numpy(), gj.ndata["h"])
    np.testing.assert_array_equal(gt.edata["w"].numpy(), gj.edata["w"])
    back_j = dgl.to_networkx(gj, ["h"], ["w"])
    back_t = dt.to_networkx(gt, ["h"], ["w"])
    assert set(back_t.edges()) == set(back_j.edges()) == set(nxg.edges())
    # each edge keeps its own user id and feature (the JAX function pairs
    # user-order endpoints with internal-order ids, so its ids differ)
    for u, v, k in back_t.edges(data="id"):
        assert list(nxg.edges()).index((u, v)) == k
        assert back_t.edges[u, v, 0]["w"] == nxg.edges[u, v]["w"]
    for n in range(4):
        np.testing.assert_array_equal(back_t.nodes[n]["h"],
                                      back_j.nodes[n]["h"])
    und = dt.from_networkx(nx.Graph([(0, 1), (1, 2)]))
    assert_same_graph(dgl.from_networkx(nx.Graph([(0, 1), (1, 2)])), und)


@pytest.mark.parametrize("masked", [False, True])
def test_reverse_matches_jax(masked):
    src, dst = _edges(4)
    mask = np.random.default_rng(4).random(E) > 0.3 if masked else None
    gj = dgl.graph((src, dst), num_nodes=N, edge_mask=mask)
    gt = dt.graph((src, dst), num_nodes=N, edge_mask=mask)
    assert_same_graph(dgl.reverse(gj), dt.reverse(gt))
    bj = dgl.block((src, dst), N + 5, N)
    bt = dt.block((src, dst), N + 5, N)
    assert_same_graph(dgl.reverse(bj), dt.reverse(bt))


# ---------------------------------------------------------------------------
# structure queries
# ---------------------------------------------------------------------------
QUERIES = {
    "in_edges": lambda g: g.in_edges([0, 3, 7, 29]),
    "out_edges": lambda g: g.out_edges([1, 3, 28]),
    "predecessors": lambda g: g.predecessors(5),
    "successors": lambda g: g.successors(6),
    "has_edges_between": lambda g: g.has_edges_between([0, 1, 2, 29],
                                                       [1, 2, 3, 0]),
    "edge_ids": lambda g: g.edge_ids(*(np.asarray(a)[:20]
                                       for a in g.edges(order="eid"))),
    "edge_ids_absent": lambda g: g.edge_ids([0, 29], [29, 28]),
    "in_out_degree": lambda g: [g.in_degree(3), g.out_degree(3)],
    "has_node": lambda g: [g.has_node(0), g.has_node(N), g.has_node(-1)],
    "has_edge_between": lambda g: [g.has_edge_between(*map(
        int, (np.asarray(a)[5] for a in g.edges(order="eid")))),
        g.has_edge_between(29, 29)],
    "filter_nodes": lambda g: g.filter_nodes(
        lambda nodes: nodes.data["x"][:, 0] > 0),
    "filter_edges": lambda g: g.filter_edges(
        lambda edges: edges.src["x"][:, 0] > edges.dst["x"][:, 0]),
    "adjacency_dense": lambda g: g.adjacency_matrix(),
    "adjacency_transpose": lambda g: g.adjacency_matrix(transpose=True),
    "adjacency_scipy": lambda g: g.adjacency_matrix(scipy_fmt="csr")
    .toarray(),
    "incidence_in": lambda g: g.incidence_matrix("in"),
    "incidence_out": lambda g: g.incidence_matrix("out"),
    "incidence_both": lambda g: g.incidence_matrix("both"),
    "readonly": lambda g: [g.is_readonly],
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_matches_jax(graphs, query):
    gj, gt = graphs
    x = np.random.default_rng(5).normal(size=(N, 2)).astype(np.float32)
    gj, gt = gj.local_var(), gt.local_var()
    gj.ndata["x"] = jnp.asarray(x)
    gt.ndata["x"] = torch.from_numpy(x)
    rj, rt = QUERIES[query](gj), QUERIES[query](gt)
    if not isinstance(rj, tuple):
        rj, rt = (rj,), (rt,)
    for a, b in zip(rt, rj):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))


def test_local_var_and_local_scope(graphs):
    _, gt = graphs
    g = gt.local_var()
    g.ndata["keep"] = torch.ones(N)
    lv = g.local_var()
    lv.ndata["tmp"] = torch.zeros(N)
    lv.ndata["keep"] = torch.zeros(N)
    assert "tmp" not in g.ndata and float(g.ndata["keep"].sum()) == N
    assert lv.derived is g.derived and lv.src is g.src
    with g.local_scope():
        g.ndata["tmp"] = torch.zeros(N)
        g.edata["e"] = torch.zeros(E)
        g.update_all(tfn.copy_u("keep", "m"), tfn.sum("m", "keep"))
    assert "tmp" not in g.ndata and "e" not in g.edata
    assert float(g.ndata["keep"].sum()) == N


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
def _block_pair():
    src, dst = np.array([5, 7, 5]), np.array([0, 1, 1])
    return dgl.block((src, dst), num_src=10, num_dst=3), \
        dt.block((src, dst), num_src=10, num_dst=3)


TRANSFORMS = {
    "khop_graph": lambda m, g: m.khop_graph(g, 2),
    "line_graph": lambda m, g: m.line_graph(g),
    "line_graph_no_backtracking": lambda m, g: m.line_graph(
        g, backtracking=False),
    "to_bidirected": lambda m, g: m.to_bidirected(g),
    "add_self_loop": lambda m, g: m.add_self_loop(g),
    "remove_self_loop": lambda m, g: m.remove_self_loop(g),
    "to_simple": lambda m, g: m.to_simple(g, return_counts=True),
    "remove_edges": lambda m, g: m.remove_edges(g, [0, 2, 50]),
    "node_subgraph": lambda m, g: m.node_subgraph(g, [0, 1, 2, 7, 9, 20]),
    "edge_subgraph": lambda m, g: m.edge_subgraph(g, [3, 1, 40, 41]),
    "edge_subgraph_keep_nodes": lambda m, g: m.edge_subgraph(
        g, [3, 1, 40], relabel_nodes=False),
    "in_subgraph": lambda m, g: m.in_subgraph(g, [0, 4]),
    "out_subgraph": lambda m, g: m.out_subgraph(g, [3, 8]),
    "compact_graphs": lambda m, g: m.compact_graphs(
        [m.remove_edges(g, np.arange(60)), m.remove_edges(g, [1])]),
    "compact_single": lambda m, g: m.compact_graphs(
        m.remove_edges(g, np.arange(100)), always_preserve=[0, 1]),
    "reorder_degree": lambda m, g: m.reorder_graph(g, "degree"),
    "reorder_random": lambda m, g: m.reorder_graph(g, "random"),
    "add_edges": lambda m, g: m.add_edges(g, [1, 30], [2, 31]),
    "add_nodes": lambda m, g: m.add_nodes(g, 3),
    "method_subgraph": lambda m, g: g.subgraph([2, 3, 4, 5]),
    "method_edge_subgraph": lambda m, g: g.edge_subgraph([5, 6, 7]),
    "method_add_nodes": lambda m, g: g.add_nodes(2),
    "method_add_edges": lambda m, g: g.add_edges([0], [29]),
    "knn_graph": lambda m, g: m.knn_graph(
        np.random.default_rng(6).normal(size=(20, 3)), 4),
    "segmented_knn_graph": lambda m, g: m.segmented_knn_graph(
        np.random.default_rng(7).random((12, 3)), 2, [5, 7]),
}


def _compare(rj, rt, what):
    if isinstance(rj, dgl.Graph):
        assert_same_graph(rj, rt, what)
    elif isinstance(rj, (tuple, list)):
        assert len(rj) == len(rt), what
        for a, b in zip(rj, rt):
            _compare(a, b, what)
    else:
        np.testing.assert_array_equal(np.asarray(rt), np.asarray(rj),
                                      err_msg=what)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(graphs, name):
    gj, gt = graphs
    _compare(TRANSFORMS[name](dgl, gj), TRANSFORMS[name](dt, gt), name)


def test_compact_block_matches_jax():
    bj, bt = _block_pair()
    _compare(dgl.compact_graphs([bj]), dt.compact_graphs([bt]), "block")


def test_to_simple_and_remove_edges_on_a_block_match_jax():
    bj, bt = _block_pair()
    _compare(dgl.to_simple(bj), dt.to_simple(bt), "to_simple")
    _compare(dgl.remove_edges(bj, [1]), dt.remove_edges(bt, [1]), "remove")


def test_khop_adj_matches_jax(graphs):
    gj, gt = graphs
    for k in (1, 2, 3):
        np.testing.assert_allclose(dt.khop_adj(gt, k), dgl.khop_adj(gj, k),
                                   rtol=1e-6)


def test_laplacian_lambda_max_matches_jax(graphs):
    gj, gt = graphs
    np.testing.assert_allclose(dt.laplacian_lambda_max(dt.to_bidirected(gt)),
                               dgl.laplacian_lambda_max(
                                   dgl.to_bidirected(gj)), rtol=1e-5)
    parts = [((0, 1), (1, 2), 3), ((0, 1, 2, 3), (1, 2, 3, 0), 4),
             ((0,), (1,), 2)]
    bj = dgl.batch([dgl.to_bidirected(dgl.graph((s, d), num_nodes=n))
                    for s, d, n in parts])
    bt = dt.batch([dt.to_bidirected(dt.graph((s, d), num_nodes=n))
                   for s, d, n in parts])
    np.testing.assert_allclose(dt.laplacian_lambda_max(bt),
                               dgl.laplacian_lambda_max(bj), rtol=1e-5)


def test_reorder_graph_keeps_the_aggregation(graphs):
    _, gt = graphs
    g2, ids = dt.reorder_graph(gt, "degree")
    deg = g2.in_degrees().numpy()
    assert (np.diff(deg) <= 0).all()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(N, 4))
                         .astype(np.float32))
    np.testing.assert_allclose(dt.gspmm(g2, "copy_lhs", "sum", x[ids]),
                               dt.gspmm(gt, "copy_lhs", "sum", x)[ids],
                               rtol=1e-5, atol=1e-6)


def test_knn_graph_takes_a_tensor():
    x = np.random.default_rng(9).normal(size=(20, 3)).astype(np.float32)
    assert_same_graph(dgl.knn_graph(x, 3), dt.knn_graph(torch.from_numpy(x),
                                                        3))


def test_package_exports_the_jax_graph_api():
    """Every name of the JAX package's graph, transform, traversal and
    message API is a name of the port's package too."""
    names = {"add_edges", "add_nodes", "edge_subgraph", "from_networkx",
             "from_scipy", "in_subgraph", "node_subgraph", "out_subgraph",
             "propagate", "pull", "push", "recv", "reverse", "send",
             "send_and_recv", "to_networkx", "traversal", "compact_graphs",
             "khop_adj", "khop_graph", "knn_graph", "laplacian_lambda_max",
             "line_graph", "remove_edges", "reorder_graph",
             "segmented_knn_graph", "to_bidirected", "to_simple"}
    assert names <= set(dir(dgl)) and names <= set(dir(dt))
    assert set(dgl.transform.__all__) <= set(dt.transform.__all__)
