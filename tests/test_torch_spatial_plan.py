"""The port's spatial plan (``parallel/halo.py``, host part) against the
JAX package's, with no processes: ``build_spatial_plan`` array for array
and stat for stat (build time aside) over the methods ``random`` and
``fennel``, ``hub_k`` 0, 8 and 16, with and without the distributed dense
hub (the graph of tests/test_parallel.py::test_spatial_dense_hub); the
shuffles ``shard_features``, ``unshard_rows`` and ``shard_edata`` (both
layouts); ``attach_spmm_plans``; a rank's ``device_arrays`` and its
block graphs; ``BigGraph.spatial_plan`` on ids above 2^31.  Arrays must be
equal (same dtype, same values)."""
import dataclasses

import numpy as np
import pytest
import torch

import dgl_hack_tpu as jdgl
from dgl_hack_tpu.core.biggraph import BigGraph as JBig
from dgl_hack_tpu.parallel import halo as jhalo

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.core.biggraph import BigGraph as TBig
from dgl_hack_tpu_torch.parallel import halo as thalo

torch.set_num_threads(2)


def _power_graph(seed=7, n=300, e=3000):
    """tests/test_parallel.py's hub-replication graph: power-law
    sources."""
    rng = np.random.default_rng(seed)
    deg = np.clip(rng.pareto(1.1, n) + 1, 1, None)
    src = rng.choice(n, e, p=deg / deg.sum()).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return src, dst, n


def _dense_graph(seed=45, n=1500, e=15000):
    """tests/test_parallel.py's dense-hub graph: power-law destinations."""
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 1.0) ** -0.8
    w /= w.sum()
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.choice(n, e, p=w).astype(np.int32)
    return src, dst, n


def _graphs(src, dst, n):
    return jdgl.graph((src, dst), num_nodes=n), dt.graph((src, dst),
                                                         num_nodes=n)


def assert_plans_equal(jp, tp):
    """Every field of the two plans equal: arrays by dtype and value,
    sizes exactly, the reduced plans recursively."""
    for f in dataclasses.fields(jp):
        name = f.name
        if name == "build_seconds" or name.startswith("spmm"):
            continue
        a, b = getattr(jp, name), getattr(tp, name)
        if name == "reduced":
            assert (a is None) == (b is None)
            if a is not None:
                assert_plans_equal(a, b)
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    sj, st = jp.stats(), tp.stats()
    sj.pop("build_seconds")
    st.pop("build_seconds")
    assert sj == st
    assert jp.num_src_ext == tp.num_src_ext


@pytest.mark.parametrize("method", ["random", "fennel"])
@pytest.mark.parametrize("hub_k", [0, 8, 16])
def test_plan_matches_jax(method, hub_k, capsys):
    src, dst, n = _power_graph()
    jg, tg = _graphs(src, dst, n)
    jp = jhalo.build_spatial_plan(jg, 8, method=method, seed=0, hub_k=hub_k)
    tp = thalo.build_spatial_plan(tg, 8, method=method, seed=0, hub_k=hub_k)
    assert_plans_equal(jp, tp)
    if hub_k:
        assert tp.hk_max > 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1]              # the partition's printed line


@pytest.mark.parametrize("method", ["random", "fennel"])
@pytest.mark.parametrize("hub_k", [0, 8])
def test_dense_hub_plan_matches_jax(method, hub_k):
    src, dst, n = _dense_graph()
    jg, tg = _graphs(src, dst, n)
    jp = jhalo.build_spatial_plan(jg, 8, method=method, seed=0, hub_k=hub_k,
                                  dense_threshold=40)
    tp = thalo.build_spatial_plan(tg, 8, method=method, seed=0, hub_k=hub_k,
                                  dense_threshold=40)
    assert tp.reduced is not None and tp.dense_C.dtype == np.float16
    assert_plans_equal(jp, tp)
    assert tp.stats()["dense_edge_frac"] > 0.1


def test_dense_hub_budget_and_no_candidates():
    """A small ``dense_budget`` caps the dense rows as in JAX; a threshold
    no row reaches leaves the plan without a dense hub in both."""
    src, dst, n = _dense_graph()
    jg, tg = _graphs(src, dst, n)
    for thr, budget in ((40, 4000), (10 ** 6, 4 << 30)):
        jp = jhalo.build_spatial_plan(jg, 4, method="random", seed=1,
                                      dense_threshold=thr,
                                      dense_budget=budget)
        tp = thalo.build_spatial_plan(tg, 4, method="random", seed=1,
                                      dense_threshold=thr,
                                      dense_budget=budget)
        assert_plans_equal(jp, tp)


def test_explicit_parts_and_one_part():
    src, dst, n = _power_graph(seed=3, n=120, e=700)
    jg, tg = _graphs(src, dst, n)
    parts = np.random.default_rng(0).integers(0, 3, n)
    assert_plans_equal(jhalo.build_spatial_plan(jg, 3, parts=parts),
                       thalo.build_spatial_plan(tg, 3, parts=parts))
    assert_plans_equal(jhalo.build_spatial_plan(jg, 1),
                       thalo.build_spatial_plan(tg, 1))


def test_shuffles_match_jax():
    src, dst, n = _power_graph()
    jg, tg = _graphs(src, dst, n)
    jp = jhalo.build_spatial_plan(jg, 8, method="random", seed=0, hub_k=8)
    tp = thalo.build_spatial_plan(tg, 8, method="random", seed=0, hub_k=8)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 3, 2)).astype(np.float32)
    xs = thalo.shard_features(tp, x)
    np.testing.assert_array_equal(xs, jhalo.shard_features(jp, x))
    np.testing.assert_array_equal(thalo.unshard_rows(tp, xs, n), x)
    np.testing.assert_array_equal(thalo.unshard_rows(tp, xs, n),
                                  jhalo.unshard_rows(jp, xs, n))
    w = rng.normal(size=(len(src), 2)).astype(np.float32)
    np.testing.assert_array_equal(thalo.shard_edata(tp, w, fill=-1),
                                  jhalo.shard_edata(jp, w, fill=-1))
    for a, b in zip(thalo.shard_edata(tp, w, layout="split"),
                    jhalo.shard_edata(jp, w, layout="split")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        thalo.shard_edata(tp, w, layout="rows")


def test_device_arrays_are_the_rank_slices():
    """``device_arrays(r, "cpu")`` holds slice [r] of every per-part array
    under the JAX keys (the reduced plan's as ``r2_*``, the dense hub's as
    dC/drows/dmask); with plans attached the rank's block graphs are built
    and readied (their real-edge views and row plans cached)."""
    src, dst, n = _dense_graph()
    tg = dt.graph((src, dst), num_nodes=n)
    plan = thalo.build_spatial_plan(tg, 4, method="random", seed=0, hub_k=8,
                                    dense_threshold=40)
    jg = jdgl.graph((src, dst), num_nodes=n)
    jdev = jhalo.build_spatial_plan(jg, 4, method="random", seed=0, hub_k=8,
                                    dense_threshold=40).device_arrays()
    att = thalo.attach_spmm_plans(plan, te=64)
    assert att.spmm_attached == ("local", "remote", "graph")
    for r in range(4):
        dev = att.device_arrays(r, "cpu")
        for k, v in jdev.items():
            np.testing.assert_array_equal(dev[k].numpy(),
                                          np.asarray(v)[r], err_msg=k)
        for key in ("g_graph", "r2_g_local", "r2_g_remote"):
            g = dev[key]
            assert "real_edges" in g.derived
            view = g.derived["real_edges"].graph
            assert "k1_plan_csc" in view.derived
            assert "k1_plan_csr" in view.derived
        g = thalo.local_graph(att, dev)
        assert g is dev["g_graph"]
        assert (g.num_src_nodes, g.num_dst_nodes) == (plan.num_src_ext,
                                                      plan.n_owned_max)
        m = plan.edge_mask[r]
        np.testing.assert_array_equal(g.src.numpy()[m], plan.src_ext[r][m])
        np.testing.assert_array_equal(g.csc_indptr.numpy(),
                                      plan.csc_indptr[r])
    with pytest.raises(ValueError):
        thalo.attach_spmm_plans(plan, which=("rows",))


def test_sizes_drop_the_arrays():
    src, dst, n = _dense_graph()
    plan = thalo.build_spatial_plan(dt.graph((src, dst), num_nodes=n), 4,
                                    method="random", dense_threshold=40)
    s = plan.sizes()
    assert s.src_ext is None and s.reduced.src_ext is None
    assert s.dense_C is None
    assert (s.n_owned_max, s.num_src_ext, s.reduced.n_owned_max) == (
        plan.n_owned_max, plan.num_src_ext, plan.reduced.n_owned_max)


def _big_edges():
    """A graph whose conceptual node and edge ids lie above 2^31."""
    rng = np.random.default_rng(11)
    ids = np.int64(2**31) + np.int64(7) * rng.permutation(900)
    s = ids[rng.integers(0, 900, 5000)]
    d = ids[rng.integers(0, 900, 5000)]
    eids = np.int64(3) * 2**32 + np.arange(5000, dtype=np.int64) * 5
    return s, d, eids


@pytest.mark.parametrize("hub_k", [0, 8])
def test_biggraph_spatial_plan_matches_jax(hub_k):
    s, d, e = _big_edges()
    jp, ju = JBig(s, d, e).spatial_plan(8, method="random", seed=0,
                                        hub_k=hub_k)
    tp, tu = TBig(s, d, e).spatial_plan(8, method="random", seed=0,
                                        hub_k=hub_k)
    assert tu.dtype == np.int64 and tu.min() >= 2**31
    np.testing.assert_array_equal(tu, ju)
    assert_plans_equal(jp, tp)
