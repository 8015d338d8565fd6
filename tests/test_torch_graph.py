"""Graph construction parity: the PyTorch port builds the same internal
edge order, CSC/CSR arrays and permutations as the JAX package, byte for
byte, from the same inputs."""
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.data import planted_partition as jax_planted
from dgl_hack_tpu.data import random_power_law_graph as jax_power_law

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.data import planted_partition, random_power_law_graph

torch.set_num_threads(2)

STRUCT = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids", "int2user",
          "user2int")


def _same_structure(gj, gt):
    assert gt.num_src_nodes == gj.num_src_nodes
    assert gt.num_dst_nodes == gj.num_dst_nodes
    for name in STRUCT:
        a, b = getattr(gj, name), getattr(gt, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert b.dtype == np.int32, name
        assert a.tobytes() == b.tobytes(), name
    np.testing.assert_array_equal(np.asarray(gj.in_degrees()),
                                  gt.in_degrees().numpy())
    np.testing.assert_array_equal(np.asarray(gj.out_degrees()),
                                  gt.out_degrees().numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_planted_partition_identical(seed):
    kw = dict(avg_degree=5.0, homophily=0.8, seed=seed, train_per_class=10,
              num_val=40, num_test=80)
    dj = jax_planted(400, 5, 12, **kw)
    dtt = planted_partition(400, 5, 12, **kw)
    _same_structure(dj.graph, dtt.graph)
    for name in ("features", "labels", "train_mask", "val_mask",
                 "test_mask"):
        a, b = getattr(dj, name), getattr(dtt, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert dj.num_classes == dtt.num_classes


def test_power_law_identical():
    _same_structure(jax_power_law(3000, 8.0, alpha=2.1, seed=1),
                    random_power_law_graph(3000, 8.0, alpha=2.1, seed=1))


@pytest.mark.parametrize("num_nodes", [None, 90])
def test_user_order_graph_identical(num_nodes):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 60, 500)
    dst = rng.integers(0, 60, 500)
    gj = dgl.graph((src, dst), num_nodes=num_nodes)
    gt = dt.graph((src, dst), num_nodes=num_nodes)
    assert gt.int2user is not None
    _same_structure(gj, gt)
    # user order round trip: edges(order='eid') gives the input back
    s, d = gt.edges("eid")
    np.testing.assert_array_equal(s.numpy(), src)
    np.testing.assert_array_equal(d.numpy(), dst)


def test_sorted_input_has_no_permutation():
    src = np.array([3, 1, 2, 0], np.int32)
    dst = np.array([0, 1, 1, 2], np.int32)
    gj, gt = dgl.graph((src, dst)), dt.graph((src, dst))
    assert gt.int2user is None and gt.user2int is None
    _same_structure(gj, gt)


def test_edata_permutes_and_to_keeps_host_cache():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 30, 200), rng.integers(0, 30, 200)
    g = dt.graph((src, dst))
    w = torch.arange(200, dtype=torch.float32)
    g.edata["w"] = w
    # internal order is the dst-sorted order of the user edges
    np.testing.assert_array_equal(g.edata_internal["w"].numpy(),
                                  np.argsort(dst, kind="stable"))
    np.testing.assert_array_equal(g.edata["w"].numpy(), w.numpy())
    g2 = g.to("cpu")
    assert g2.host("src") is g.host("src")
    np.testing.assert_array_equal(g2.edata["w"].numpy(), w.numpy())


def test_out_of_range_ids_refused():
    with pytest.raises(ValueError):
        dt.graph((np.array([0, 5]), np.array([1, 2])), num_nodes=3)
