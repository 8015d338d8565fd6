"""The prefetch pipeline of the PyTorch port (``distributed.prefetch``) on
``device="cpu"``, as tests/test_sampling.py drives the JAX package's:
the threaded prefetcher keeps the loader's order and copies the sample
tree (numpy arrays become tensors, graphs move, other leaves stay); the
pooled one merges its workers' shards so that the union of seeds covers
every node; errors in a worker reach the consumer after the items before
them; leaving a loop early stops the workers; and a stress run of more
threads than cores with a short switch interval loses no item.  The
copies through pinned memory on a side stream run only on the card
(``chip_smoke.py``'s ``prefetch`` phase)."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu import sampling as jsampling

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import sampling as tsampling
from dgl_hack_tpu_torch.distributed import (PooledPrefetcher,
                                            ThreadedPrefetcher,
                                            prefetch_to_device)
from dgl_hack_tpu_torch.distributed.prefetch import to_device

torch.set_num_threads(2)
N = 50


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, 400), rng.integers(0, N, 400)
    return src, dst, dt.graph((src, dst), num_nodes=N)


def _wait_threads(before, timeout=10.0):
    """True once no thread started since ``before`` is alive."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]:
            return True
        time.sleep(0.01)
    return False


def test_threaded_prefetcher_matches_loader_and_jax(graph):
    """The same minibatches as the unprefetched loader, in its order, each
    equal to the JAX package's loader's (one seed); blocks come as
    graphs, ids as tensors."""
    src, dst, g = graph
    gj = dgl.graph((src, dst), num_nodes=N)

    def loader(pkg, gg):
        return pkg.NodeDataLoader(
            gg, np.arange(N), pkg.MultiLayerNeighborSampler(
                [3, 4], replace=True, seed=1), 8, seed=2)
    plain = list(loader(tsampling, g))
    ref = list(loader(jsampling, gj))
    got = list(prefetch_to_device(loader(tsampling, g), device="cpu"))
    assert len(got) == len(plain) == len(ref) == 7
    for (it, st, bt), (ip, sp, bp), (ij, sj, bj) in zip(got, plain, ref):
        assert torch.is_tensor(it) and torch.is_tensor(st)
        np.testing.assert_array_equal(it.numpy(), ip)
        np.testing.assert_array_equal(st.numpy(), sj)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        for a, b, c in zip(bt, bp, bj):
            assert isinstance(a, dt.Graph) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.host("src"), b.host("src"))
            np.testing.assert_array_equal(a.host("src"), np.asarray(c.src))
            np.testing.assert_array_equal(a.edata["_ID"].numpy(),
                                          b.edata["_ID"].numpy())


def test_to_device_walks_the_tree(graph):
    _, _, g = graph
    g.ndata["x"] = torch.ones(N, 2)
    item = {"a": (np.arange(3), [np.ones(2, np.float32), "tag"]),
            "g": g, "t": torch.zeros(2), "n": None,
            "s": np.array(["x", "y"])}
    out = to_device(item, "cpu")
    assert isinstance(out["a"], tuple) and isinstance(out["a"][1], list)
    assert torch.is_tensor(out["a"][0]) and out["a"][0].dtype == torch.int64
    assert out["a"][1][1] == "tag" and out["n"] is None
    assert isinstance(out["s"], np.ndarray)
    assert isinstance(out["g"], dt.Graph) and "x" in out["g"].ndata
    assert out["t"].device.type == "cpu"


def test_threaded_prefetcher_raises_after_items():
    def gen():
        yield np.zeros(1)
        yield np.ones(1)
        raise RuntimeError("sampler boom")
    seen = []
    with pytest.raises(RuntimeError, match="sampler boom"):
        for item in ThreadedPrefetcher(gen(), capacity=1, device="cpu"):
            seen.append(float(item[0]))
    assert seen == [0.0, 1.0]
    # device_put=False hands the items over as they are
    assert isinstance(next(iter(ThreadedPrefetcher(
        iter([np.zeros(2)]), device_put=False))), np.ndarray)


@pytest.mark.parametrize("pooled", [False, True])
def test_leaving_early_stops_the_workers(pooled):
    """A consumer that stops after one item: the workers stop within a
    few items of it instead of running the source out."""
    made = []

    def source(i=0):
        for k in range(10_000):
            made.append(k)
            yield np.full(4, k)
    before = set(threading.enumerate())
    it = iter(PooledPrefetcher(source, num_workers=3, capacity=2,
                               device="cpu") if pooled else
              ThreadedPrefetcher(source(), capacity=2, device="cpu"))
    first = next(it)
    assert first.shape == (4,)
    it.close()
    assert _wait_threads(before)
    assert len(made) < 20


def test_pooled_prefetcher_covers_every_seed(graph):
    """Three workers over three shards: every node of every shard arrives
    as a seed (the last partial batches padded), each item whole; an
    error in one worker, or in building its loader, reaches the consumer
    once the others end."""
    _, _, g = graph
    nids = np.arange(N)
    shards = np.array_split(nids, 3)

    def make_loader(i):
        return tsampling.NodeDataLoader(
            g, shards[i], tsampling.MultiLayerNeighborSampler(
                [4], replace=True, seed=100 + i),
            batch_size=8, drop_last=False, seed=i)

    seen, count = [], 0
    for input_nodes, seeds, blocks in PooledPrefetcher(
            make_loader, num_workers=3, capacity=2, device="cpu"):
        assert blocks[0].num_dst_nodes == len(seeds) == 8
        assert torch.is_tensor(input_nodes)
        seen.append(seeds.numpy())
        count += 1
    assert count == sum(-(-len(s) // 8) for s in shards)
    np.testing.assert_array_equal(np.unique(np.concatenate(seen)), nids)

    def bad_loader(i):
        def gen():
            yield from make_loader(i)
            if i == 1:
                raise RuntimeError("worker boom")
        return gen()
    with pytest.raises(RuntimeError, match="worker boom"):
        for _ in PooledPrefetcher(bad_loader, num_workers=3, device="cpu"):
            pass

    def no_loader(i):
        if i == 2:
            raise ValueError("no shard")
        return make_loader(i)
    with pytest.raises(ValueError, match="no shard"):
        for _ in PooledPrefetcher(no_loader, num_workers=3, device="cpu"):
            pass


def test_pooled_prefetcher_stress():
    """32 threads (more than the cores) yielding 200 items each through a
    queue of 3 with a 1 us switch interval: every item arrives once."""
    def make(i):
        return ((i, k) for k in range(200))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = time.monotonic()
        got = list(PooledPrefetcher(make, num_workers=32, capacity=3,
                                    device_put=False))
        assert time.monotonic() - start < 60
    finally:
        sys.setswitchinterval(old)
    assert sorted(got) == [(i, k) for i in range(32) for k in range(200)]
