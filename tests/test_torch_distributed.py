"""The port's distributed stack against the JAX package's
``distributed/`` (the cases of tests/test_distributed.py and
tests/test_distributed_procs.py, on the port):

* the key-value store's wire format (``_pack``) byte for byte, and each
  package reading the other's messages; a sample's serialisation
  (``serialize_sample``) byte for byte for the same blocks;
* the key-value store over the in-process loopback and over TCP
  (``NativeTransport``: the port's copy of netcomm.cpp, built at first
  use; a failed build raises with the compiler's messages), with FastPull
  and a custom push handler; 2 server and 2 client processes over TCP;
* the sampler service end to end (threads, and spawned processes that
  never see the card), the feature store, the shared graph structure
  across processes and packages, ``read_ip_config`` and
  ``initialize_from_env`` (a gloo group of two processes).

Every thread, process and socket wait has its own time limit, so that a
hang fails the test rather than the run.  The JAX package is imported
where a test compares with it, not at the top: the spawned workers
import this module, and need only the port."""
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import native
from dgl_hack_tpu_torch.distributed import (
    FeatureStore, KVClient, KVServer, LoopbackTransport, NativeTransport,
    SamplerPool, SamplerReceiver, SamplerSender, attach_shared_graph,
    deserialize_sample, initialize_from_env, make_transports, read_ip_config,
    save_shared_graph, serialize_sample)
from dgl_hack_tpu_torch.distributed import kvstore as tkv
from dgl_hack_tpu_torch.sampling import MultiLayerNeighborSampler

torch.set_num_threads(2)

def _jax():
    """The JAX package's modules (imported on first use)."""
    import dgl_hack_tpu as jdgl
    from dgl_hack_tpu.distributed import dis_sampler as jds
    from dgl_hack_tpu.distributed import feature_store as jfs
    from dgl_hack_tpu.distributed import kvstore as jkv
    from dgl_hack_tpu.sampling import MultiLayerNeighborSampler as JSampler
    return jdgl, jds, jfs, jkv, JSampler


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60


def _free_block(offsets):
    """A base port whose ``base + o`` are all free now."""
    rng = np.random.default_rng()
    for _ in range(100):
        base = int(rng.integers(20000, 60000))
        socks = []
        try:
            for o in offsets:
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + o))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


def _run(fn, timeout=WAIT_S):
    """fn() in a daemon thread, failing the test if it does not end in
    ``timeout`` seconds; its exception is raised here."""
    err = []

    def body():
        try:
            fn()
        except BaseException as e:  # handed to the test
            err.append(e)
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not end within {timeout} s"
    if err:
        raise err[0]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------
def _messages():
    rng = np.random.default_rng(0)
    return [
        (0, "emb", [np.arange(5, dtype=np.int64),
                    rng.normal(size=(5, 3)).astype(np.float32)], 0),
        (2, "x_grad", [rng.integers(0, 9, 4).astype(np.int32)], 17),
        (6, "ünïcode", [rng.normal(size=(2, 2, 2)),
                        np.array([True, False]),
                        rng.normal(size=3).astype(np.float16),
                        np.zeros((0, 4), np.float32),
                        np.array(7, np.int64)], -3),
        (3, "", [], 0)]


@pytest.mark.parametrize("i", range(4))
def test_pack_bytes_equal_jax(i):
    jkv = _jax()[3]
    msg_type, name, arrays, meta = _messages()[i]
    b = tkv._pack(msg_type, name, arrays, meta)
    assert b == jkv._pack(msg_type, name, arrays, meta)
    for buf, unpack in ((b, jkv._unpack), (b, tkv._unpack)):
        t, n, arrs, m = unpack(buf)
        assert (t, n, m) == (msg_type, name, meta)
        assert len(arrs) == len(arrays)
        for a, x in zip(arrs, arrays):
            x = np.ascontiguousarray(x)     # a 0-d array goes as (1,)
            assert a.dtype == x.dtype and a.shape == x.shape
            np.testing.assert_array_equal(a, x)


def _blocks_both(seed, fanouts, replace, seeds):
    jdgl, _, _, _, JSampler = _jax()
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 50, 300).astype(np.int32)
    dst = rng.integers(0, 50, 300).astype(np.int32)
    tg = dt.graph((src, dst), num_nodes=50)
    jg = jdgl.graph((src, dst), num_nodes=50)
    tb = MultiLayerNeighborSampler(fanouts, replace=replace, seed=seed) \
        .sample_blocks(tg, seeds)
    jb = JSampler(fanouts, replace=replace, seed=seed).sample_blocks(jg,
                                                                     seeds)
    return tb, jb


@pytest.mark.parametrize("replace", [False, True])
def test_serialize_sample_bytes_equal_jax(replace):
    """The same blocks (the packages' native samplers draw the same picks
    from one seed) serialise to the same bytes, masks included; each
    package reads the other's."""
    jds = _jax()[1]
    (tb, ti, ts), (jb, ji, js) = _blocks_both(3, [3, 2], replace,
                                              np.arange(8))
    assert tb[0].edge_mask is not None
    buf = serialize_sample(tb, ti, ts)
    assert buf == jds.serialize_sample(jb, ji, js)
    b2, i2, s2 = deserialize_sample(jds.serialize_sample(jb, ji, js))
    np.testing.assert_array_equal(i2, ti)
    np.testing.assert_array_equal(s2, ts)
    for a, b in zip(tb, b2):
        assert (a.num_src_nodes, a.num_dst_nodes) == \
            (b.num_src_nodes, b.num_dst_nodes)
        for x, y in zip(a.host_edges(), b.host_edges()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.host("edge_mask"),
                                      b.host("edge_mask"))
    jb2, _, _ = jds.deserialize_sample(buf)
    for a, b in zip(jb, jb2):
        np.testing.assert_array_equal(np.asarray(a.edge_mask),
                                      np.asarray(b.edge_mask))
    with pytest.raises(ValueError, match="not a sample"):
        deserialize_sample(tkv._pack(tkv.MSG_PUSH, "x"))


# ---------------------------------------------------------------------------
# key-value store (reference: tests/compute/test_kvstore.py)
# ---------------------------------------------------------------------------
def _kvstore_scenario(server_t, client_t, num_servers=2, num_clients=2):
    N, F = 40, 4
    book = (np.arange(N) >= N // 2).astype(np.int64)   # range partition
    shards = [np.zeros((N // 2, F), np.float32) for _ in range(num_servers)]

    def serve(i):
        sv = KVServer(i, num_clients, transport=server_t(i))
        sv.init_data("emb", shards[i], offset=i * (N // 2))
        sv.start()

    threads = [threading.Thread(target=serve, args=(i,), daemon=True)
               for i in range(num_servers)]
    for t in threads:
        t.start()
    clients = []

    def connect(i):
        c = KVClient(i, num_servers, transport=client_t(i))
        c.set_partition_book("emb", book)
        clients.append(c)
    cts = [threading.Thread(target=connect, args=(i,))
           for i in range(num_clients)]
    for t in cts:
        t.start()
    for t in cts:
        t.join(WAIT_S)
    clients.sort(key=lambda c: c.client_id)
    c0, c1 = clients
    c0.push("emb", np.array([0, 3, 25, 39, 3]), np.ones((5, F), np.float32))
    # a barrier ends only when every client is in it
    bt = threading.Thread(target=c1.barrier)
    bt.start()
    c0.barrier()
    bt.join(WAIT_S)
    got = c1.pull("emb", np.array([3, 25, 1]))
    np.testing.assert_allclose(got, np.array([[2.0], [1.0], [0.0]])
                               * np.ones(F))
    got2 = c0.pull("emb", np.array([39, 0, 39]))
    np.testing.assert_allclose(got2, np.ones((3, F)))
    for c in clients:
        c.shutdown()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()


def test_kvstore_loopback():
    st, ct = make_transports(2, 2, base_port=0)
    assert isinstance(st(0), LoopbackTransport)
    _run(lambda: _kvstore_scenario(*make_transports(2, 2, base_port=0)))


def test_kvstore_native_tcp():
    base = _free_block([0, 1, 100, 101])
    st, ct = make_transports(2, 2, base_port=base)
    _run(lambda: _kvstore_scenario(st, ct))


def test_netcomm_build_failure_raises_with_messages(tmp_path, monkeypatch):
    bad = tmp_path / "netcomm.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "NET_SRC", bad)
    with pytest.raises(RuntimeError, match="netcomm.cpp.*did not build"
                       r"(.|\n)*error"):
        native.build_net_library(tmp_path / "build")


def test_kvstore_fastpull_local_shard():
    """FastPull: a co-located shard is read without a network round
    trip."""
    def body():
        st, ct = make_transports(1, 1)
        N, F = 10, 2
        shard = np.arange(N * F, dtype=np.float32).reshape(N, F)
        sv = KVServer(0, 1, transport=st(0))
        sv.init_data("x", shard.copy())
        th = threading.Thread(target=sv.start, daemon=True)
        th.start()
        c = KVClient(0, 1, transport=ct(0))
        c.set_partition_book("x", np.zeros(N, np.int64))
        c.set_local_shard("x", 0, shard)
        np.testing.assert_allclose(c.pull("x", np.array([2, 7])),
                                   shard[[2, 7]])
        c.shutdown()
        th.join(WAIT_S)
        assert not th.is_alive()
    _run(body)


def test_kvstore_custom_push_handler():
    """The KGEServer pattern (reference: apps/kg/kvserver.py:35): an
    overridden push handler, a scaled Adagrad-style update, equal to the
    JAX store's under the same pushes."""
    jkv = _jax()[3]
    def make(base_cls):
        class AdaServer(base_cls):
            def _push_handler(self, name, local_ids, data):
                state = self._data[name + "_state"]
                np.add.at(state, local_ids, (data ** 2).sum(-1))
                scale = 1.0 / np.sqrt(state[local_ids] + 1e-10)
                np.add.at(self._data[name], local_ids,
                          -0.1 * data * scale[:, None])
        return AdaServer

    def run(mod, server_cls, client_cls):
        st, ct = mod.make_transports(1, 1)
        N, F = 6, 3
        sv = make(server_cls)(0, 1, transport=st(0))
        sv.init_data("w", np.zeros((N, F), np.float32))
        sv.init_data("w_state", np.zeros(N, np.float32))
        th = threading.Thread(target=sv.start, daemon=True)
        th.start()
        c = client_cls(0, 1, transport=ct(0))
        c.set_partition_book("w", np.zeros(N, np.int64))
        g = np.arange(1, 7, dtype=np.float32).reshape(2, F)
        c.push("w", np.array([1, 4]), g)
        c.push("w", np.array([4, 4]), g)
        c.barrier()
        got = c.pull("w", np.array([1, 4, 0]))
        c.shutdown()
        th.join(WAIT_S)
        return got
    out = {}
    _run(lambda: out.setdefault("port", run(tkv, KVServer, KVClient)))
    _run(lambda: out.setdefault("jax", run(jkv, jkv.KVServer,
                                           jkv.KVClient)))
    assert np.all(out["port"][:2] < 0) and not out["port"][2].any()
    np.testing.assert_array_equal(out["port"], out["jax"])


# ---------------------------------------------------------------------------
# sampler service (reference: tests/compute/test_dis_sampler.py)
# ---------------------------------------------------------------------------
def test_sampler_service_end_to_end():
    """Two sampler threads stream batches to one trainer over TCP."""
    rng = np.random.default_rng(1)
    g = dt.graph((rng.integers(0, 40, 200), rng.integers(0, 40, 200)),
                 num_nodes=40)
    base = _free_block([0, 2, 3])
    got = []

    def body():
        holder = {}

        def trainer_setup():
            holder["r"] = SamplerReceiver(
                NativeTransport(0, base, [], num_inbound=2), num_senders=2)
        rt = threading.Thread(target=trainer_setup)
        rt.start()

        def work(i):
            sampler = MultiLayerNeighborSampler([2], seed=i)
            sender = SamplerSender(NativeTransport(
                i, base + 1 + i, [("127.0.0.1", base)], num_inbound=0))
            for k in range(3):
                blocks, inp, seeds = sampler.sample_blocks(
                    g, np.arange(4 * k, 4 * k + 4))
                sender.send(blocks, inp, seeds)
            sender.signal_end()
        pool = SamplerPool(2, lambda i: work(i + 1))
        pool.start()
        rt.join(WAIT_S)
        got.extend(holder["r"])
        pool.join(WAIT_S)
        holder["r"].close()
    _run(body)
    assert len(got) == 6
    for blocks, inp, seeds in got:
        assert len(blocks) == 1 and seeds.shape == (4,)
        assert blocks[0].num_dst_nodes == 4


def _sampler_worker(worker_id):
    # runs in a spawned process: rebuild the graph, sample, stream, signal
    base = int(os.environ["DGL_TPU_TEST_SAMPLER_PORT"])
    out_dir = os.environ["DGL_TPU_TEST_SAMPLER_DIR"]
    with open(os.path.join(out_dir, f"w{worker_id}.json"), "w") as f:
        json.dump({"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "cuda_initialized": torch.cuda.is_initialized(),
                   "devices": torch.cuda.device_count()}, f)
    rng = np.random.default_rng(worker_id)
    g = dt.graph((rng.integers(0, 50, 300).astype(np.int32),
                  rng.integers(0, 50, 300).astype(np.int32)), num_nodes=50)
    sampler = MultiLayerNeighborSampler([2, 2], replace=True,
                                        seed=worker_id)
    snd = SamplerSender(NativeTransport(
        worker_id, base + 10 + worker_id, [("127.0.0.1", base)],
        num_inbound=0))
    for start in range(0, 20, 10):
        snd.send(*sampler.sample_blocks(g, np.arange(start, start + 10)))
    snd.signal_end()
    snd.close()


def test_sampler_pool_process_mode(monkeypatch, tmp_path):
    """Spawned samplers stream blocks over TCP to this process; each child
    ran with the card hidden and no CUDA context."""
    base = _free_block([0, 10, 11])
    monkeypatch.setenv("DGL_TPU_TEST_SAMPLER_PORT", str(base))
    monkeypatch.setenv("DGL_TPU_TEST_SAMPLER_DIR", str(tmp_path))
    pool = SamplerPool(2, _sampler_worker, mode="process")
    pool.start()
    # the senders retry their connects; the receiver waits for both
    recv_t = NativeTransport(0, base, [], num_inbound=2)
    samples = []
    _run(lambda: samples.extend(SamplerReceiver(recv_t, num_senders=2)),
         timeout=120)
    pool.join(timeout=WAIT_S)
    recv_t.close()
    assert [p.exitcode for p in pool.workers] == [0, 0]
    assert len(samples) == 4
    for blocks, input_nodes, seeds in samples:
        assert len(blocks) == 2 and seeds.shape == (10,)
        assert int(blocks[0].csc_indptr[-1]) == blocks[0].num_edges()
    for i in range(2):
        with open(tmp_path / f"w{i}.json") as f:
            assert json.load(f) == {"cuda_visible": "",
                                    "cuda_initialized": False,
                                    "devices": 0}
    with pytest.raises(ValueError, match="mode"):
        SamplerPool(1, _sampler_worker, mode="fork")


# ---------------------------------------------------------------------------
# 2 server + 2 client processes over TCP (tests/test_distributed_procs.py)
# ---------------------------------------------------------------------------
N_P, F_P = 40, 4


def _server_main(server_id, base_port, q):
    t = NativeTransport(server_id, base_port + server_id,
                        [("127.0.0.1", base_port + 100 + c)
                         for c in range(2)], num_inbound=2)
    sv = KVServer(server_id, 2, transport=t)
    sv.init_data("emb", np.zeros((N_P // 2, F_P), np.float32),
                 offset=server_id * (N_P // 2))
    sv.start()                      # returns after all clients shut down
    q.put(("server_done", server_id))


def _client_main(client_id, base_port, q):
    t = NativeTransport(client_id, base_port + 100 + client_id,
                        [("127.0.0.1", base_port + s) for s in range(2)],
                        num_inbound=2)
    c = KVClient(client_id, 2, transport=t)
    c.set_partition_book("emb", (np.arange(N_P) >= N_P // 2)
                         .astype(np.int64))
    if client_id == 0:
        c.push("emb", np.array([0, 3, 25, 39, 3]),
               np.ones((5, F_P), np.float32))
    c.barrier()
    q.put(("pull", client_id, c.pull("emb", np.array([3, 25, 1, 39]))))
    c.barrier()
    c.shutdown()


def test_kvstore_multiprocess():
    """A push from one client process is visible to the other after a
    barrier; pulls across both server processes route right."""
    ctx = mp.get_context("spawn")
    base = _free_block([0, 1, 100, 101])
    q = ctx.Queue()
    procs = [ctx.Process(target=_server_main, args=(i, base, q),
                         daemon=True) for i in range(2)]
    procs += [ctx.Process(target=_client_main, args=(i, base, q),
                          daemon=True) for i in range(2)]
    for p in procs:
        p.start()
    pulls, server_done = {}, 0
    try:
        for _ in range(4):
            msg = q.get(timeout=120)
            if msg[0] == "pull":
                pulls[msg[1]] = msg[2]
            else:
                server_done += 1
        for p in procs:
            p.join(timeout=WAIT_S)
            assert p.exitcode == 0, p
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert server_done == 2 and set(pulls) == {0, 1}
    for got in pulls.values():
        np.testing.assert_allclose(got[:, 0], [2.0, 1.0, 0.0, 1.0])


# ---------------------------------------------------------------------------
# feature store and the shared graph structure
# ---------------------------------------------------------------------------
def test_feature_store_pull_push(tmp_path):
    jfs = _jax()[2]
    rng = np.random.default_rng(0)
    fs = FeatureStore({"emb": rng.normal(size=(20, 4)).astype(np.float32)})
    rows = np.array([3, 7, 3])
    np.testing.assert_allclose(fs.pull("emb", rows, to_device=False),
                               fs["emb"][rows])
    t = fs.pull("emb", rows, device="cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), fs["emb"][rows])
    before = fs["emb"][3].copy()
    fs.push_add("emb", np.array([3, 3]), torch.ones((2, 4)))
    np.testing.assert_allclose(fs["emb"][3], before + 2.0, rtol=1e-6)
    paths = fs.save(str(tmp_path / "store"))
    # the JAX store maps the port's files, and the other way round
    fs2 = FeatureStore.from_mmap(paths)
    np.testing.assert_array_equal(np.asarray(fs2["emb"]), fs["emb"])
    np.testing.assert_array_equal(
        np.asarray(jfs.FeatureStore.from_mmap(paths)["emb"]), fs["emb"])
    with pytest.raises(ValueError, match="read-only"):
        fs2.push_add("emb", rows[:1], np.ones((1, 4)))


def _shared_graph_worker(args):
    prefix, seeds = args
    from dgl_hack_tpu_torch.sampling import sample_neighbors
    g = attach_shared_graph(prefix)
    assert not g.host("src").flags.writeable     # a map, not a copy
    frontier, eids = sample_neighbors(g, seeds, 3, replace=True,
                                      rng=np.random.default_rng(0))
    fs, fd = frontier.host_edges()
    return np.asarray(fs), np.asarray(fd), np.asarray(eids)


def test_shared_graph_multiprocess_and_across_packages(tmp_path):
    """The parent saves the structure once; spawned workers attach it by
    map and sample as the parent does.  The JAX package attaches the
    port's files to the same arrays, and the port the JAX package's."""
    from dgl_hack_tpu_torch.sampling import sample_neighbors
    jdgl, _, jfs, _, _ = _jax()
    rng = np.random.default_rng(0)
    src = rng.integers(0, 80, 600).astype(np.int32)
    dst = rng.integers(0, 80, 600).astype(np.int32)
    g = dt.graph((src, dst), num_nodes=80)
    prefix = str(tmp_path / "g")
    save_shared_graph(prefix, g)
    seeds = np.arange(20)
    ctx = mp.get_context("spawn")
    with ctx.Pool(2) as pool:
        results = pool.map_async(_shared_graph_worker,
                                 [(prefix, seeds)] * 2).get(120)
    ref_f, ref_e = sample_neighbors(g, seeds, 3, replace=True,
                                    rng=np.random.default_rng(0))
    rs, rd = ref_f.host_edges()
    for fs, fd, eids in results:
        np.testing.assert_array_equal(fs, rs)
        np.testing.assert_array_equal(fd, rd)
        np.testing.assert_array_equal(eids, ref_e)
    jg = jfs.attach_shared_graph(prefix)
    jdgl_g = jdgl.graph((src, dst), num_nodes=80)
    jfs.save_shared_graph(str(tmp_path / "j"), jdgl_g)
    tg = attach_shared_graph(str(tmp_path / "j"))
    for f in ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids",
              "int2user", "user2int"):
        np.testing.assert_array_equal(jg.host(f), g.host(f))
        np.testing.assert_array_equal(tg.host(f), g.host(f))
        np.testing.assert_array_equal(getattr(tg, f).numpy(), g.host(f))


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------
def test_read_ip_config(tmp_path):
    p = tmp_path / "ip_config.txt"
    p.write_text("10.0.0.1 30050 1\n10.0.0.2 30050 1\n\n")
    assert read_ip_config(str(p)) == [("10.0.0.1", 30050),
                                      ("10.0.0.2", 30050)]


def test_initialize_from_env_without_variables(monkeypatch):
    for k in ("DGL_TPU_COORDINATOR", "DGL_TPU_NUM_PROC", "DGL_TPU_PROC_ID",
              "DGL_TPU_IP_CONFIG"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()


_GROUP_CHILD = """
import torch, torch.distributed as dist
from dgl_hack_tpu_torch.distributed import initialize_from_env
assert initialize_from_env(device="cpu")
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)
print(dist.get_backend(), dist.get_world_size(), float(x))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("how", ["env", "ip_config"])
def test_initialize_from_env_gloo_group(how, tmp_path):
    """Two processes form a gloo group from the variables (or from an
    ip_config file) and all-reduce."""
    port = _free_block([0])
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
                   DGL_TPU_PROC_ID=str(rank))
        if how == "env":
            env.update(DGL_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DGL_TPU_NUM_PROC="2")
        else:
            cfg = tmp_path / "ip_config.txt"
            cfg.write_text(f"127.0.0.1 {port} 1\n127.0.0.1 {port + 1} 1\n")
            env.update(DGL_TPU_IP_CONFIG=str(cfg))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GROUP_CHILD], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs == [["gloo", "2", "3.0"]] * 2
