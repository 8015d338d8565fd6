"""The port's example CLIs run end to end on the CPU when asked
(``--device cpu``) and print their one JSON line; without a card and
without ``--device cpu`` they refuse to run; their stand-in datasets are
the JAX package's.  The Tree-LSTM twin's first five losses agree with the
JAX example's loop (``pull`` per topological frontier, a UDF reduce over
the mailbox, Adam) from the same parameters to 1e-5 (relative), and the
PageRank twin with the JAX example's iteration to 1e-6; the spatial
twin's first five losses (two spawned gloo ranks) the JAX example's loop
on a 2-device mesh, from its initial parameters, to 2e-5."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.core.message import pull as jpull
from dgl_hack_tpu.core.traversal import topological_nodes_generator
from dgl_hack_tpu.data import CoraGraphDataset

from dgl_hack_tpu_torch.data import CoraGraphDataset as TorchCora

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# tests/test_examples.py's arguments of the JAX KG example
KG_ARGS = ["--max_step", "120", "--kg-scale", "0.02", "--batch_size", "128",
           "--neg_sample_size", "32", "--neg_chunk_size", "16",
           "--hidden_dim", "32", "--eval_size", "200"]
KG_KEYS = {"dataset", "model", "train_time_s", "MRR", "MR", "HITS@1",
           "HITS@3", "HITS@10"}

CLI_CASES = [
    ("train_gcn_torch.py", ["--epochs", "3"]),
    ("train_gat_torch.py", ["--epochs", "3", "--dataset", "synth"]),
    ("train_transformer_torch.py", ["--epochs", "3", "--batch", "4",
                                    "--seq-len", "6"]),
    ("train_gin_torch.py", ["--epochs", "1"]),
    ("train_sgc_torch.py", ["--epochs", "3"]),
    ("train_appnp_torch.py", ["--epochs", "3"]),
    ("train_tagcn_torch.py", ["--epochs", "3"]),
    ("train_rgcn_torch.py", ["--epochs", "3"]),
    ("train_rgcn_hetero_torch.py", ["--epochs", "3"]),
    ("train_tree_lstm_torch.py", ["--epochs", "2", "--n_trees", "10"]),
    ("pagerank_torch.py", ["--n", "80", "--iters", "15"]),
    ("train_metapath2vec_torch.py", ["--epochs", "1"]),
    ("train_pinsage_rec_torch.py", ["--epochs", "3", "--users", "60",
                                    "--items", "50"]),
    ("train_sage_cv_torch.py", ["--epochs", "1"]),
    ("train_adaptive_sampling_torch.py", ["--epochs", "3"]),
    ("train_han_torch.py", ["--epochs", "3"]),
    ("train_capsule_torch.py", ["--epochs", "2", "--train", "64",
                                "--test", "32"]),
    ("train_graphwriter_torch.py", ["--epochs", "2", "--train", "16",
                                    "--test", "8"]),
    ("train_chem_torch.py", ["--epochs", "1", "--n_mols", "40"]),
    ("train_monet_torch.py", ["--epochs", "3"]),
    ("train_diffpool_torch.py", ["--epochs", "2"]),
    ("train_ggnn_torch.py", ["--epochs", "1", "--graphs", "10"]),
    ("train_dgi_torch.py", ["--epochs", "3", "--probe_epochs", "5"]),
    ("train_gcmc_torch.py", ["--epochs", "3"]),
    ("train_rrn_torch.py", ["--epochs", "3", "--batch", "8", "--steps",
                            "2"]),
    ("train_lgnn_torch.py", ["--epochs", "1", "--graphs", "5"]),
    ("train_pointcloud_torch.py", ["--epochs", "1", "--clouds", "9"]),
    ("train_cluster_gcn_torch.py", ["--epochs", "2", "--parts", "4"]),
    ("train_kg_torch.py", KG_ARGS),
    ("train_kg_dist_torch.py", ["--steps", "40", "--scale", "0.02",
                                "--batch", "128", "--neg", "16", "--chunk",
                                "16", "--eval_triples", "50"]),
    ("train_dgmg_torch.py", ["--epochs", "6", "--n_graphs", "12",
                             "--samples", "4"]),
    ("train_spatial_torch.py", ["--epochs", "3", "--parts", "2",
                                "--backend", "gloo", "--nodes", "600"]),
]
# the dataset name each CLI prints (the JAX twin's)
DATASETS = {"train_gin_torch.py": "SBM-mixture",
            "train_tagcn_torch.py": "synthetic",
            "train_rgcn_torch.py": "aifb",
            "train_rgcn_hetero_torch.py": "academic-synth"}
# the keys of the JSON line of each CLI whose line has no test_acc
OTHER_LINES = {
    "train_metapath2vec_torch.py": {"model", "epochs", "intra_sim",
                                    "inter_sim", "separation",
                                    "train_time_s"},
    "train_pinsage_rec_torch.py": {"dataset", "model", "hits10", "mrr",
                                   "train_time_s"}}
# the attention twins' lines: the JAX CLI's keys and its model's name
ATTENTION_LINES = {
    "train_han_torch.py": ({"model", "epochs", "test_acc", "train_time_s"},
                           "model", "HAN"),
    "train_capsule_torch.py": ({"example", "epochs", "loss", "test_acc",
                                "train_s"}, "example", "capsule"),
    "train_graphwriter_torch.py": ({"example", "epochs", "train_loss",
                                    "train_token_acc", "test_token_acc",
                                    "train_s"}, "example", "graphwriter")}
# the other twins' lines: the JAX CLI's keys and its fixed string values
# (every other value a finite number)
NAMED_LINES = {
    "train_chem_torch.py": (
        {"dataset", "model", "epochs", "test_acc", "train_time_s"},
        {"dataset": "tox21", "model": "gcn"}),
    "train_monet_torch.py": (
        {"model", "epochs", "test_acc", "train_time_s"}, {"model": "MoNet"}),
    "train_diffpool_torch.py": (
        {"model", "epochs", "test_acc", "train_time_s"},
        {"model": "DiffPool"}),
    "train_ggnn_torch.py": (
        {"dataset", "test_acc", "epochs", "loss"},
        {"dataset": "reachability-synth"}),
    "train_dgi_torch.py": (
        {"model", "epochs", "probe_test_acc", "train_time_s"},
        {"model": "DGI"}),
    "train_gcmc_torch.py": (
        {"model", "epochs", "test_acc", "test_rmse", "train_time_s"},
        {"model": "GCMC"}),
    "train_rrn_torch.py": (
        {"dataset", "model", "cell_acc", "train_time_s"},
        {"dataset": "sudoku4-synth", "model": "rrn"}),
    "train_lgnn_torch.py": (
        {"model", "epochs", "test_acc", "train_time_s"}, {"model": "LGNN"}),
    "train_pointcloud_torch.py": (
        {"model", "epochs", "test_acc", "train_time_s"},
        {"model": "DGCNN"}),
    "train_cluster_gcn_torch.py": (
        {"model", "parts", "epochs", "test_acc", "train_time_s"},
        {"model": "ClusterGCN", "parts": 4, "epochs": 2})}
SCRIPTS = [script for script, _ in CLI_CASES]
REFUSE_ARGS = {"pagerank_torch.py": ["--iters", "1"],
               "train_kg_torch.py": ["--max_step", "1"],
               "train_kg_dist_torch.py": ["--steps", "1"]}


def _start_example(script, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script),
                             *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def runs():
    """Every CLI run of this file, started together so that their start-up
    overlaps; ``runs(key)`` waits for one and gives (returncode, stdout,
    stderr)."""
    procs = {("cpu", script): _start_example(script, [*args, "--device",
                                                      "cpu"])
             for script, args in CLI_CASES}
    procs.update({("refuse", script): _start_example(
        script, REFUSE_ARGS.get(script, ["--epochs", "1"]))
        for script in SCRIPTS})
    done = {}

    def result(key):
        if key not in done:
            out, err = procs[key].communicate(timeout=120)
            done[key] = (procs[key].returncode, out, err)
        return done[key]
    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("script,args", CLI_CASES)
def test_example_cli(runs, script, args):
    rc, stdout, stderr = runs(("cpu", script))
    assert rc == 0, stderr
    out = json.loads(stdout.strip().splitlines()[-1])
    if script == "train_transformer_torch.py":
        assert (out["dataset"], out["model"]) == ("copy", "graph-transformer")
        assert 0.0 <= out["token_acc"] <= 1.0 and out["train_time_s"] >= 0
        return
    if script == "train_tree_lstm_torch.py":
        assert (out["model"], out["epochs"]) == ("ChildSumTreeLSTM", 2)
        assert 0.0 <= out["test_acc"] <= 1.0 and out["train_time_s"] >= 0
        return
    if script == "pagerank_torch.py":
        pv = _jax_pagerank(80, 600, 15, 0.85)
        assert out == {"model": "pagerank", "iters": 15,
                       "sum": round(float(pv.sum()), 4),
                       "top5": np.argsort(pv)[::-1][:5].tolist()}
        return
    if script == "train_kg_torch.py":
        # tests/test_examples.py:34's check, and the JAX CLI's keys
        assert set(out) == KG_KEYS
        assert (out["dataset"], out["model"]) == ("FB15k-synth", "TransE_l2")
        assert np.isfinite(out["MRR"]) and out["MRR"] > 0
        return
    if script == "train_kg_dist_torch.py":
        # tests/test_examples.py:118's checks
        assert out["num_servers"] == 2 and out["num_clients"] == 2
        assert out["loss_last10"] < 0.5 * out["loss_first10"]
        assert out["mrr"] > 0.5
        return
    if script == "train_dgmg_torch.py":
        # tests/test_examples.py:139's checks
        assert set(out) == {"model", "epochs", "nll_first", "nll_last",
                            "sample_valid_frac", "train_time_s"}
        assert out["nll_last"] < out["nll_first"]
        assert np.isfinite(out["nll_last"])
        assert 0.0 <= out["sample_valid_frac"] <= 1.0
        return
    if script == "train_spatial_torch.py":
        # the JAX CLI's line
        assert set(out) == {"parts", "test_acc", "train_time_s", "loss"}
        assert out["parts"] == 2 and 0.0 <= out["test_acc"] <= 1.0
        assert np.isfinite(out["loss"]) and out["train_time_s"] > 0
        return
    if script in OTHER_LINES:
        assert set(out) == OTHER_LINES[script]
        assert out.get("model") in ("metapath2vec", "pinsage")
        assert all(np.isfinite(v) for k, v in out.items()
                   if k not in ("model", "dataset"))
        return
    if script in ATTENTION_LINES:
        keys, key, name = ATTENTION_LINES[script]
        assert set(out) == keys and out[key] == name
        assert all(np.isfinite(v) for k, v in out.items() if k != key)
        return
    if script in NAMED_LINES:
        keys, fixed = NAMED_LINES[script]
        assert set(out) == keys
        assert {k: out[k] for k in fixed} == fixed
        assert all(np.isfinite(v) for k, v in out.items() if k not in fixed)
        return
    if script == "train_sage_cv_torch.py":
        assert set(out) == {"dataset", "test_acc", "epochs", "loss"}
        assert out["dataset"] == "synthetic" and out["epochs"] == 1
        assert 0.0 <= out["test_acc"] <= 1.0 and np.isfinite(out["loss"])
        return
    assert out["dataset"] == DATASETS.get(script, "cora-synth")
    assert 0.0 <= out["test_acc"] <= 1.0 and out["train_time_s"] > 0


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_cli_refuses_without_card(runs, script):
    """--device defaults to cuda; with no card the CLI exits with an error
    naming --device cpu instead of running on the CPU."""
    rc, stdout, stderr = runs(("refuse", script))
    assert rc != 0
    assert "--device cpu" in stderr
    assert not stdout.strip()


def test_citation_standin_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    with pytest.warns(UserWarning):
        dj = CoraGraphDataset()
    with pytest.warns(UserWarning):
        dtt = TorchCora()
    assert dj.name == dtt.name
    for name in ("features", "labels", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(dj, name), getattr(dtt, name))
    np.testing.assert_array_equal(np.asarray(dj.graph.src),
                                  dtt.graph.src.numpy())


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_pagerank(n, edges, iters, damp):
    """examples/pagerank.py's loop, unjitted, on its graph."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, edges).astype(np.int32)
    dst = rng.integers(0, n, edges).astype(np.int32)
    g = dgl.graph((src, dst), num_nodes=n)
    deg = jnp.maximum(g.out_degrees().astype(jnp.float32), 1.0)
    pv = jnp.full((n, 1), 1.0 / n)
    for _ in range(iters):
        agg = dgl.gspmm(g, "copy_lhs", "sum", pv / deg[:, None])
        pv = (1 - damp) / n + damp * agg
    return np.asarray(pv[:, 0])


@pytest.mark.parametrize("masked", [False, True])
def test_pagerank_twin_matches_jax(masked):
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    mask = rng.random(2000) > 0.2 if masked else None
    gt = dt.graph((src, dst), num_nodes=300, edge_mask=mask)
    gj = dgl.graph((src, dst), num_nodes=300, edge_mask=mask)
    out = _twin("pagerank_torch").pagerank(gt, 12, 0.9).numpy()
    deg = jnp.maximum(gj.out_degrees().astype(jnp.float32), 1.0)
    pv = jnp.full((300, 1), 1.0 / 300)
    for _ in range(12):
        pv = 0.1 / 300 + 0.9 * dgl.gspmm(gj, "copy_lhs", "sum",
                                          pv / deg[:, None])
    np.testing.assert_allclose(out, np.asarray(pv[:, 0]), rtol=1e-6)


def _jax_tree_loss(params, g, tokens, root, label, frontiers):
    """examples/train_tree_lstm.py's run_tree and loss_fn (lines 88-119)."""
    H = params["U_f"].shape[0]
    x = params["emb"][tokens]
    g.ndata["iou"] = x @ params["W_iou"] + params["b_iou"]
    g.ndata["h"] = jnp.zeros((g.num_nodes(), H))
    g.ndata["c"] = jnp.zeros((g.num_nodes(), H))

    def message(edges):
        return {"mh": edges.src["h"], "mc": edges.src["c"]}

    def reduce(nodes):
        mh, mc = nodes.mailbox["mh"], nodes.mailbox["mc"]
        mask = nodes.mask[:, :, None]
        h_tilde = (mh * mask).sum(1)
        f = jax.nn.sigmoid(mh @ params["U_f"] + params["b_f"])
        c_acc = (f * mc * mask).sum(1)
        iou = nodes.data["iou"] + h_tilde @ params["U_iou"]
        i, o, u = jnp.split(jax.nn.sigmoid(iou), 3, axis=1)
        u = jnp.tanh(iou[:, 2 * H:])
        c = i * u + c_acc
        return {"h": o * jnp.tanh(c), "c": c}

    for f in frontiers:
        jpull(g, jnp.asarray(f, jnp.int32), message, reduce, max_degree=2)
    logits = g.ndata["h"][root] @ params["W_out"]
    return -jax.nn.log_softmax(logits)[label]


def test_tree_lstm_twin_matches_jax():
    """The same trees (same numpy seed) and parameters: the first five
    Adam steps' losses within 1e-5 (relative) of the JAX example's loop,
    and the trees' topological frontiers equal."""
    twin = _twin("train_tree_lstm_torch")
    trees = twin.make_trees(12, 6, 3)
    params = twin.init_params(6, 8, 3, seed=3)
    res = twin.train(trees, params, epochs=1, lr=1e-2, device="cpu",
                     max_steps=5)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    tx = optax.adam(1e-2)
    opt = tx.init(p)
    grad_fn = jax.jit(jax.value_and_grad(_jax_tree_loss),
                      static_argnums=(3, 4, 5))
    ref = []
    for gt, tokens, root, label, frontiers in trees[:5]:
        s, d = gt.host_edges()
        gj = dgl.graph((s, d), num_nodes=gt.num_nodes())
        assert tuple(tuple(int(v) for v in f) for f in
                     topological_nodes_generator(gj)) == frontiers
        loss, grads = grad_fn(p, gj, jnp.asarray(tokens), root, label,
                              frontiers)
        up, opt = tx.update(grads, opt)
        p = optax.apply_updates(p, up)
        ref.append(float(loss))
    np.testing.assert_allclose(res["losses"], ref, rtol=1e-5)
    assert res["steps"] == 5 and len(res["epoch_losses"]) == 1


@pytest.mark.parametrize("flag", ["--sparse_emb", "--async_update"])
def test_kg_cli_sparse_modes(flag):
    """tests/test_examples.py:88's check, for both sparse-row modes."""
    proc = _start_example("train_kg_torch.py", [*KG_ARGS, flag, "--device",
                                                "cpu"])
    try:
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    out = json.loads(stdout.strip().splitlines()[-1])
    assert set(out) == KG_KEYS
    assert np.isfinite(out["MRR"]) and out["MRR"] > 0


def _jax_kg_losses(ds, jm, mode, steps, B, N, S, lr):
    """examples/train_kg.py's loop (lines 53-106), its first ``steps``
    losses."""
    from dgl_hack_tpu.models import kg as jkg
    if mode == "dense":
        tx = optax.adagrad(lr)
        state = tx.init(jm.params)
        step = jkg.make_train_step(jm, tx, S)
    else:
        state = jkg.init_sparse_state(jm)
        step = jkg.make_sparse_train_step(jm, lr, S,
                                          async_update=mode == "async")
        if mode == "async":
            step, empty = step
    h, r, t = ds.train
    rng = np.random.default_rng(0)
    params = jm.params
    C = B // S
    pending = empty(B, (C, N), params["entity"].shape[1],
                    params["relation"].shape[1]) if mode == "async" else None
    losses = []
    for it in range(steps):
        sel = rng.integers(0, len(h), B)
        neg = rng.integers(0, ds.num_entities, (C, N)).astype(np.int32)
        batch = (jnp.asarray(h[sel]), jnp.asarray(r[sel]),
                 jnp.asarray(t[sel]), jnp.asarray(neg),
                 jnp.asarray(bool(it % 2)))
        if mode == "async":
            params, state, loss, pending = step(params, state, *batch,
                                                pending)
        else:
            params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("mode", ["dense", "sparse", "async"])
def test_kg_twin_matches_jax(mode):
    """The same stand-in KG, batches and tables (the JAX model's): the
    first five losses of each trainer within 1e-5 (relative) of the JAX
    example's loop."""
    from dgl_hack_tpu.data import synthetic_kg
    from dgl_hack_tpu.models import kg as jkg
    ds = synthetic_kg("FB15k", scale=0.005)
    jm = jkg.KEModel(ds.num_entities, ds.num_relations, 16, "TransE_l2",
                     gamma=19.9)
    ref = _jax_kg_losses(ds, jm, mode, 5, 32, 8, 8, 0.25)
    twin = _twin("train_kg_torch")
    res = twin.train(ds, "TransE_l2", 16, 19.9, 0.25, 32, 8, 8, 5,
                     sparse_emb=mode == "sparse",
                     async_update=mode == "async",
                     params={k: np.asarray(v) for k, v in jm.params.items()},
                     device="cpu", log=None)
    np.testing.assert_allclose(res["losses"], ref, rtol=1e-5)


def _jax_kg_dist_losses(ds, jm, steps, batch, neg, chunk, lr):
    """examples/train_kg_dist.py's servers and client loop (lines 59-184)
    with one client, whose order of pushes and pulls is then fixed."""
    import threading
    from dgl_hack_tpu.distributed import kvstore as jkv
    NE, S = ds.num_entities, 2
    ent0 = np.asarray(jm.params["entity"])
    rel0 = np.asarray(jm.params["relation"])
    bounds = np.linspace(0, NE, S + 1).astype(np.int64)
    ent_book = np.searchsorted(bounds[1:], np.arange(NE), side="right")
    rel_book = np.zeros(ds.num_relations, np.int64)

    class KGEServer(jkv.KVServer):
        def _local_ids(self, name, ids):
            base = name[:-5] if name.endswith("_grad") else name
            return super()._local_ids(base, ids)

        def _push_handler(self, name, local_ids, data):
            base = name[:-5]
            state = self._data[base + "_state"]
            np.add.at(state, local_ids, (data ** 2).mean(-1))
            scale = 1.0 / np.sqrt(state[local_ids] + 1e-10)
            np.add.at(self._data[base], local_ids,
                      -lr * data * scale[:, None])

    server_t, client_t = jkv.make_transports(S, 1, base_port=0)

    def serve(i):
        sv = KGEServer(i, 1, transport=server_t(i))
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        sv.init_data("entity", ent0[lo:hi].copy(), offset=lo)
        sv.init_data("entity_state", np.zeros(hi - lo, np.float32),
                     offset=lo)
        if i == 0:
            sv.init_data("relation", rel0.copy())
            sv.init_data("relation_state",
                         np.zeros(ds.num_relations, np.float32))
        sv.start()
    servers = [threading.Thread(target=serve, args=(i,), daemon=True)
               for i in range(S)]
    for t in servers:
        t.start()
    grad_fn = jax.jit(jax.value_and_grad(
        lambda h, r, t, n, nih: jm.loss_from_rows(h, r, t, n, nih, chunk),
        argnums=(0, 1, 2, 3)))
    h_all, r_all, t_all = ds.train
    rng = np.random.default_rng(100)
    client = jkv.KVClient(0, S, transport=client_t(0))
    for name, book in (("entity", ent_book), ("relation", rel_book)):
        client.set_partition_book(name, book)
        client.set_partition_book(name + "_grad", book)
    losses = []
    C = batch // chunk
    for step in range(steps):
        idx = rng.integers(0, len(h_all), batch)
        hb, rb, tb = h_all[idx], r_all[idx], t_all[idx]
        negs = rng.integers(0, NE, (C, neg)).astype(np.int64)
        rows = (client.pull("entity", hb), client.pull("relation", rb),
                client.pull("entity", tb),
                client.pull("entity", negs.reshape(-1)).reshape(C, neg, -1))
        val, (gh, gr, gt, gn) = grad_fn(*(jnp.asarray(x) for x in rows),
                                        bool(step % 2))
        losses.append(float(val))
        client.push("entity_grad", hb, np.asarray(gh))
        client.push("entity_grad", tb, np.asarray(gt))
        client.push("entity_grad", negs.reshape(-1),
                    np.asarray(gn).reshape(C * neg, -1))
        client.push("relation_grad", rb, np.asarray(gr))
    client.shutdown()
    for t in servers:
        t.join(timeout=30)
        assert not t.is_alive()
    return losses


def test_kg_dist_twin_matches_jax():
    """Two servers and one client (so that the order of pushes is fixed)
    from the JAX model's tables: the first five losses within 1e-5
    (relative) of the JAX example's loop."""
    from dgl_hack_tpu.data import synthetic_kg
    from dgl_hack_tpu.models import kg as jkg
    ds = synthetic_kg("FB15k", scale=0.005, seed=0)
    jm = jkg.KEModel(ds.num_entities, ds.num_relations, 16, "TransE_l2",
                     gamma=12.0)
    ref = _jax_kg_dist_losses(ds, jm, 5, 32, 8, 8, 0.1)
    res = _twin("train_kg_dist_torch").train(
        ds, "TransE_l2", 16, 12.0, 0.1, 32, 8, 8, 5, num_servers=2,
        num_clients=1, params={k: np.asarray(v)
                               for k, v in jm.params.items()},
        device="cpu")
    np.testing.assert_allclose(res["losses"][0], ref, rtol=1e-5)
    assert tuple(res["params"]["entity"].shape) == jm.params["entity"].shape


def test_dgmg_twin_matches_jax():
    """The same traces (the twin's ``make_traces`` against the JAX
    example's draws) and parameters (the JAX model's shapes, drawn from
    numpy): the first three Adam losses within 1e-5 (relative) of the JAX
    example's jitted step, vmapped over the traces."""
    from dgl_hack_tpu.models.dgmg import DGMG, build_action_trace
    from dgl_hack_tpu_torch.interop import flax_to_state_dict
    twin = _twin("train_dgmg_torch")
    sts, lbs = twin.make_traces(6)
    rng = np.random.default_rng(0)                 # the JAX example's draws
    for k in range(6):
        n = int(rng.integers(4, 9))
        src, dst = np.arange(n - 1), np.arange(1, n)
        bonds = np.zeros(n - 1, np.int64)
        if rng.random() < 0.5 and n > 3:
            src, dst = np.append(src, 0), np.append(dst, n - 1)
            bonds = np.append(bonds, 1)
        st, lb = build_action_trace(np.arange(n) % 2, src, dst, bonds, 50)
        np.testing.assert_array_equal(sts[k], st)
        np.testing.assert_array_equal(lbs[k], lb)
    jm = DGMG(n_node_types=2, n_bond_types=2, node_hidden_size=8,
              num_prop_rounds=2, max_nodes=10, max_edges=14)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(sts[0]), jnp.asarray(lbs[0])))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    params = jax.tree_util.tree_unflatten(tree, [
        (rng.standard_normal(x.shape) / np.sqrt(x.shape[0])).astype(
            np.float32) for x in leaves])
    tx = optax.adam(3e-3)

    @jax.jit
    def step(p, o):
        def loss_fn(p):
            return jax.vmap(lambda a, b: jm.apply(p, a, b))(
                jnp.asarray(sts), jnp.asarray(lbs)).mean()
        loss, grads = jax.value_and_grad(loss_fn)(p)
        up, o = tx.update(grads, o)
        return optax.apply_updates(p, up), o, loss
    p, o, ref = params, tx.init(params), []
    for _ in range(3):
        p, o, loss = step(p, o)
        ref.append(float(loss))
    model = twin.make_model(8, params=flax_to_state_dict(params),
                            device="cpu")
    res = twin.train(model, sts, lbs, epochs=3, lr=3e-3, device="cpu")
    np.testing.assert_allclose(res["losses"], ref, rtol=1e-5)


def test_spatial_twin_matches_jax():
    """examples/train_spatial.py's loop (plan, spatial GCN from
    PRNGKey(0), adam) on 2 of the 8 CPU devices, its first five losses,
    against the twin on 2 spawned gloo ranks from the same parameters,
    to 2e-5 relative: float32 sums in another order, which five Adam
    steps grow (the fifth read 1.0e-5 relative)."""
    from jax.sharding import Mesh
    from dgl_hack_tpu.data import planted_partition
    from dgl_hack_tpu.parallel import (build_spatial_plan, make_spatial_gcn,
                                       shard_features, spatial_train_step)
    twin = _twin("train_spatial_torch")
    parts, nodes, epochs, hidden, lr = 2, 600, 5, 32, 1e-2
    ds = planted_partition(nodes, 6, 64, avg_degree=8.0, homophily=0.88,
                           feat_noise=1.5, seed=0, train_per_class=40,
                           num_val=300, num_test=600)
    mesh = Mesh(np.asarray(jax.devices()[:parts]), ("node",))
    plan = build_spatial_plan(ds.graph, parts, method="fennel")
    dev = plan.device_arrays()
    init, forward = make_spatial_gcn(plan, mesh, hidden=hidden,
                                     out_feats=ds.num_classes)
    params = init(jax.random.PRNGKey(0), ds.features.shape[1])
    tx = optax.adam(lr)
    opt = tx.init(params)
    step = spatial_train_step(forward, tx)
    xs, ys, ms = (jnp.asarray(shard_features(plan, a)) for a in
                  (ds.features, ds.labels, ds.train_mask))
    ref = []
    p = params
    with mesh:
        for _ in range(epochs):
            p, opt, loss = step(p, opt, xs, dev, ys, ms)
            ref.append(float(loss))
    res, tplan, _ = twin.run(parts=parts, epochs=epochs, hidden=hidden,
                             nodes=nodes, lr=lr, device="cpu",
                             backend="gloo",
                             params=jax.tree.map(np.asarray, params),
                             timeout=120)
    np.testing.assert_array_equal(tplan.owned_ids, plan.owned_ids)
    np.testing.assert_allclose(res["losses"], ref, rtol=2e-5)
