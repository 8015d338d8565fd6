"""The port's example CLIs run end to end on the CPU when asked
(``--device cpu``) and print their one JSON line; without a card and
without ``--device cpu`` they refuse to run; their stand-in datasets are
the JAX package's.  The Tree-LSTM twin's first five losses agree with the
JAX example's loop (``pull`` per topological frontier, a UDF reduce over
the mailbox, Adam) from the same parameters to 1e-5 (relative), and the
PageRank twin with the JAX example's iteration to 1e-6."""
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
REFUSE_ARGS = {"pagerank_torch.py": ["--iters", "1"]}


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
