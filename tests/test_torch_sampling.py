"""Neighbor sampling, ``to_block``, the loaders and the sampled GraphSAGE
example twin in the PyTorch port, against the JAX package.

The sampler tests run on two paths of the uniform pick (``sampler_path``):
``native``, both packages' native samplers (the JAX library must have
loaded), and ``plain``, the port's plain numpy version
(``neighbor._pick_uniform_plain``) against the JAX numpy fallback, which
runs when ``dgl_hack_tpu.native.rowwise_sample_native`` returns None
(made so here; nothing in the JAX package is edited).  Each test counts
the calls of each side's path and pins them.  On either path one seed
must give the same blocks in both packages: edges, masks, permutations,
``src_ids`` and ``_ID``, bit for bit.  The bipartite layers on these
blocks are in test_torch_bipartite.py; GraphSAGE over blocks draws them
natively.

GraphSAGE over blocks drawn with replacement (as the example draws them;
repeated picks tie in a max) comes from the JAX parameters
(``interop``); the JAX side of the pool aggregator runs on
``prepare_spmm``'d blocks, its mask-aware Pallas plans in interpret
mode, which give ties the full cotangent as the port's K5 does, and
agrees to 1e-4 of max|ref| (the Pallas plans' sums).

The twin's loop trains a few CPU steps at the example's widths; its loss
must fall (the mean of the last three losses below that of the first
three).
"""
import contextlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
import dgl_hack_tpu.native
from dgl_hack_tpu import sampling as jsampling
from dgl_hack_tpu.core.transform import to_block as jto_block
from dgl_hack_tpu.models import GraphSAGE as JGraphSAGE

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import sampling as tsampling
from dgl_hack_tpu_torch.data import synthetic_reddit
from dgl_hack_tpu_torch.interop import (dense_module_names,
                                        flax_to_state_dict,
                                        state_dict_to_flax)
from dgl_hack_tpu_torch.models import GraphSAGE
from dgl_hack_tpu_torch.sampling import neighbor as tneighbor

torch.set_num_threads(2)

PREPARED_TOL = 1e-4
N, E = 300, 2400
ROOT = pathlib.Path(__file__).resolve().parents[1]
STRUCT = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids", "int2user",
          "user2int", "edge_mask")


@pytest.fixture(autouse=True)
def _highest_precision(monkeypatch):
    """Pallas at full f32 precision."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")


class PathCalls:
    """Calls of each package's uniform-pick path under ``pinned_paths``."""

    def __init__(self, path):
        self.path = path
        self.counts = {"jax_native": 0, "jax_numpy": 0, "port_native": 0,
                       "port_plain": 0}

    def check(self, uniform=True):
        """Each side took ``path`` as often as the other, at least once,
        and never the other path; with ``uniform=False`` neither took
        either (taking all in-edges, weighted picks)."""
        c = self.counts
        mine = ("jax_native", "port_native") if self.path == "native" \
            else ("jax_numpy", "port_plain")
        n = c[mine[0]]
        assert c[mine[1]] == n and (n > 0) == uniform, c
        assert all(v == 0 for k, v in c.items() if k not in mine), c


@contextlib.contextmanager
def pinned_paths(path):
    """Run both packages' uniform picks on ``path`` ('native' or 'plain'),
    counting each side's calls (``PathCalls``)."""
    calls = PathCalls(path)
    jax_native = dgl_hack_tpu.native.rowwise_sample_native
    port_native = tneighbor.rowwise_sample_native
    port_plain = tneighbor._pick_uniform_plain

    def jax_pick(*args, **kwargs):
        if path == "plain":
            calls.counts["jax_numpy"] += 1
            return None
        calls.counts["jax_native"] += 1
        res = jax_native(*args, **kwargs)
        assert res is not None, "the JAX native sampler did not load"
        return res

    def port_native_pick(*args, **kwargs):
        calls.counts["port_native"] += 1
        return port_native(*args, **kwargs)

    def port_plain_pick(*args, **kwargs):
        calls.counts["port_plain"] += 1
        return port_plain(*args, **kwargs)

    if path == "native":
        assert dgl_hack_tpu.native.get_lib() is not None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dgl_hack_tpu.native, "rowwise_sample_native", jax_pick)
        mp.setattr(tneighbor, "rowwise_sample_native", port_native_pick)
        if path == "plain":
            mp.setattr(tneighbor, "_pick_uniform", port_plain_pick)
        yield calls


@pytest.fixture(params=["native", "plain"])
def sampler_path(request):
    with pinned_paths(request.param) as calls:
        yield calls


@pytest.fixture
def native_path():
    """Both packages on their native samplers, the paths pinned."""
    with pinned_paths("native") as calls:
        yield calls


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _edges(seed=0):
    """A graph of distinct (src, dst) pairs in user order other than CSC,
    nodes 290.. without in-edges, and in-degrees from 0 to about 20."""
    rng = np.random.default_rng(seed)
    pair = rng.choice(N * (N - 10), E, replace=False)
    return pair // (N - 10), pair % (N - 10)


@pytest.fixture(scope="module")
def graphs():
    src, dst = _edges()
    return dgl.graph((src, dst), num_nodes=N), dt.graph((src, dst),
                                                         num_nodes=N)


def assert_same_graph(jg, tg, what=""):
    assert (jg.num_src_nodes, jg.num_dst_nodes, jg.is_block) == \
        (tg.num_src_nodes, tg.num_dst_nodes, tg.is_block), what
    for name in STRUCT:
        jv = getattr(jg, name)
        if jv is None:
            assert getattr(tg, name) is None, (what, name)
        else:
            np.testing.assert_array_equal(tg.host(name), np.asarray(jv),
                                          err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
SAMPLE_CASES = [("all", -1, False, False), ("replace", 6, True, False),
                ("weighted_replace", 6, True, True),
                ("no_replace", 4, False, False),
                ("weighted_no_replace", 4, False, True)]


@pytest.mark.parametrize("case,fanout,replace,weighted", SAMPLE_CASES)
def test_sample_neighbors_matches_jax(graphs, sampler_path, case, fanout,
                                      replace, weighted):
    gj, gt = graphs
    rng = np.random.default_rng(1)
    seeds = np.concatenate([rng.choice(N - 10, 40, replace=False),
                            [N - 3, N - 1]])         # no in-edges
    prob = rng.uniform(0.1, 1.0, E) if weighted else None
    rj, rt = np.random.default_rng(2), np.random.default_rng(2)
    fj, ej = jsampling.sample_neighbors(gj, seeds, fanout, replace=replace,
                                        prob=prob, rng=rj, device=False)
    ft, et = tsampling.sample_neighbors(gt, seeds, fanout, replace=replace,
                                        prob=prob, rng=rt)
    assert_same_graph(fj, ft, case)
    np.testing.assert_array_equal(et, ej)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)   # same draws
    if fanout > 0:
        per_seed = np.bincount(ft.host_edges()[1], minlength=N)[seeds]
        assert per_seed.max() <= fanout
    sampler_path.check(uniform=fanout >= 0 and not weighted)


TO_BLOCK_CASES = {
    "duplicate_dst": dict(dst=[5, 9, 5, 0, 0, 17], pad_num_src=256,
                          pad_num_edges=200),
    "exact_fit": dict(dst=None, pad_num_src=None, pad_num_edges="exact"),
    "no_padding": dict(dst=None, pad_num_src=None, pad_num_edges=None),
    "src_not_from_dst": dict(dst=None, pad_num_src=None, pad_num_edges=None,
                             include_dst_in_src=False)}


@pytest.mark.parametrize("case", sorted(TO_BLOCK_CASES))
def test_to_block_matches_jax(graphs, sampler_path, case):
    """Repeated dst ids keep the last place in both maps; padding carries
    a mask and the permutations, even at an exact fit."""
    gj, gt = graphs
    kw = dict(TO_BLOCK_CASES[case])
    seeds = np.arange(0, 60, 3) if kw["dst"] is None else \
        np.asarray(kw["dst"])
    kw.pop("dst")
    fj, _ = jsampling.sample_neighbors(gj, seeds, 5, rng=np.random.
                                       default_rng(3), device=False)
    ft, _ = tsampling.sample_neighbors(gt, seeds, 5, rng=np.random.
                                       default_rng(3))
    if kw["pad_num_edges"] == "exact":
        kw["pad_num_edges"] = ft.num_edges()
    bj, sj, dj = jto_block(fj, seeds, device=False, **kw)
    bt, st, dtt = dt.to_block(ft, seeds, **kw)
    assert_same_graph(bj, bt, case)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(dtt, dj)
    assert (bt.edge_mask is not None) == (kw["pad_num_edges"] is not None)
    if case == "exact_fit":
        assert bool(bt.edge_mask.all()) and bt.int2user is not None
    sampler_path.check()


def _loader_pair(graphs, replace, fanouts=(3, 5), batch_size=64,
                 nids=None):
    gj, gt = graphs
    nids = np.arange(0, N, 2) if nids is None else nids   # 150: 3 batches
    lj = jsampling.NodeDataLoader(
        gj, nids, jsampling.MultiLayerNeighborSampler(fanouts, replace,
                                                      seed=4),
        batch_size, seed=5)
    lt = tsampling.NodeDataLoader(
        gt, nids, tsampling.MultiLayerNeighborSampler(fanouts, replace,
                                                      seed=4),
        batch_size, seed=5)
    return lj, lt


@pytest.mark.parametrize("replace", [True, False])
def test_node_loader_blocks_match_jax(graphs, sampler_path, replace):
    """Every minibatch of a padded multi-layer sampler, the last one padded
    with repeated seeds: blocks, masks, input nodes, seeds and _ID."""
    lj, lt = _loader_pair(graphs, replace)
    assert len(lt) == len(lj) == 3
    batches = 0
    for (ij, sj, bj), (it, st, bt) in zip(lj, lt):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(st, sj)
        assert len(st) == 64
        for k, (blj, blt) in enumerate(zip(bj, bt)):
            assert_same_graph(blj, blt, f"block {k}")
            assert blt.edge_mask is not None
            np.testing.assert_array_equal(blt.edata["_ID"].numpy(),
                                          np.asarray(blj.edata["_ID"]))
        batches += 1
    assert batches == 3
    # layer 0's dst set is layer 1's padded src set, zeros included
    assert bt[0].num_dst_nodes == bt[1].num_src_nodes
    sampler_path.check()
    assert sampler_path.counts["jax_" + ("native" if sampler_path.path ==
                                         "native" else "numpy")] == 6


def test_select_topk_and_layer_sampler_match_jax(graphs):
    gj, gt = graphs
    rng = np.random.default_rng(6)
    weight = rng.normal(size=E)
    nodes = rng.choice(N, 30, replace=False)
    fj, ej = jsampling.select_topk(gj, 3, weight, nodes)
    ft, et = tsampling.select_topk(gt, 3, weight, nodes)
    np.testing.assert_array_equal(np.asarray(fj.src), ft.host("src"))
    np.testing.assert_array_equal(np.asarray(fj.dst), ft.host("dst"))
    np.testing.assert_array_equal(et, ej)
    fj, ej = jsampling.sample_layer_neighbors(gj, nodes, 25,
                                              np.random.default_rng(7))
    ft, et = tsampling.sample_layer_neighbors(gt, nodes, 25,
                                              np.random.default_rng(7))
    np.testing.assert_array_equal(np.asarray(fj.src), ft.host("src"))
    np.testing.assert_array_equal(np.asarray(fj.dst), ft.host("dst"))
    np.testing.assert_array_equal(et, ej)
    assert len(np.unique(ft.host("src"))) <= 25


def test_edge_and_negative_samplers_match_jax(graphs):
    gj, gt = graphs
    for mode in ("head", "tail"):
        bj = list(jsampling.EdgeSampler(gj, 100, neg_sample_size=7,
                                        chunk_size=16, negative_mode=mode,
                                        seed=8))
        bt = list(tsampling.EdgeSampler(gt, 100, neg_sample_size=7,
                                        chunk_size=16, negative_mode=mode,
                                        seed=8))
        assert len(bt) == len(bj) == E // 100
        for a, b in zip(bt, bj):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(tsampling.uniform_negative_edges(
            N, 50, np.random.default_rng(9)), jsampling.uniform_negative_edges(
            N, 50, np.random.default_rng(9))):
        np.testing.assert_array_equal(a, b)
    nt = tsampling.ChunkedNegativeSampler(5, 8, "head", seed=10).sample(
        30, N)
    nj = jsampling.ChunkedNegativeSampler(5, 8, "head", seed=10).sample(
        30, N)
    assert nt.shape == (4, 5)
    np.testing.assert_array_equal(nt, nj)
    with pytest.raises(ValueError, match="head"):
        tsampling.ChunkedNegativeSampler(5, 8, "both")


def test_graph_loader_matches_jax():
    rng = np.random.default_rng(11)
    sizes = rng.integers(3, 9, 10)
    edges = [(rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n))
             for n in sizes]
    feats = [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]
    labels = rng.integers(0, 3, 10)
    lj = jsampling.GraphDataLoader(
        [dgl.graph(e, num_nodes=int(n)) for e, n in zip(edges, sizes)],
        feats, labels, 4, seed=12)
    lt = tsampling.GraphDataLoader(
        [dt.graph(e, num_nodes=int(n)) for e, n in zip(edges, sizes)],
        feats, labels, 4, seed=12)
    assert len(lt) == len(lj) == 2
    for (gj_, xj, yj), (gt_, xt, yt) in zip(lj, lt):
        np.testing.assert_array_equal(gt_.host("src"), np.asarray(gj_.src))
        np.testing.assert_array_equal(gt_.host("dst"), np.asarray(gj_.dst))
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


# ---------------------------------------------------------------------------
# GraphSAGE over blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("agg", ["mean", "gcn", "pool", "lstm"])
def test_graphsage_over_blocks_matches_jax(graphs, native_path, agg):
    """Logits and parameter gradients of the block-list GraphSAGE from the
    JAX parameters, on one minibatch drawn with replacement; pool against
    the JAX prepared blocks (ties), mean, gcn and lstm (the mailbox of the
    padded blocks) against the bare ones."""
    lj, lt = _loader_pair(graphs, True, batch_size=48)
    (ij, sj, bj), (it, st, bt) = next(iter(lj)), next(iter(lt))
    native_path.check()
    if agg == "pool":
        bj = [dgl.prepare_spmm(b, te=256, bc=8, wc=2) for b in bj]
    feats = np.random.default_rng(15).normal(size=(N, 9)).astype(np.float32)
    jm = JGraphSAGE(8, 4, num_layers=2, aggregator_type=agg)
    x = jnp.asarray(feats[it])
    params = jm.init(jax.random.PRNGKey(16), bj, x)
    cot = np.random.default_rng(17).normal(size=(48, 4)).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, cot):
        out, vjp = jax.vjp(lambda q: jm.apply(q, bj, x), p)
        return out, vjp(cot)[0]
    ref, gp = fwd_bwd(params, jnp.asarray(cot))
    pm = GraphSAGE(8, 4, num_layers=2, aggregator_type=agg)
    pm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    pm.eval()
    out = pm(bt, torch.from_numpy(feats[it]))
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (48, 4)
    assert_close(out.detach().numpy(), ref, PREPARED_TOL, "logits")
    want = flax_to_state_dict(_np_tree(gp))
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name, grad in got.items():
        assert_close(grad.numpy(), want[name].numpy(), PREPARED_TOL, name)
    back = state_dict_to_flax(pm.state_dict(), dense_module_names(pm))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np_tree(params))


# ---------------------------------------------------------------------------
# the example twin
# ---------------------------------------------------------------------------
def _twin():
    spec = importlib.util.spec_from_file_location(
        "train_sage_sampling_torch",
        ROOT / "examples" / "train_sage_sampling_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("agg", ["mean", "pool", "lstm"])
def test_twin_trains_on_cpu(agg):
    """A few CPU steps of the example's loop at its widths (602 features,
    hidden 16, 41 classes) on a small synthetic Reddit: the loss falls."""
    ds = synthetic_reddit(num_nodes=1200)
    res = _twin().train(ds, fanouts=(4, 5), batch_size=32, num_epochs=2,
                        max_steps=12, eval_batches=2, aggregator=agg,
                        device="cpu", log=None)
    losses = res["losses"]
    assert res["steps"] == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert set(res["times"]) == {"sample_ms", "copy_ms", "plan_ms",
                                 "step_ms"}
    assert all(len(v) == 12 for v in res["times"].values())
    assert res["test_nodes"] == 64 and 0.0 <= res["test_acc"] <= 1.0


def _start_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" /
                             "train_sage_sampling_torch.py"), *args],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def test_twin_cli_on_cpu_and_without_card():
    """--device cpu prints the JAX example's JSON line; without a card and
    without --device cpu the CLI refuses.  The two runs start together."""
    run = _start_cli("--device", "cpu", "--reddit-scale", "0.004",
                     "--num-epochs", "1", "--batch-size", "64",
                     "--fan-out", "3,4")
    refused = _start_cli("--num-epochs", "1")
    out, err = run.communicate(timeout=120)
    r_out, r_err = refused.communicate(timeout=120)
    assert run.returncode == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["dataset"] == "reddit-synth" and 0.0 <= res["test_acc"] <= 1
    assert refused.returncode != 0 and "--device cpu" in r_err
    assert not r_out.strip()
