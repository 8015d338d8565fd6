"""Heterographs in the PyTorch port against the JAX package on the CPU,
mirroring tests/test_heterograph.py: schema, update_all on one relation,
multi_update_all with every per-relation and cross-type reducer (forward
and the inputs' gradients), the conversions, batching, the API extras and
HeteroGraphConv from JAX parameters.  A reduce UDF per relation runs over
its mailbox, as in the JAX package (test_torch_message_udf.py holds its
gradients).

Tolerance: 1e-6 of max|ref| (f32 sums in another order); structure and
integer arrays bitwise.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
import dgl_hack_tpu.nn as jnn
from dgl_hack_tpu import fn as jfn

import dgl_hack_tpu_torch as dt
import dgl_hack_tpu_torch.nn as tnn
from dgl_hack_tpu_torch import fn as tfn
from dgl_hack_tpu_torch.interop import flax_to_state_dict
from test_torch_rgcn import jax_params

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
EDGES = {
    ("user", "follows", "user"): ([0, 1, 2, 3, 3], [1, 2, 3, 0, 1]),
    ("user", "plays", "game"): ([0, 1, 1, 3, 2], [0, 0, 1, 1, 1]),
    ("developer", "develops", "game"): ([0, 1], [0, 1]),
}


def assert_close(out, ref, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, f"{what}: rel err {err:.3g} > {TOL}"


def _pair(edges=EDGES, num_nodes=None):
    return dgl.heterograph(edges, num_nodes), dt.heterograph(edges,
                                                             num_nodes)


def _features(seed=0, width=3):
    rng = np.random.default_rng(seed)
    return {"user": rng.normal(size=(4, width)).astype(np.float32),
            "developer": rng.normal(size=(2, width)).astype(np.float32),
            "game": rng.normal(size=(2, width)).astype(np.float32)}


def test_schema_matches_jax():
    hj, ht = _pair()
    assert ht.ntypes == hj.ntypes
    assert ht.canonical_etypes == hj.canonical_etypes
    assert ht.etypes == hj.etypes
    for nt in hj.ntypes:
        assert ht.num_nodes(nt) == hj.num_nodes(nt)
    for c in hj.canonical_etypes:
        assert ht.num_edges(c[1]) == hj.num_edges(c[1])
        rj, rt = hj.relations[c], ht.relations[c]
        assert rt.is_block == rj.is_block
        for name in ("src", "dst", "csc_indptr"):
            np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                          np.asarray(getattr(rj, name)))
    assert ht.num_nodes() == hj.num_nodes() and ht.num_edges() == \
        hj.num_edges()
    assert ht.to_canonical_etype("develops") == \
        ("developer", "develops", "game")
    with pytest.raises(KeyError):
        ht.to_canonical_etype("owns")
    assert ht.to("cpu").canonical_etypes == ht.canonical_etypes


def test_update_all_single_etype_matches_jax():
    hj, ht = _pair()
    h = _features()["user"]
    hj.nodes_data("user")["h"] = jnp.asarray(h)
    ht.nodes_data("user")["h"] = torch.from_numpy(h)
    for hg, f in ((hj, jfn), (ht, tfn)):
        hg.update_all(f.copy_u("h", "m"), f.sum("m", "agg"), etype="plays")
        hg.update_all(f.copy_u("h", "m"), f.mean("m", "agg"),
                      etype="follows")
    for nt in ("game", "user"):
        assert_close(ht.nodes_data(nt)["agg"], hj.nodes_data(nt)["agg"], nt)
    with pytest.raises(ValueError, match="multi_update_all"):
        ht.update_all(tfn.copy_u("h", "m"), tfn.sum("m", "agg"))


def _multi(hg, f, reducer, cross, feats, udf_message):
    """multi_update_all over 'plays' and 'develops' into game and
    'follows' into user; returns (game, user) results."""
    hg = hg.local_var()
    for nt in ("user", "developer"):
        hg.nodes_data(nt)["h"] = feats[nt]
    if udf_message:
        def msg(edges):
            return {"m": edges.src["h"] * 2.0}
    else:
        msg = f.copy_u("h", "m")
    spec = (msg, getattr(f, reducer)("m", "agg"))
    hg.multi_update_all({"plays": spec, "develops": spec, "follows": spec},
                        cross)
    return hg.nodes_data("game")["agg"], hg.nodes_data("user")["agg"]


@pytest.mark.parametrize("udf_message", [False, True])
@pytest.mark.parametrize("reducer", ["sum", "mean", "max"])
@pytest.mark.parametrize("cross", ["sum", "mean", "max", "min", "stack"])
def test_multi_update_all_matches_jax(cross, reducer, udf_message):
    """Forward and the gradients of the src features (a distinct
    cotangent per output)."""
    hj, ht = _pair()
    feats = _features(1)
    cot = np.random.default_rng(2).normal(
        size=(2, 2, 3) if cross == "stack" else (2, 3)).astype(np.float32)

    def loss_j(fj):
        game, user = _multi(hj, jfn, reducer, cross, fj, udf_message)
        return (game * cot).sum() + (user[:2] * cot[:, :user.shape[1]]
                                     if cross == "stack" else
                                     user[:2] * cot).sum(), (game, user)
    fj = {k: jnp.asarray(v) for k, v in feats.items()}
    (_, (gj, uj)), grads = jax.value_and_grad(loss_j, has_aux=True)(fj)
    ft = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    game, user = _multi(ht, tfn, reducer, cross, ft, udf_message)
    loss = (game * torch.from_numpy(cot)).sum() + (
        user[:2] * torch.from_numpy(cot)[:, :user.shape[1]]
        if cross == "stack" else user[:2] * torch.from_numpy(cot)).sum()
    loss.backward()
    assert_close(game.detach(), gj, "game")
    assert_close(user.detach(), uj, "user")
    for nt in ("user", "developer"):
        assert_close(ft[nt].grad, grads[nt], f"d{nt}")


def test_multi_update_all_refuses_reduce_udf():
    """A reduce UDF per relation (it raised until the mailbox was ported)
    gives the JAX package's result; an unknown cross reducer still raises
    ``ValueError``.  Gradients and more cross reducers:
    test_torch_message_udf.py."""
    hj, ht = _pair()
    feats = _features(5)
    outs = {}
    for name, hg, f, conv in (("jax", hj, jfn, jnp.asarray),
                              ("torch", ht, tfn, torch.from_numpy)):
        hg.nodes_data("user")["h"] = conv(feats["user"])

        def udf_reduce(nodes):
            return {"agg": nodes.mailbox["m"].sum(1) + 1.0}
        hg.multi_update_all({"plays": (f.copy_u("h", "m"), udf_reduce)},
                            "sum")
        outs[name] = np.asarray(hg.nodes_data("game")["agg"])
    assert_close(outs["torch"], outs["jax"])
    with pytest.raises(ValueError, match="cross reducer"):
        ht.multi_update_all({"plays": (tfn.copy_u("h", "m"),
                                       tfn.sum("m", "agg"))}, "prod")


def test_multi_update_all_apply_node_func_matches_jax():
    hj, ht = _pair()
    feats = _features(3)
    for hg, f, conv in ((hj, jfn, jnp.asarray), (ht, tfn, torch.from_numpy)):
        hg.nodes_data("user")["h"] = conv(feats["user"])
        hg.nodes_data("developer")["h"] = conv(feats["developer"])
        hg.multi_update_all({
            "plays": (f.copy_u("h", "m"), f.sum("m", "agg")),
            "develops": (f.copy_u("h", "m"), f.sum("m", "agg")),
        }, "sum", apply_node_func=lambda nodes: {"agg": nodes.data["agg"]
                                                 * 10})
    assert_close(ht.nodes_data("game")["agg"], hj.nodes_data("game")["agg"])


def test_apply_edges_on_a_relation_matches_jax():
    hj, ht = _pair()
    feats = _features(4)
    hj.nodes_data("user")["h"] = jnp.asarray(feats["user"])
    hj.nodes_data("game")["h"] = jnp.asarray(feats["game"])
    ht.nodes_data("user")["h"] = torch.from_numpy(feats["user"])
    ht.nodes_data("game")["h"] = torch.from_numpy(feats["game"])
    hj.apply_edges(jfn.u_dot_v("h", "h", "s"), etype="plays")
    ht.apply_edges(tfn.u_dot_v("h", "h", "s"), etype="plays")
    assert_close(ht.edges_data("plays")["s"], hj.edges_data("plays")["s"])


def test_to_homogeneous_and_back_match_jax():
    hj, ht = _pair()
    gj, ij = dgl.to_homogeneous(hj)
    gt, it = dt.to_homogeneous(ht)
    for name in ("src", "dst", "csc_indptr"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)))
    for key in ("node_types", "edge_types"):
        np.testing.assert_array_equal(it[key], ij[key])
    assert it["ntype_offsets"] == ij["ntype_offsets"]
    assert it["etypes"] == ij["etypes"]
    x = np.arange(gt.num_nodes() * 2, dtype=np.float32).reshape(-1, 2)
    gj.ndata["x"] = jnp.asarray(x)
    gt.ndata["x"] = torch.from_numpy(x)
    names = [c[1] for c in ij["etypes"]]
    bj = dgl.to_heterogeneous(gj, ij["ntypes"], names,
                              node_type=ij["node_types"],
                              edge_type=ij["edge_types"])
    bt = dt.to_heterogeneous(gt, it["ntypes"], names,
                             node_type=it["node_types"],
                             edge_type=it["edge_types"])
    assert bt.canonical_etypes == bj.canonical_etypes
    for nt in bj.ntypes:
        for key in ("_ID", "x"):
            np.testing.assert_array_equal(bt.nodes_data(nt)[key].numpy(),
                                          np.asarray(bj.nodes_data(nt)[key]))
    for c in bj.canonical_etypes:
        np.testing.assert_array_equal(bt.edges_data(c)["_ID"].numpy(),
                                      np.asarray(bj.edges_data(c)["_ID"]))
        np.testing.assert_array_equal(bt.relations[c].src.numpy(),
                                      np.asarray(bj.relations[c].src))


def _mk(seed):
    r = np.random.default_rng(42 + seed)
    nu, ng = int(r.integers(3, 7)), int(r.integers(2, 5))
    edges = {("user", "follows", "user"): (r.integers(0, nu, 6),
                                           r.integers(0, nu, 6)),
             ("user", "plays", "game"): (r.integers(0, nu, 5),
                                         r.integers(0, ng, 5))}
    h = r.normal(size=(nu, 4)).astype(np.float32)
    w = r.normal(size=(5, 2)).astype(np.float32)
    hj, ht = _pair(edges, {"user": nu, "game": ng})
    hj.nodes_data("user")["h"] = jnp.asarray(h)
    ht.nodes_data("user")["h"] = torch.from_numpy(h)
    hj.edges_data("plays")["w"] = jnp.asarray(w)
    ht.edges_data("plays")["w"] = torch.from_numpy(w)
    return hj, ht


def test_batch_hetero_roundtrip_matches_jax():
    pairs = [_mk(i) for i in range(3)]
    bj = dgl.batch_hetero([p[0] for p in pairs])
    bt = dt.batch_hetero([p[1] for p in pairs])
    assert bt.batch_size == bj.batch_size == 3
    assert bt.batch_num_nodes("user") == bj.batch_num_nodes("user")
    assert bt.batch_num_edges("plays") == bj.batch_num_edges("plays")
    for c in bj.canonical_etypes:
        for name in ("src", "dst", "csc_indptr"):
            np.testing.assert_array_equal(
                getattr(bt.relations[c], name).numpy(),
                np.asarray(getattr(bj.relations[c], name)))
    np.testing.assert_array_equal(bt.edges_data("plays")["w"].numpy(),
                                  np.asarray(bj.edges_data("plays")["w"]))
    for hg, f in ((bj, jfn), (bt, tfn)):
        hg.multi_update_all({"plays": (f.copy_u("h", "m"),
                                       f.sum("m", "out"))}, "sum")
    assert_close(bt.nodes_data("game")["out"], bj.nodes_data("game")["out"])
    parts = dt.unbatch_hetero(bt)
    assert len(parts) == 3
    for part, (_, ht) in zip(parts, pairs):
        assert part.num_nodes("user") == ht.num_nodes("user")
        np.testing.assert_array_equal(part.nodes_data("user")["h"].numpy(),
                                      ht.nodes_data("user")["h"].numpy())
        np.testing.assert_array_equal(part.edges_data("plays")["w"].numpy(),
                                      ht.edges_data("plays")["w"].numpy())
        for c in ht.canonical_etypes:
            for a, b in zip(part.relations[c].host_edges(),
                            ht.relations[c].host_edges()):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="metagraph"):
        dt.batch_hetero([pairs[0][1], dt.heterograph(EDGES)])


def test_hetero_api_extras():
    ht = dt.heterograph({("user", "follows", "user"): ([0, 1], [1, 2]),
                         ("user", "plays", "game"): ([0, 2], [0, 1])})
    assert ht.number_of_nodes("user") == 3
    assert ht.number_of_edges("plays") == 2
    ht.nodes_data("user")["h"] = np.ones((3, 2), np.float32)
    ht.apply_nodes(lambda nb: {"h2": nb.data["h"] * 2}, ntype="user")
    assert (ht.nodes_data("user")["h2"] == 2.0).all()
    sub = ht.node_type_subgraph(["user"])
    assert sub.canonical_etypes == (("user", "follows", "user"),)
    sub2 = ht.edge_type_subgraph(["plays"])
    assert set(sub2.ntypes) == {"game", "user"} and sub2.num_edges() == 2
    with ht.local_scope():
        ht.nodes_data("game")["x"] = np.zeros((2, 1), np.float32)
        assert "x" in ht.nodes_data("game")
    assert "x" not in ht.nodes_data("game")
    lv = ht.local_var()
    lv.nodes_data("user")["y"] = np.zeros((3, 1), np.float32)
    assert "y" not in ht.nodes_data("user")
    # a relation view writes into the heterograph's frames and shares the
    # relation's derived cache (the kernels' row plans)
    rel = ht["plays"]
    rel.dstdata["z"] = torch.ones(2, 1)
    assert "z" in ht.nodes_data("game")
    assert rel.derived is ht.relations[("user", "plays", "game")].derived
    with pytest.raises(ValueError, match="single node type"):
        ht.ndata


def test_bipartite_union_metapath_match_jax():
    bj = dgl.bipartite(([0, 1, 2], [1, 0, 1]), "u", "e", "v", (3, 2))
    bt = dt.bipartite(([0, 1, 2], [1, 0, 1]), "u", "e", "v", (3, 2))
    assert (bt.num_nodes("u"), bt.num_nodes("v")) == (3, 2)
    hj = dgl.hetero_from_relations([
        dgl.heterograph({("a", "x", "b"): ([0, 1, 2], [1, 1, 0])}),
        dgl.heterograph({("b", "y", "c"): ([0, 1, 1], [2, 0, 1])})])
    ht = dt.hetero_from_relations([
        dt.heterograph({("a", "x", "b"): ([0, 1, 2], [1, 1, 0])}),
        dt.heterograph({("b", "y", "c"): ([0, 1, 1], [2, 0, 1])})])
    assert ht.canonical_etypes == hj.canonical_etypes
    mj = dgl.metapath_reachable_graph(hj, ["x", "y"])
    mt = dt.metapath_reachable_graph(ht, ["x", "y"])
    for a, b in zip(mt.host_edges(), mj.host_edges()):
        np.testing.assert_array_equal(a, b)
    assert bj.canonical_etypes == bt.canonical_etypes


@pytest.mark.parametrize("aggregate", ["sum", "mean", "max", "min",
                                       "stack"])
def test_hetero_graph_conv_from_jax_params(aggregate):
    hj, ht = _pair()
    feats = _features(5)
    mods_j = {et: jnn.SAGEConv(out_feats=5) for et in ("follows", "plays",
                                                        "develops")}
    conv_j = jnn.HeteroGraphConv(mods=mods_j, aggregate=aggregate)
    ins_j = {k: jnp.asarray(v) for k, v in feats.items()}
    params = jax_params(conv_j, hj, ins_j, seed=6)
    ref = conv_j.apply(params, hj, ins_j)
    conv_t = tnn.HeteroGraphConv(
        {et: tnn.SAGEConv(5) for et in ("follows", "plays", "develops")},
        aggregate=aggregate)
    ins_t = {k: torch.from_numpy(v) for k, v in feats.items()}
    conv_t(ht, ins_t)                                    # materialise
    conv_t.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    out = conv_t(ht, ins_t)
    assert set(out) == set(ref) == {"game", "user"}
    for nt in ref:
        assert_close(out[nt].detach(), ref[nt], f"{aggregate} {nt}")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_academic_graph_matches_jax_example():
    """The hetero twin's synthetic academic graph is the JAX example's:
    the same relations, edges, labels and splits."""
    hj, yj, trj, tej = _example("train_rgcn_hetero").synthetic_academic(
        num_papers=60, num_authors=30, num_subjects=8)
    ht, yt, trt, tet = _example("train_rgcn_hetero_torch").synthetic_academic(
        num_papers=60, num_authors=30, num_subjects=8)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(trt, trj)
    np.testing.assert_array_equal(tet, tej)
    assert ht.canonical_etypes == hj.canonical_etypes
    for c in hj.canonical_etypes:
        for a, b in zip(ht.relations[c].host_edges(),
                        hj.relations[c].host_edges()):
            np.testing.assert_array_equal(a, b)
