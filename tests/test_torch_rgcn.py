"""R-GCN in the PyTorch port against the JAX package on the CPU: the
(dst, etype)-pair plan, the three two-level functions, RelGraphConv and
RGCN (forward and gradients, from JAX parameters through ``interop``),
and the RDF datasets.

Tolerances (max abs error / max |ref|): the plan's arrays and the
synthetic datasets bitwise; the functions, layers and models 1e-5 (f32
sums in another order; the port also contracts the bases before the
projection, the JAX package after it).  The JAX side runs its Pallas
kernels in interpret mode where a norm needs the prepared pair graph, at
full precision (``DGL_TPU_SPMM_MODE=highest``), as
``tests/test_nn.py``'s pair-plan tests run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.data import rdf as jrdf
from dgl_hack_tpu.models import RGCN as JRGCN
from dgl_hack_tpu.nn import RelGraphConv as JRelGraphConv
from dgl_hack_tpu.ops import rgcn as jrgcn

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.data import rdf as trdf
from dgl_hack_tpu_torch.interop import (embed_module_names,
                                        flax_to_state_dict,
                                        state_dict_to_flax)
from dgl_hack_tpu_torch.models import RGCN
from dgl_hack_tpu_torch.nn import RelGraphConv
from dgl_hack_tpu_torch.ops import rgcn as trgcn

torch.set_num_threads(2)

TOL = 1e-5
N, E, R = 120, 700, 5


def assert_close(out, ref, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, f"{what}: rel err {err:.3g} > {TOL}"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def jax_params(module, *args, seed=0, scale=0.3, **kwargs):
    """Parameters of the flax ``module`` in the tree its ``init`` makes
    (found by ``jax.eval_shape``, which compiles nothing), drawn from a
    normal with numpy: flax's own initialisers compile one random kernel
    per shape on the CPU, seconds each."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.normal(size=s.shape)
                              .astype(np.float32)), shapes)


def _case(masked, seed=0):
    """(JAX graph, port graph, etypes, x, norm) of N nodes and E edges,
    every fourth edge padding where ``masked``."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    mask = (np.arange(E) % 4 != 3) if masked else None
    gj = dgl.graph((src, dst), num_nodes=N, edge_mask=mask)
    gt = dt.graph((src, dst), num_nodes=N, edge_mask=mask)
    et = rng.integers(0, R, E).astype(np.int32)
    x = rng.normal(size=(N, 8)).astype(np.float32)
    norm = rng.random((E, 1)).astype(np.float32)
    return gj, gt, et, x, norm


@pytest.fixture(scope="module")
def plans():
    """{masked: (JAX graph, port graph, etypes, x, norm, JAX plan prepared
    for Pallas, port plan)}."""
    out = {}
    for masked in (False, True):
        gj, gt, et, x, norm = _case(masked)
        out[masked] = (gj, gt, et, x, norm,
                       dgl.prepare_rgcn(gj, et, R, te=64),
                       dt.prepare_rgcn(gt, et, R))
    return out


@pytest.fixture
def highest(monkeypatch):
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")


@pytest.mark.parametrize("masked", [False, True])
def test_prepare_rgcn_matches_jax(plans, masked):
    gj, gt, et, _, _, pj, pt = plans[masked]
    assert pt.num_pairs == pj.num_pairs
    if masked:
        assert pt.num_pairs <= int(np.asarray(gj.edge_mask).sum())
    for name in ("pair_dst", "pair_etype", "edge_perm"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)), name)
    for name in ("src", "dst", "csc_indptr"):
        np.testing.assert_array_equal(
            getattr(pt.pair_graph, name).numpy(),
            np.asarray(getattr(pj.pair_graph, name)), name)
    assert pt.pair_graph.num_src_nodes == pj.pair_graph.num_src_nodes
    assert pt.pair_graph.num_dst_nodes == pj.pair_graph.num_dst_nodes
    seg = pt.dst_segments
    np.testing.assert_array_equal(seg.ids.numpy(), pt.pair_dst.numpy())
    np.testing.assert_array_equal(
        np.diff(seg.indptr.numpy()),
        np.bincount(pt.pair_dst.numpy(), minlength=N))


def test_prepare_rgcn_refuses_unknown_keywords():
    _, gt, et, _, _ = _case(False)
    with pytest.raises(TypeError, match="unexpected keywords"):
        dt.prepare_rgcn(gt, et, R, te=64, tile=8)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_norm", [False, True])
def test_rgcn_functions_match_jax(plans, highest, masked, with_norm):
    """rgcn_aggregate_pairs (and its x gradient), rgcn_basis_message with
    and without w_comp, rgcn_reduce_pairs."""
    gj, gt, et, x, norm, pj, pt = plans[masked]
    nj = jnp.asarray(norm[np.asarray(gj.int2user)]) if with_norm else None
    nt = torch.from_numpy(norm)[gt.int2user] if with_norm else None
    cot = np.random.default_rng(5).normal(
        size=(pt.num_pairs, x.shape[1])).astype(np.float32)

    def agg_j(xx):
        return jrgcn.rgcn_aggregate_pairs(pj, xx, nj)
    aj, vjp = jax.vjp(agg_j, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    at = trgcn.rgcn_aggregate_pairs(pt, xt, nt)
    (at * torch.from_numpy(cot)).sum().backward()
    assert_close(at.detach(), aj, "aggregate")
    assert_close(xt.grad, vjp(jnp.asarray(cot))[0], "aggregate dx")

    rng = np.random.default_rng(6)
    agg = rng.normal(size=(pt.num_pairs, 8)).astype(np.float32)
    for B in (3, R):
        weight = rng.normal(size=(B, 8, 6)).astype(np.float32)
        w_comp = rng.normal(size=(R, B)).astype(np.float32) if B < R \
            else None
        mj = jrgcn.rgcn_basis_message(
            pj, jnp.asarray(agg), jnp.asarray(weight),
            None if w_comp is None else jnp.asarray(w_comp))
        mt = trgcn.rgcn_basis_message(
            pt, torch.from_numpy(agg), torch.from_numpy(weight),
            None if w_comp is None else torch.from_numpy(w_comp))
        assert_close(mt, mj, f"basis message B={B}")
    msg = rng.normal(size=(pt.num_pairs, 6)).astype(np.float32)
    assert_close(trgcn.rgcn_reduce_pairs(pt, torch.from_numpy(msg), N),
                 jrgcn.rgcn_reduce_pairs(pj, jnp.asarray(msg), N), "reduce")
    with pytest.raises(ValueError, match="dst nodes"):
        trgcn.rgcn_reduce_pairs(pt, torch.from_numpy(msg), N + 1)


def test_projection_in_chunks_matches_one_pass(plans, monkeypatch):
    """rgcn_basis_message, and its gradients, with the pairs cut into
    chunks of 7 (weights gathered per chunk, the weight gradient summed
    per relation chunk by chunk) equal one chunk to f32 rounding."""
    pt = plans[False][-1]
    rng = np.random.default_rng(7)
    agg = rng.normal(size=(pt.num_pairs, 8)).astype(np.float32)
    weight = rng.normal(size=(3, 8, 6)).astype(np.float32)
    w_comp = rng.normal(size=(R, 3)).astype(np.float32)
    cot = torch.from_numpy(rng.normal(size=(pt.num_pairs, 6))
                           .astype(np.float32))
    runs = []
    for elems in (trgcn.PROJ_CHUNK_ELEMS, 7 * 8 * 6):
        monkeypatch.setattr(trgcn, "PROJ_CHUNK_ELEMS", elems)
        ins = [torch.from_numpy(a).requires_grad_()
               for a in (agg, weight, w_comp)]
        out = trgcn.rgcn_basis_message(pt, *ins)
        (out * cot).sum().backward()
        runs.append([out.detach()] + [t.grad for t in ins])
    for a, b, what in zip(*runs, ("msg", "dagg", "dweight", "dw_comp")):
        assert_close(b, a, what)


def _layer_pair(reg, num_bases, self_loop, gj, gt, et, x):
    """A JAX RelGraphConv's parameters and the port's layer loaded with
    them, output width 6."""
    jl = JRelGraphConv(6, R, reg, num_bases, self_loop=self_loop)
    params = jax_params(jl, gj, jnp.asarray(x), jnp.asarray(et), seed=1)
    tl = RelGraphConv(6, R, reg, num_bases, self_loop=self_loop)
    tl(gt, torch.from_numpy(x), torch.from_numpy(et))    # materialise
    tl.load_state_dict(flax_to_state_dict(_np_tree(params)))
    return jl, params, tl


@pytest.mark.parametrize("self_loop", [False, True])
@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("use_plan", [False, True])
@pytest.mark.parametrize("reg,num_bases", [("basis", 3), ("basis", None),
                                           ("bdd", 2)])
def test_relgraphconv_matches_jax(plans, highest, reg, num_bases, use_plan,
                                  with_norm, self_loop):
    """Forward and the gradients of x and every parameter, from the same
    parameters; 'bdd' ignores the plan in both packages."""
    gj, gt, et, x, norm, pj, pt = plans[False]
    jl, params, tl = _layer_pair(reg, num_bases, self_loop, gj, gt, et, x)
    nj = jnp.asarray(norm) if with_norm else None
    nt = torch.from_numpy(norm) if with_norm else None

    def loss_j(p, xx):
        out = jl.apply(p, gj, xx, jnp.asarray(et), nj,
                       plan=pj if use_plan else None)
        return (out * out).sum(), out
    (_, oj), (gp, gx) = jax.value_and_grad(loss_j, argnums=(0, 1),
                                           has_aux=True)(params,
                                                         jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ot = tl(gt, xt, torch.from_numpy(et), nt, plan=pt if use_plan else None)
    (ot * ot).sum().backward()
    assert_close(ot.detach(), oj, "forward")
    assert_close(xt.grad, gx, "dx")
    for name, ref in _np_tree(gp)["params"].items():
        assert_close(getattr(tl, name).grad, ref, f"d{name}")
    assert set(_np_tree(gp)["params"]) == {n for n, _ in
                                           tl.named_parameters()}


def test_relgraphconv_masked_matches_jax(plans, highest):
    """On a masked graph the padded edges contribute nothing, with the
    plan (built over the real edges) and without it."""
    gj, gt, et, x, norm, pj, pt = plans[True]
    jl, params, tl = _layer_pair("basis", 3, True, gj, gt, et, x)
    for use_plan in (False, True):
        oj = jl.apply(params, gj, jnp.asarray(x), jnp.asarray(et),
                      jnp.asarray(norm), plan=pj if use_plan else None)
        ot = tl(gt, torch.from_numpy(x), torch.from_numpy(et),
                torch.from_numpy(norm), plan=pt if use_plan else None)
        assert_close(ot.detach(), oj, f"masked plan={use_plan}")


def test_relgraphconv_options():
    _, gt, et, x, _ = _case(False)
    with pytest.raises(ValueError, match="Regularizer"):
        RelGraphConv(6, R, "diag")
    with pytest.raises(ValueError, match="multiplier of num_bases"):
        RelGraphConv(6, R, "bdd", 3)(gt, torch.from_numpy(x),
                                     torch.from_numpy(et))
    layer = RelGraphConv(6, R, num_bases=3, activation=torch.relu,
                         dropout=0.5, use_bias=False, low_mem=True)
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    out = layer(gt, xt, torch.from_numpy(et), deterministic=False,
                generator=gen)
    assert (out >= 0).all() and layer.h_bias is None
    ref = layer(gt, xt, torch.from_numpy(et), deterministic=True)
    kept = out != 0
    assert_close(out[kept].detach(), 2 * ref[kept].detach(), "dropout")


@pytest.mark.parametrize("use_plan", [False, True])
def test_rgcn_forward_matches_jax(plans, highest, use_plan):
    gj, gt, et, _, _, pj, pt = plans[False]
    jm = JRGCN(num_nodes=N, hidden_feats=8, out_feats=3, num_rels=R,
               num_bases=2)
    params = jax_params(jm, gj, jnp.asarray(et), seed=2)
    oj = jm.apply(params, gj, jnp.asarray(et),
                  plan=pj if use_plan else None)
    tm = RGCN(num_nodes=N, hidden_feats=8, out_feats=3, num_rels=R,
              num_bases=2)
    tm(gt, torch.from_numpy(et))                            # materialise
    tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
    ot = tm(gt, torch.from_numpy(et), plan=pt if use_plan else None)
    assert_close(ot.detach(), oj, "RGCN")
    back = state_dict_to_flax(tm.state_dict(),
                              embed_modules=embed_module_names(tm))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_p = jax.tree_util.tree_leaves_with_path(_np_tree(params))
    assert [k for k, _ in flat_b] == [k for k, _ in flat_p]
    for (_, a), (_, b) in zip(flat_b, flat_p):
        np.testing.assert_array_equal(a, b)


def test_rgcn_embedding_init_matches_flax():
    """flax's Embed draws a normal truncated at 2 sigma, sigma^2 =
    1/features; the port draws the same distribution."""
    tm = RGCN(num_nodes=4000, hidden_feats=16, out_feats=3, num_rels=R)
    w = tm.embed.weight.detach().numpy()
    assert abs(w.std() - 0.25) < 0.01
    assert np.abs(w).max() <= 2 * 0.25 / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("name", ["aifb", "mutag"])
def test_synthetic_rdf_matches_jax(name):
    dj, dtt = jrdf.synthetic_rdf(name), trdf.synthetic_rdf(name)
    for field in ("etypes", "labels", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(dtt, field),
                                      getattr(dj, field), field)
    assert (dtt.num_classes, dtt.num_rels, dtt.name) == \
        (dj.num_classes, dj.num_rels, dj.name)
    for field in ("src", "dst", "csc_indptr", "int2user"):
        np.testing.assert_array_equal(getattr(dtt.graph, field).numpy(),
                                      np.asarray(getattr(dj.graph, field)))


def test_rdf_loader_reads_npz(monkeypatch, tmp_path):
    rng = np.random.default_rng(9)
    n, e = 30, 90
    arrays = dict(src=rng.integers(0, n, e), dst=rng.integers(0, n, e),
                  etypes=rng.integers(0, 4, e).astype(np.int32),
                  labels=rng.integers(0, 3, n).astype(np.int32),
                  train_mask=rng.random(n) < 0.5,
                  test_mask=rng.random(n) < 0.3, num_nodes=n,
                  num_classes=3, num_rels=4)
    (tmp_path / "mutag").mkdir()
    np.savez(tmp_path / "mutag" / "mutag.npz", **arrays)
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    dtt = trdf.MUTAGDataset()
    dj = jrdf.MUTAGDataset()
    assert (dtt.name, dtt.num_classes, dtt.num_rels) == ("mutag", 3, 4)
    assert dtt.graph.num_nodes() == n and dtt.graph.num_edges() == e
    np.testing.assert_array_equal(dtt.etypes, arrays["etypes"])
    np.testing.assert_array_equal(dtt.graph.src.numpy(),
                                  np.asarray(dj.graph.src))
    np.testing.assert_array_equal(dtt.train_mask, arrays["train_mask"])
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path / "none"))
    with pytest.warns(UserWarning, match="synthetic"):
        dtt = trdf.AIFBDataset()
    assert dtt.graph.num_nodes() == 8285
