"""The graph transformer of examples/train_transformer.py: the port's
``GraphTransformer`` against a JAX forward written here from the ops the
example uses (multi-head u_dot_v gsddmm, edge_softmax, u_mul_e gspmm,
its ``ln``, FFN and copy-task loss), from the same parameter dict
(carried across by ``interop.flax_to_state_dict``) and the same tokens.

Both run bare graphs on the CPU (the port's gsddmm runs K6's plain
version, the JAX one composes): loss and every parameter gradient agree
to 1e-5 * max|ref| (exact f32, summation order differs).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.edge_softmax import edge_softmax as jax_edge_softmax

from dgl_hack_tpu_torch.interop import flax_to_state_dict
from dgl_hack_tpu_torch.models import (GraphTransformer, build_graphs,
                                       copy_task_loss)

torch.set_num_threads(2)

TOL = 1e-5
B, L, V, DM, H = 2, 6, 16, 16, 2
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_transformer", ROOT / "examples" / "train_transformer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _jax_params(rng):
    """The example's parameter dict, drawn in its order with its scales."""
    def dense(shape, scale=None):
        scale = scale or (2.0 / sum(shape[-2:])) ** 0.5
        return rng.normal(0, scale, shape).astype(np.float32)

    def attn():
        return {k: dense((DM, DM)) for k in ("q", "k", "v", "o")}
    return {"emb": dense((V + 1, DM), 0.1), "pos": dense((L, DM), 0.1),
            "enc0": attn(), "enc1": attn(), "dec0": attn(), "dec1": attn(),
            "x0": attn(), "x1": attn(), "f1": dense((DM, 2 * DM)),
            "f2": dense((2 * DM, DM)), "out": dense((DM, V))}


def _jax_loss(graphs, prm, src_tok, tgt):
    """examples/train_transformer.py:90-124 at (B, L, V, DM, H)."""
    g_enc, g_dec, g_x = graphs
    Dh = DM // H

    def graph_attention(g, pa, hq, hkv):
        q = (hq @ pa["q"]).reshape(-1, H, Dh)
        k = (hkv @ pa["k"]).reshape(-1, H, Dh)
        v = (hkv @ pa["v"]).reshape(-1, H, Dh)
        logits = dgl.gsddmm(g, "dot", k, q, "u", "v") / Dh ** 0.5
        a = jax_edge_softmax(g, logits)
        out = dgl.gspmm(g, "mul", "sum", v, a, "u", "e")
        return out.reshape(-1, DM) @ pa["o"]

    def ln(h):
        mu = h.mean(-1, keepdims=True)
        s = ((h - mu) ** 2).mean(-1, keepdims=True)
        return (h - mu) * jax.lax.rsqrt(s + 1e-6)

    pos = jnp.tile(prm["pos"], (B, 1))
    he = ln(prm["emb"][src_tok.reshape(-1)] + pos)
    for lyr in ("enc0", "enc1"):
        he = ln(he + graph_attention(g_enc, prm[lyr], he, he))
    bos = jnp.full((B, 1), V, jnp.int32)
    tgt_in = jnp.concatenate([bos, tgt[:, :-1]], axis=1)
    hd = ln(prm["emb"][tgt_in.reshape(-1)] + pos)
    for slyr, xlyr in (("dec0", "x0"), ("dec1", "x1")):
        hd = ln(hd + graph_attention(g_dec, prm[slyr], hd, hd))
        hd = ln(hd + graph_attention(g_x, prm[xlyr], hd, he))
    hd = ln(hd + jax.nn.relu(hd @ prm["f1"]) @ prm["f2"])
    logits = (hd @ prm["out"]).reshape(B, L, V)
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, tgt[..., None], -1)[..., 0]
    return nll.mean()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = _jax_params(rng)
    seq = rng.integers(0, V, (B, L)).astype(np.int32)
    return params, seq


def test_graphs_match_example():
    """build_graphs gives the example's three graphs edge for edge; the
    cross-attention graph is a block."""
    for gj, gt in zip(_example().build_graphs(B, L), build_graphs(B, L)):
        assert gt.is_block == gj.is_block
        assert (gt.num_src_nodes, gt.num_dst_nodes) == (gj.num_src_nodes,
                                                        gj.num_dst_nodes)
        for name in ("src", "dst", "csc_indptr", "csr_eids"):
            np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                          np.asarray(getattr(gj, name)))
    g_enc, g_dec, g_x = build_graphs(B, L)
    assert g_enc.num_edges() == g_x.num_edges() == B * L * L
    assert g_dec.num_edges() == B * L * (L + 1) // 2


def test_params_carry_across(setup):
    """flax_to_state_dict maps the example's dict onto the port's
    parameters key for key, layouts unchanged; the port draws the same
    values from the same seed."""
    params, _ = setup
    state = flax_to_state_dict(params)
    model = GraphTransformer(V, L, DM, H)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    np.testing.assert_array_equal(model.enc0.q.detach().numpy(),
                                  params["enc0"]["q"])
    seeded = GraphTransformer(V, L, DM, H, rng=np.random.default_rng(0))
    for k, v in seeded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), k)


def test_loss_and_gradients_match_jax(setup):
    params, seq = setup
    graphs_j = _example().build_graphs(B, L)
    tok = jnp.asarray(seq)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: _jax_loss(graphs_j, p, tok, tok))(
            jax.tree_util.tree_map(jnp.asarray, params))

    model = GraphTransformer(V, L, DM, H)
    model.load_state_dict(flax_to_state_dict(params))
    t = torch.from_numpy(seq).long()
    loss_t, logits = copy_task_loss(model, build_graphs(B, L), t, t)
    loss_t.backward()
    assert logits.shape == (B, L, V)
    assert_close(float(loss_t.detach()), float(loss_j), TOL, "loss")
    flat = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    for name, p in model.named_parameters():
        assert_close(p.grad.numpy(), flat[name].numpy(), TOL, name)


def test_three_cpu_steps_lower_the_loss(setup):
    _, seq = setup
    torch.manual_seed(0)
    model = GraphTransformer(V, L, DM, H, rng=np.random.default_rng(1))
    graphs = build_graphs(B, L)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    t = torch.from_numpy(seq).long()
    losses = []
    for _ in range(3):
        loss, _ = copy_task_loss(model, graphs, t, t)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="multiple of heads"):
        GraphTransformer(V, L, 10, 4)
