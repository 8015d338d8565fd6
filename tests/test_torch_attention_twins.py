"""The attention example twins of the PyTorch port (HAN, capsule routing,
GraphWriter) against their JAX examples' loops, rewritten here with the JAX
package's functions as ``tests/test_torch_sampled_twins.py`` rewrites the
sampled ones: from the same data (drawn by each side from the same numpy
seed; the graphs are compared edge for edge) and the JAX example's initial
parameters (carried over through ``interop.flax_to_state_dict``), the
first four losses agree to 1e-5 (relative).  All run on the CPU: the
port's kernel plain versions (fused GAT, gsddmm, gspmm) against the JAX
composed paths on bare graphs.  The CLIs are held in
test_torch_examples.py.
"""
import importlib.util
import pathlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.nn import GATConv as JGATConv

from dgl_hack_tpu_torch.interop import flax_to_state_dict

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWIN_LOSS_RTOL = 1e-5
STEPS = 4


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _adam_losses(loss_fn, params, lr, steps=STEPS):
    """optax.adam over ``steps`` full-batch steps of loss_fn(params),
    jitted."""
    tx = optax.adam(lr)
    opt = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(steps):
        loss, grads = grad_fn(params)
        up, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, up)
        losses.append(float(loss))
    return losses


def _edges(g):
    return [np.asarray(a).tolist() for a in g.edges()]


def test_han_twin_matches_jax():
    """examples/train_han.py's ACM-style heterograph, metapath graphs and
    model (a GATConv per metapath, semantic attention), 4 Adam steps."""
    twin = _twin("train_han_torch")
    P, C, hidden, heads, lr = 300, 3, 16, 4, 5e-3
    graphs, feats, labels, train_mask = twin.make_data(P, C)
    # the JAX example's data, drawn with the JAX package
    rng = np.random.default_rng(0)
    NA, NF = P // 3, 3 * C
    area = rng.integers(0, C, P)

    def affil(n_other, per, noise=0.1):
        own = rng.integers(0, C, n_other)
        src, dst = [], []
        for o in range(n_other):
            pool = np.nonzero(area == own[o])[0]
            k = min(per, len(pool))
            papers = rng.choice(pool, size=k, replace=False)
            flip = rng.random(k) < noise
            papers[flip] = rng.integers(0, P, int(flip.sum()))
            src.extend([o] * k)
            dst.extend(papers.tolist())
        return np.asarray(src, np.int32), np.asarray(dst, np.int32)
    asrc, adst = affil(NA, 9)
    fsrc, fdst = affil(NF, 60, noise=0.25)
    hg = dgl.heterograph({
        ("author", "writes", "paper"): (asrc, adst),
        ("paper", "written-by", "author"): (adst, asrc),
        ("field", "has", "paper"): (fsrc, fdst),
        ("paper", "in", "field"): (fdst, fsrc)},
        num_nodes_dict={"paper": P, "author": NA, "field": NF})
    mp = [dgl.add_self_loop(dgl.metapath_reachable_graph(hg, m))
          for m in (["written-by", "writes"], ["in", "has"])]
    xj = (np.eye(C)[area] + 0.5 * rng.normal(size=(P, C))).astype(np.float32)
    mask = rng.random(P) < 0.4
    for gj, gt in zip(mp, graphs):
        assert _edges(gj) == _edges(gt)
    np.testing.assert_array_equal(xj, feats)
    np.testing.assert_array_equal(mask, train_mask)
    np.testing.assert_array_equal(area, labels)

    class HANLayer(nn.Module):
        @nn.compact
        def __call__(self, graphs, h):
            z = jnp.stack([JGATConv(hidden, heads)(g, h).reshape(
                h.shape[0], -1) for g in graphs], axis=1)
            w = nn.Dense(1)(jnp.tanh(nn.Dense(64)(z)))
            beta = jax.nn.softmax(w.mean(0), axis=0)
            return (z * beta[None]).sum(1)

    class HAN(nn.Module):
        @nn.compact
        def __call__(self, graphs, h):
            return nn.Dense(C)(nn.elu(HANLayer()(graphs, h)))
    model = HAN()
    params = model.init(jax.random.PRNGKey(0), mp, jnp.asarray(xj))
    y, m = jnp.asarray(area), jnp.asarray(mask)

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.apply(p, mp, jnp.asarray(xj)))
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.where(m, nll, 0.0).sum() / m.sum()
    ref = _adam_losses(loss_fn, params, lr)
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    res = twin.train(graphs, feats, labels, train_mask, hidden=hidden,
                     heads=heads, epochs=STEPS, lr=lr, device="cpu",
                     state=state)
    np.testing.assert_allclose(res["losses"], ref, rtol=TWIN_LOSS_RTOL)


def test_capsule_twin_matches_jax():
    """examples/train_capsule.py's routing block, digits and routing loop
    (copy_e sum of c * u_hat, e-dot-v agreement over (E, B, OD)
    operands), 4 Adam steps on 128 training digits."""
    from dgl_hack_tpu.ops.sddmm import gsddmm
    from dgl_hack_tpu.ops.spmm import gspmm
    twin = _twin("train_capsule_torch")
    jex = _twin("train_capsule")
    IC, OC, ID, OD, R, lr = 16, 10, 8, 16, 3, 3e-3
    xtr, ytr = twin.synthetic_digits(128, seed=0)
    for a, b in zip((xtr, ytr), jex.synthetic_digits(128, seed=0)):
        np.testing.assert_array_equal(a, b)
    src = np.repeat(np.arange(IC), OC).astype(np.int32)
    dst = np.tile(np.arange(OC), IC).astype(np.int32)
    g = dgl.block((src, dst), num_src=IC, num_dst=OC)
    s_int, d_int = g.edges(order="internal")
    pair = np.asarray(s_int) * OC + np.asarray(d_int)
    np.testing.assert_array_equal(pair, twin.routing_graph(IC, OC)[1])
    E = g.num_edges()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"primary": jax.random.normal(k1, (64, IC * ID)) * 0.1,
              "W": jax.random.normal(k2, (IC, OC, ID, OD)) * 0.1}

    def squash(s, axis=-1):
        sq = (s ** 2).sum(axis=axis, keepdims=True)
        return (sq / (1.0 + sq)) * s / jnp.sqrt(sq + 1e-9)

    def forward(p, x):
        B = x.shape[0]
        prim = squash(jnp.tanh(x @ p["primary"]).reshape(B, IC, ID))
        u_hat = jnp.einsum("bif,ijfo->ijbo", prim, p["W"]).reshape(
            IC * OC, B, OD)[pair]

        def routing_iter(r, b):
            c = jax.nn.softmax(b.reshape(IC, OC), axis=1).reshape(E, 1, 1)
            v = squash(gspmm(g, "copy_rhs", "sum", None, c * u_hat, "u",
                             "e"))
            return b + gsddmm(g, "dot", u_hat, v, "e", "v").mean(1)[:, 0]
        b = jax.lax.fori_loop(0, R, routing_iter, jnp.zeros((E,)))
        c = jax.nn.softmax(b.reshape(IC, OC), axis=1).reshape(E, 1, 1)
        v = squash(gspmm(g, "copy_rhs", "sum", None, c * u_hat, "u", "e"))
        return jnp.sqrt((v ** 2).sum(-1) + 1e-9).T
    x, y = jnp.asarray(xtr), jnp.asarray(ytr)
    ref = _adam_losses(lambda p: jex.margin_loss(forward(p, x), y), params,
                       lr)
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    res = twin.train({k: v.numpy() for k, v in state.items()}, xtr, ytr,
                     epochs=STEPS, lr=lr, routing=R, device="cpu")
    np.testing.assert_allclose(res["losses"], ref, rtol=TWIN_LOSS_RTOL)


def test_graphwriter_twin_matches_jax():
    """examples/train_graphwriter.py's KGs, batched graph, encoder (u_dot_v
    gsddmm + relation bias, edge_softmax, u_mul_e gspmm with an (E, H, 1)
    weight) and GRU decoder, 4 Adam steps on 32 training KGs."""
    from dgl_hack_tpu.ops.edge_softmax import edge_softmax
    from dgl_hack_tpu.ops.sddmm import gsddmm
    from dgl_hack_tpu.ops.spmm import gspmm
    twin = _twin("train_graphwriter_torch")
    jex = _twin("train_graphwriter")
    D, H, lr = 64, 4, 3e-3
    Dh, NE, NT, NR = D // H, twin.NE, twin.NT, twin.NR
    VOCAB = NT + NR + 2
    kgs = twin.make_kgs(32, seed=0)
    for a, b in zip(kgs, jex.make_kgs(32, seed=0)):
        np.testing.assert_array_equal(a, b)
    src, dst, rel, types, tokens = kgs
    B = src.shape[0]
    off = (np.arange(B, dtype=np.int32) * NE)[:, None]
    s, d = (src + off).reshape(-1), (dst + off).reshape(-1)
    loops = np.arange(B * NE, dtype=np.int32)
    g = dgl.graph((np.concatenate([s, d, loops]),
                   np.concatenate([d, s, loops])), num_nodes=B * NE)
    assert _edges(g) == _edges(twin.batch_graph(src, dst))
    rel_e = jnp.asarray(twin.edge_rels(rel))

    ks = jax.random.split(jax.random.PRNGKey(0), 12)
    gl = jax.nn.initializers.glorot_uniform()
    prm = {"emb_type": jax.random.normal(ks[0], (NT, D)) * 0.1,
           "emb_pos": jax.random.normal(jax.random.fold_in(ks[0], 7),
                                        (NE, D)) * 0.1,
           "emb_tok": jax.random.normal(ks[1], (VOCAB, D)) * 0.1,
           "emb_step": jax.random.normal(jax.random.fold_in(ks[1], 3),
                                         (3 * (NE - 1) + 2, D)) * 0.1,
           "rel_bias": jnp.zeros((2 * NR + 1, H)),
           "gru": {"Wz": gl(ks[8], (2 * D, D)), "Wr": gl(ks[9], (2 * D, D)),
                   "Wh": gl(ks[10], (2 * D, D))},
           "out": gl(ks[11], (2 * D, VOCAB))}
    for li in range(2):
        prm[f"enc{li}"] = {
            "Wq": gl(ks[2 + 3 * li], (D, D)), "Wk": gl(ks[3 + 3 * li], (D, D)),
            "Wv": gl(ks[4 + 3 * li], (D, D)),
            "Wo": gl(jax.random.fold_in(ks[2], li), (D, D)),
            "Wf": gl(jax.random.fold_in(ks[3], li), (D, 2 * D)),
            "Wf2": gl(jax.random.fold_in(ks[4], li), (2 * D, D))}

    def encode(p):
        h = p["emb_type"][jnp.asarray(types.reshape(-1))] + jnp.tile(
            p["emb_pos"], (B, 1))
        for li in range(2):
            q_ = p[f"enc{li}"]
            q = (h @ q_["Wq"]).reshape(-1, H, Dh)
            k = (h @ q_["Wk"]).reshape(-1, H, Dh)
            v = (h @ q_["Wv"]).reshape(-1, H, Dh)
            logits = gsddmm(g, "dot", k, q, "u", "v") / np.sqrt(Dh)
            logits = logits + p["rel_bias"][rel_e][:, :, None]
            a = edge_softmax(g, logits)
            agg = gspmm(g, "mul", "sum", v, a, "u", "e")
            h = h + agg.reshape(-1, D) @ q_["Wo"]
            h = h + jax.nn.relu(h @ q_["Wf"]) @ q_["Wf2"]
        return h.reshape(-1, NE, D)

    def decode(p, enc, tok):
        L = tok.shape[1]
        emb = p["emb_tok"][tok] + p["emb_step"][None, :L]

        def step(state, x):
            cat = jnp.concatenate([state, x], axis=-1)
            z = jax.nn.sigmoid(cat @ p["gru"]["Wz"])
            r = jax.nn.sigmoid(cat @ p["gru"]["Wr"])
            hh = jnp.tanh(jnp.concatenate([r * state, x], -1) @ p["gru"]["Wh"])
            state = (1 - z) * state + z * hh
            att = jax.nn.softmax(jnp.einsum("bd,bnd->bn", state, enc)
                                 / np.sqrt(D), axis=-1)
            ctx = jnp.einsum("bn,bnd->bd", att, enc)
            return state, jnp.concatenate([state, ctx], -1) @ p["out"]
        _, outs = jax.lax.scan(step, jnp.zeros((B, D)),
                               jnp.swapaxes(emb[:, :-1], 0, 1))
        return jnp.swapaxes(outs, 0, 1)

    def loss_fn(p):
        tok = jnp.asarray(tokens)
        logp = jax.nn.log_softmax(decode(p, encode(p), tok))
        return -jnp.take_along_axis(logp, tok[:, 1:, None], -1).mean()
    ref = _adam_losses(loss_fn, prm, lr)
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, prm))
    res = twin.train({k: v.numpy() for k, v in state.items()}, kgs,
                     heads=H, epochs=STEPS, lr=lr, device="cpu")
    np.testing.assert_allclose(res["losses"], ref, rtol=TWIN_LOSS_RTOL)
