"""The sampled example twins of the PyTorch port (metapath2vec,
PinSAGE-rec, GraphSAGE-CV, adaptive sampling) against their JAX
examples' loops, rewritten here with the JAX package's functions as
``tests/test_torch_examples.py`` rewrites the Tree-LSTM example's: from
the same data, samples and parameters (both packages' native samplers;
numpy generators shared where the examples draw from one), the walks,
item graphs and blocks are equal bit for bit and the first four losses
agree to 1e-5 (relative).  The CLIs are held in test_torch_examples.py.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_hack_tpu as dgl

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TWIN_LOSS_RTOL = 1e-5


def _jax_adam_losses(loss_fn, params, batches, lr):
    """Adam (optax) over ``batches``, each the extra arguments of
    ``loss_fn(params, *batch)``, which returns (loss, aux); returns the
    losses and each step's aux."""
    tx = optax.adam(lr)
    opt = tx.init(params)
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    losses, auxes = [], []
    for batch in batches:
        (loss, aux), grads = grad_fn(params, *batch())
        up, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, up)
        losses.append(float(loss))
        auxes.append(aux)
    return losses, auxes


def _metapath2vec_vs_jax(steps):
    """examples/train_metapath2vec.py's graph, walks and skip-gram loop at
    30 users, 20 items, walks of 3 metapath steps, batches of 256."""
    from dgl_hack_tpu.sampling import metapath_random_walk
    twin = _twin("train_metapath2vec_torch")
    U, I, L, W, win, B, neg_k, lr = 30, 20, 3, 4, 2, 256, 5, 0.05
    rt = np.random.default_rng(0)
    hg, _ = twin.make_data(U, I, rt)
    pairs = twin.walk_pairs(hg, U, L, W, win, rt)
    params = twin.init_params(U + I, 16, seed=3)
    res = twin.train(pairs, params, U + I, epochs=1, lr=lr,
                     negatives=neg_k, rng=rt, batch_size=B, device="cpu",
                     max_steps=steps)
    rng = np.random.default_rng(0)                  # the JAX example's
    area_u = rng.integers(0, 3, U)
    area_i = rng.integers(0, 3, I)
    src, dst = [], []
    for u in range(U):
        pool = np.nonzero(area_i == area_u[u])[0]
        for it in rng.choice(pool, size=min(5, len(pool)), replace=False):
            src.append(u)
            dst.append(int(it))
        if rng.random() < 0.3:
            src.append(u)
            dst.append(int(rng.integers(0, I)))
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    hgj = dgl.heterograph({("user", "ui", "item"): (src, dst),
                           ("item", "iu", "user"): (dst, src)},
                          num_nodes_dict={"user": U, "item": I})
    traces, types = metapath_random_walk(hgj, ["ui", "iu"] * L,
                                         np.tile(np.arange(U), W), rng=rng)
    glob = traces + np.where(types == list(hgj.ntypes).index("item"), U,
                             0)[None, :]
    glob = np.where(traces < 0, -1, glob)
    ref_pairs = []
    for row in glob:
        valid = row[row >= 0]
        for i in range(len(valid)):
            for j in range(max(0, i - win), min(len(valid), i + win + 1)):
                if i != j:
                    ref_pairs.append((valid[i], valid[j]))
    np.testing.assert_array_equal(pairs, np.asarray(ref_pairs, np.int32))

    def loss_fn(p, c, ctx, neg):
        zc, zp, zn = p["center"][c], p["context"][ctx], p["context"][neg]
        pos = jax.nn.log_sigmoid((zc * zp).sum(-1))
        negl = jax.nn.log_sigmoid(-(zc[:, None, :] * zn).sum(-1)).sum(-1)
        return -(pos + negl).mean(), None

    perm = rng.permutation(len(pairs))

    def batch(i):
        def draw():
            b = pairs[perm[i:i + B]]
            neg = rng.integers(0, U + I, (B, neg_k)).astype(np.int32)
            return jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]), \
                jnp.asarray(neg)
        return draw
    ref, _ = _jax_adam_losses(
        loss_fn, {k: jnp.asarray(v) for k, v in params.items()},
        [batch(i) for i in range(0, B * steps, B)], lr)
    return res["losses"], ref


def _pinsage_vs_jax(steps):
    """examples/train_pinsage_rec.py's item graph and BPR loop (the bare
    item graph: the composed gspmm) at 60 users, 50 items, hidden 16,
    with the negatives drawn in numpy for both."""
    twin = _twin("train_pinsage_rec_torch")
    data = twin.synth_movielens(60, 50)
    for a, b in zip(data, _twin("train_pinsage_rec").synth_movielens(60, 50)):
        np.testing.assert_array_equal(a, b)
    built = twin.build(data, num_walks=6, num_neighbors=4)
    params = twin.init_params(50, 16)
    negs = np.random.default_rng(4).integers(0, 50, (steps, len(data[0]), 3))
    res = twin.train(built, params, epochs=steps, lr=3e-2, num_negs=3,
                     device="cpu", negatives=lambda ep: negs[ep], log=None)
    tr_u, tr_i = data[0], data[1]
    G = dgl.heterograph({("user", "watched", "item"): (tr_u, tr_i),
                         ("item", "watched-by", "user"): (tr_i, tr_u)},
                        num_nodes_dict={"user": 60, "item": 50})
    from dgl_hack_tpu.sampling import PinSAGESampler
    gi = PinSAGESampler(G, "item", "user", random_walk_length=2,
                        random_walk_restart_prob=0.2, num_random_walks=6,
                        num_neighbors=4, seed=0)(np.arange(50))
    np.testing.assert_array_equal(built["gi"].host("src"), np.asarray(gi.src))
    np.testing.assert_array_equal(built["gi"].host("dst"), np.asarray(gi.dst))
    assert built["gi"].int2user is None and gi.int2user is None
    w = np.asarray(gi.edata["weights"], np.float32)
    wn = jnp.asarray(w / np.maximum(w.sum(), 1.0) * len(w))
    u_items, u_mask = (jnp.asarray(built[k]) for k in ("u_items", "u_mask"))

    def loss_fn(p, neg):
        h = p["emb"]
        for k in ("W1", "W2"):
            agg = dgl.gspmm(gi, "mul", "sum", h, wn[:, None], "u", "e")
            norm = dgl.gspmm(gi, "copy_rhs", "sum", None, wn[:, None], "u",
                             "e")
            h = jax.nn.relu(jnp.concatenate(
                [h, agg / jnp.maximum(norm, 1e-6)], 1) @ p[k])
            h = h / jnp.maximum(jnp.linalg.norm(h, axis=1, keepdims=True),
                                1e-6)
        ue = (h[u_items] * u_mask[..., None]).sum(1) / jnp.maximum(
            u_mask.sum(1, keepdims=True), 1.0)
        pos_s = (ue[tr_u] * h[tr_i]).sum(-1, keepdims=True)
        neg_s = jnp.einsum("ud,und->un", ue[tr_u], h[neg])
        return -jax.nn.log_sigmoid(pos_s - neg_s).mean(), None
    ref, _ = _jax_adam_losses(
        loss_fn, {k: jnp.asarray(v) for k, v in params.items()},
        [lambda ep=ep: (jnp.asarray(negs[ep]),) for ep in range(steps)],
        3e-2)
    return res["losses"], ref


def _sage_cv_vs_jax(steps):
    """examples/train_sage_cv.py's sampler, history and loop (the bare
    blocks: the composed gspmm) on a 400-node planted partition, fanouts
    (2, 2), batches of 24."""
    from dgl_hack_tpu.data import planted_partition as jplanted
    from dgl_hack_tpu_torch.data import planted_partition
    twin, jex = _twin("train_sage_cv_torch"), _twin("train_sage_cv")
    kw = dict(avg_degree=10.0, homophily=0.85, feat_noise=1.5, seed=0,
              train_per_class=20, num_val=50, num_test=100)
    ds, dsj = planted_partition(400, 5, 32, **kw), jplanted(400, 5, 32, **kw)
    fanouts, B, lr = (2, 2), 24, 1e-2
    params = twin.init_params([32, 16, 5], seed=0)
    res = twin.train(ds, params, fanouts=fanouts, batch_size=B, epochs=1,
                     lr=lr, device="cpu", max_steps=steps)
    g, feats = dsj.graph, dsj.features.astype(np.float32)
    sampler = jex.CVSampler(fanouts, seed=0)
    train_nid = np.nonzero(dsj.train_mask)[0]
    hists = [feats, np.zeros((400, 16), np.float32)]
    sampler.sample(g, train_nid[:B])

    def loss_fn(p, blocks, x, hs, ah, y):
        h, outs = x, []
        for l, (blk, (W, b)) in enumerate(zip(blocks, p)):
            h_neigh = ah[l] + dgl.gspmm(blk, "copy_lhs", "mean", h - hs[l])
            h = jnp.concatenate([h[:blk.num_dst_nodes], h_neigh], 1) @ W + b
            if l == 0:
                h = jax.nn.relu(h)
            outs.append(h)
        logp = jax.nn.log_softmax(h)
        return -jnp.take_along_axis(logp, y[:, None], -1).mean(), outs

    order = np.random.default_rng(0).permutation(len(train_nid))
    tx = optax.adam(lr)
    p = [tuple(jnp.asarray(a) for a in layer) for layer in params]
    opt = tx.init(p)
    ref = []
    for i in range(0, B * steps, B):
        seeds = train_nid[order[i:i + B]]
        blocks, srcs, dsts = sampler.sample(g, seeds)
        args = (blocks, jnp.asarray(feats[srcs[0]]),
                [jnp.asarray(hists[l][srcs[l]]) for l in range(2)],
                [jnp.asarray(jex.exact_hist_mean(g, dsts[l], hists[l]))
                 for l in range(2)],
                jnp.asarray(dsj.labels[seeds].astype(np.int32)))
        (loss, outs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, *args)
        up, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, up)
        hists[1][dsts[0]] = np.asarray(outs[0])
        ref.append(float(loss))
    return res["losses"], ref


def _adaptive_vs_jax(steps):
    """examples/train_adaptive_sampling.py's sampler and loop on synthetic
    Cora, batches and layers of 64 nodes, hidden 8: one numpy generator
    draws the parameters and the samples on both sides."""
    from dgl_hack_tpu.data import synthetic_cora as jcora
    from dgl_hack_tpu.ops import segment as jsegment
    from dgl_hack_tpu_torch.data import synthetic_cora
    twin = _twin("train_adaptive_sampling_torch")
    B = S = 64
    res = twin.train(synthetic_cora(), epochs=steps, batch_size=B,
                     layer_size=S, hidden=8, device="cpu", log=None)
    ds = jcora()
    g, n = ds.graph, ds.graph.num_nodes()
    feats = np.asarray(ds.features, np.float32)
    csc_indptr = np.asarray(g.host("csc_indptr"), np.int64)
    src_by_dst = np.asarray(g.host("src"), np.int64)
    deg = np.maximum(np.diff(csc_indptr), 1).astype(np.float64)
    rng = np.random.default_rng(0)

    def sample_layer(seeds):            # the example's, lines 57-97
        pos = np.concatenate([np.arange(csc_indptr[v], csc_indptr[v + 1])
                              for v in seeds])
        cand = np.unique(src_by_dst[pos])
        q = deg[cand] / deg[cand].sum()
        take = min(S, len(cand))
        sel = rng.choice(len(cand), size=take, replace=False, p=q)
        chosen = cand[sel]
        w_node = 1.0 / (take * q[sel])
        lut = np.full(n, -1, np.int64)
        lut[chosen] = np.arange(take)
        keep = lut[src_by_dst[pos]] >= 0
        pos_k = pos[keep]
        dst_k = np.repeat(seeds, np.diff(csc_indptr)[seeds])[keep]
        src_loc = lut[src_by_dst[pos_k]]
        w_edge = (w_node[src_loc] / deg[dst_k]).astype(np.float32)
        e_cap, e = B * 32, len(pos_k)
        if e > e_cap:
            sel_e = rng.choice(e, e_cap, replace=False)
            pos_k, dst_k = pos_k[sel_e], dst_k[sel_e]
            src_loc, w_edge = src_loc[sel_e], w_edge[sel_e]
            e = e_cap
        src_pad = np.zeros(e_cap, np.int32)
        dst_pad = np.zeros(e_cap, np.int32)
        w_pad = np.zeros(e_cap, np.float32)
        src_pad[:e] = src_loc
        dlut = np.full(n, 0, np.int64)
        dlut[seeds] = np.arange(len(seeds))
        dst_pad[:e] = dlut[dst_k]
        w_pad[:e] = w_edge
        chosen_pad = np.zeros(S, np.int64)
        chosen_pad[:take] = chosen
        return chosen_pad, src_pad, dst_pad, w_pad

    train_ids = np.nonzero(np.asarray(ds.train_mask))[0]

    def init_dense(shape):
        return jnp.asarray((rng.normal(size=shape)
                            * (2.0 / sum(shape)) ** 0.5).astype(np.float32))
    params = {"W1": init_dense((feats.shape[1], 8)),
              "W2": init_dense((8, ds.num_classes))}

    def agg(h_src, src, dst, w, num_dst):
        return jsegment.segment_reduce("sum", h_src[src] * w[:, None], dst,
                                       num_dst)

    def loss_fn(p, x2, s2, d2, w2, s1, d1, w1, y):
        h1 = jax.nn.relu(agg(x2 @ p["W1"], s2, d2, w2, S))
        logp = jax.nn.log_softmax(agg(h1, s1, d1, w1, B) @ p["W2"])
        return -jnp.take_along_axis(logp, y[:, None], -1).mean(), None

    def draw():
        seeds = rng.choice(train_ids, B, replace=len(train_ids) < B)
        l1, s1, d1, w1 = sample_layer(seeds)
        l2, s2, d2, w2 = sample_layer(l1)
        return tuple(jnp.asarray(a) for a in (
            feats[l2], s2, d2, w2, s1, d1, w1,
            np.asarray(ds.labels)[seeds].astype(np.int32)))
    ref, _ = _jax_adam_losses(loss_fn, params, [draw] * steps, 1e-2)
    return res["losses"], ref


@pytest.mark.parametrize("twin,compare", [
    ("metapath2vec", _metapath2vec_vs_jax), ("pinsage_rec", _pinsage_vs_jax),
    ("sage_cv", _sage_cv_vs_jax), ("adaptive_sampling", _adaptive_vs_jax)])
def test_sampled_twin_matches_jax(twin, compare):
    """The first losses of each twin's loop agree with its JAX example's
    loop run from the same data, samples and parameters, to 1e-5
    (relative); the walks, item graphs and blocks they train on are the
    same bit for bit (both packages' native samplers)."""
    losses, ref = compare(4)
    assert len(losses) == len(ref) == 4
    np.testing.assert_allclose(losses, ref, rtol=TWIN_LOSS_RTOL)
