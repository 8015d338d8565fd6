"""The GGNN, DGI, GCMC, RRN, LGNN and point-cloud example twins of the
PyTorch port against their JAX examples' loops, rewritten here with the
JAX package's modules (as ``tests/test_torch_chem_twins.py`` does): from
the same data (each side draws it from the same numpy seed; graphs and
arrays are compared) and the JAX example's initial parameters (carried
over by ``interop.flax_to_state_dict``; RRN draws its own from numpy in
both), the first five Adam losses agree to 1e-5 relative to the run's
largest loss.  On the CPU: the port's kernel plain versions against the
JAX composed paths on bare graphs.  LGNN runs its first graph five times,
so that the JAX step compiles once.  The CLIs are held in
test_torch_examples.py."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax

import dgl_hack_tpu as dgl
from dgl_hack_tpu.nn import EdgeConv, GatedGraphConv, GraphConv, \
    HeteroGraphConv

from test_torch_attention_twins import _twin
from test_torch_chem_twins import STEPS, _adam, _state, assert_losses_close

import torch

torch.set_num_threads(2)

glorot = fnn.initializers.glorot_uniform()


def _same_edges(gj, gt):
    for a, b in zip(gj.host_edges(), gt.host_edges()):
        np.testing.assert_array_equal(a, b)


def test_ggnn_twin_matches_jax():
    """examples/train_ggnn.py's reachability graphs and GatedGraphConv model,
    5 Adam steps over the first 5 graphs."""
    twin, jex = _twin("train_ggnn_torch"), _twin("train_ggnn")
    task = twin.make_task(10, 24, 3, 4, 0)
    graphs, ets, labels = jex.make_task(10, 24, 3, 4, 0)
    for gj, gt in zip(graphs, task[0]):
        _same_edges(gj, gt)
    for a, b in zip(ets + labels, task[1] + task[2]):
        np.testing.assert_array_equal(a, b)

    class GGNN(fnn.Module):
        @fnn.compact
        def __call__(self, g, x, etypes):
            h = GatedGraphConv(32, n_steps=4, n_etypes=3)(g, x, etypes)
            return fnn.Dense(1, kernel_init=glorot)(h)[:, 0]
    model = GGNN()
    x0 = jnp.zeros((24, 2)).at[0, 0].set(1.0)
    params = jax.jit(lambda k: model.init(k, graphs[0], x0,
                                          jnp.asarray(ets[0])))(
        jax.random.PRNGKey(0))

    def loss_fn(p, g, et, y):
        return optax.sigmoid_binary_cross_entropy(
            model.apply(p, g, x0, et), y.astype(jnp.float32)).mean()
    ref = _adam(loss_fn, params, 5e-3,
                [(graphs[i], jnp.asarray(ets[i]), jnp.asarray(labels[i]))
                 for i in range(STEPS)])
    res = twin.train(task, epochs=1, n_train=STEPS, params=_state(params),
                     device="cpu")
    assert_losses_close(res["losses"], ref)


def test_dgi_twin_matches_jax():
    """examples/train_dgi.py's encoder (GraphConv + PReLU), bilinear
    discriminator and numpy corruption permutations, 5 Adam steps."""
    from dgl_hack_tpu.data import synthetic_cora
    twin = _twin("train_dgi_torch")
    data = twin.make_data()
    ds = synthetic_cora(seed=0)
    g = dgl.add_self_loop(ds.graph)
    _same_edges(g, data[0])
    X = jnp.asarray(ds.features)

    class Encoder(fnn.Module):
        @fnn.compact
        def __call__(self, g, x):
            return fnn.PReLU()(GraphConv(64)(g, x))

    class DGI(fnn.Module):
        @fnn.compact
        def __call__(self, g, x, x_corrupt):
            enc = Encoder()
            h_pos, h_neg = enc(g, x), enc(g, x_corrupt)
            s = jax.nn.sigmoid(h_pos.mean(0))
            W = self.param("disc", glorot, (64, 64))
            return -(jax.nn.log_sigmoid((h_pos @ W) @ s).mean()
                     + jax.nn.log_sigmoid(-(h_neg @ W) @ s).mean())
    model = DGI()
    key = jax.random.PRNGKey(0)
    perm0 = jax.random.permutation(key, X.shape[0])
    params = jax.jit(lambda k: model.init(k, g, X, X[perm0]))(key)
    rng = np.random.default_rng(0)
    perms = [(jnp.asarray(rng.permutation(X.shape[0])),)
             for _ in range(STEPS)]
    ref = _adam(lambda p, perm: model.apply(p, g, X, X[perm]), params, 5e-3,
                perms)
    res = twin.train(data, epochs=STEPS, params=_state(params), device="cpu")
    assert_losses_close(res["losses"], ref)


def test_gcmc_twin_matches_jax():
    """examples/train_gcmc.py's rating world, per-rating relations,
    HeteroGraphConv encoder and bilinear decoder, 5 Adam steps."""
    twin = _twin("train_gcmc_torch")
    hg_t, trn, _ = twin.make_data()
    rng = np.random.default_rng(0)
    NU, NI, R = 120, 80, 3
    zu, zi = rng.normal(size=(NU, 4)), rng.normal(size=(NI, 4))
    score = zu @ zi.T
    rating = np.digitize(score, np.quantile(score,
                                            np.linspace(0, 1, R + 1)[1:-1]))
    u_obs, i_obs = np.nonzero(rng.random((NU, NI)) < 0.25)
    r_obs = rating[u_obs, i_obs]
    tr = rng.permutation(len(u_obs))[:int(0.8 * len(u_obs))]
    for a, b in zip((u_obs[tr], i_obs[tr], r_obs[tr]), trn):
        np.testing.assert_array_equal(a, b)
    data = {}
    for r in range(R):
        m = r_obs[tr] == r
        data[("user", f"rate{r}", "item")] = (u_obs[tr][m], i_obs[tr][m])
        data[("item", f"rev{r}", "user")] = (i_obs[tr][m], u_obs[tr][m])
    hg = dgl.heterograph(data, num_nodes_dict={"user": NU, "item": NI})
    for c in hg.canonical_etypes:
        _same_edges(hg[c], hg_t[c])

    class Encoder(fnn.Module):
        @fnn.compact
        def __call__(self, hg, feats):
            conv = HeteroGraphConv(
                {f"rate{r}": GraphConv(32, norm="right") for r in range(R)}
                | {f"rev{r}": GraphConv(32, norm="right")
                   for r in range(R)}, aggregate="sum")
            return {k: fnn.relu(v) for k, v in conv(hg, feats).items()}

    class Decoder(fnn.Module):
        @fnn.compact
        def __call__(self, hu, hi, u, i):
            Q = self.param("Q", glorot, (R, 32, 32))
            return jnp.einsum("bh,rhk,bk->br", hu[u], Q, hi[i])

    class GCMC(fnn.Module):
        @fnn.compact
        def __call__(self, hg, feats, u, i):
            h = Encoder()(hg, feats)
            return Decoder()(h["user"], h["item"], u, i)
    model = GCMC()
    feats = {"user": jnp.eye(NU), "item": jnp.eye(NI)}
    utr, itr, rtr = (jnp.asarray(a) for a in trn)
    params = jax.jit(lambda k: model.init(k, hg, feats, utr, itr))(
        jax.random.PRNGKey(0))

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.apply(p, hg, feats, utr, itr))
        return -jnp.take_along_axis(logp, rtr[:, None], 1).mean()
    ref = _adam(loss_fn, params, 1e-2, [()] * STEPS)
    res = twin.train((hg_t, trn, trn), epochs=STEPS, params=_state(params),
                     device="cpu")
    assert_losses_close(res["losses"], ref)


def test_rrn_twin_matches_jax():
    """examples/train_rrn.py's puzzles, constraint graph, numpy parameters
    (drawn first from the same generator) and the edge-UDF message,
    copy_e sum and GRU steps, 5 Adam steps (batch 8, hidden 16, 3 steps)."""
    from dgl_hack_tpu import fn
    twin, jex = _twin("train_rrn_torch"), _twin("train_rrn")
    B, Dm, T = 8, 16, 3
    g = jex.constraint_graph(B)
    _same_edges(g, twin.constraint_graph(B))
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    params = twin.init_params(rng_t, Dm)

    def dense(shape):
        return jnp.asarray((rng_j.normal(size=shape)
                            * (2.0 / sum(shape[-2:])) ** 0.5
                            ).astype(np.float32))
    shapes = {"emb": (5, Dm), "pos": (16, Dm), "m1": (2 * Dm, Dm),
              "m2": (Dm, Dm), "wz": (2 * Dm, Dm), "wr": (2 * Dm, Dm),
              "wh": (2 * Dm, Dm), "out": (Dm, 4)}
    jparams = {k: dense(shapes[k]) for k in twin.PARAMS}
    for k in twin.PARAMS:
        np.testing.assert_array_equal(np.asarray(jparams[k]), params[k])
    pos = jnp.tile(jnp.arange(16), B)

    def loss_fn(prm, puzzles, sols):
        x0 = prm["emb"][puzzles.reshape(-1)] + prm["pos"][pos]

        def step(h, _):
            g.ndata["h"] = h
            g.apply_edges(lambda e: {"m": jax.nn.relu(
                jnp.concatenate([e.src["h"], e.dst["h"]], -1)
                @ prm["m1"]) @ prm["m2"]})
            g.update_all(fn.copy_e("m", "m"), fn.sum("m", "agg"))
            agg = g.ndata.pop("agg")
            inp = jnp.concatenate([agg + x0, h], -1)
            z = jax.nn.sigmoid(inp @ prm["wz"])
            r = jax.nn.sigmoid(inp @ prm["wr"])
            cand = jnp.tanh(jnp.concatenate([agg + x0, r * h], -1)
                            @ prm["wh"])
            h = (1 - z) * h + z * cand
            return h, h @ prm["out"]
        _, logits_t = jax.lax.scan(step, x0, None, length=T)
        tgt = (sols.reshape(-1) - 1).astype(jnp.int32)
        logp = jax.nn.log_softmax(logits_t)
        return -jnp.take_along_axis(
            logp, jnp.broadcast_to(tgt[None, :, None],
                                   (T, tgt.shape[0], 1)), -1).mean()
    batches = [tuple(jnp.asarray(a) for a in jex.sudoku4_batch(rng_j, B))
               for _ in range(STEPS)]
    ref = _adam(loss_fn, jparams, 2e-3, batches)
    res = twin.train(params, rng_t, batch=B, steps=T, epochs=STEPS,
                     device="cpu", log=None)
    assert_losses_close(res["losses"], ref)


def test_lgnn_twin_matches_jax():
    """examples/train_lgnn.py's SBM graphs, line graphs, incidence and
    model (operators over g and its line graph, LayerNorms, half-relu
    channels), 5 Adam steps on the first graph."""
    twin = _twin("train_lgnn_torch")
    data = twin.make_data(graphs=2, nodes=24)
    rng = np.random.default_rng(0)
    n, K = 24, 2
    comm = rng.permutation(np.repeat(np.arange(K), n // K))
    prob = np.where(comm[:, None] == comm[None, :], 0.6, 0.08)
    a = (rng.random((n, n)) < prob) & ~np.eye(n, dtype=bool)
    a = np.triu(a) | np.triu(a).T
    s, d = np.nonzero(a)
    g = dgl.graph((s.astype(np.int32), d.astype(np.int32)), num_nodes=n)
    lg = dgl.line_graph(g, backtracking=False)
    _same_edges(g, data[0][0])
    _same_edges(lg, data[0][1])
    pm, deg = jnp.asarray(data[0][2]), jnp.asarray(data[0][3])
    np.testing.assert_array_equal(comm, data[0][4])

    class LGNNLayer(fnn.Module):
        out: int

        @fnn.compact
        def __call__(self, g, lg, x, y, pm):
            ax = dgl.gspmm(g, "copy_lhs", "sum", x)
            a2x = dgl.gspmm(g, "copy_lhs", "sum", ax)
            xn = fnn.Dense(self.out)(x) + fnn.Dense(self.out)(ax) \
                + fnn.Dense(self.out)(a2x) + fnn.Dense(self.out)(pm @ y)
            xn = fnn.LayerNorm()(xn)
            by = dgl.gspmm(lg, "copy_lhs", "sum", y)
            yn = fnn.Dense(self.out)(y) + fnn.Dense(self.out)(by) \
                + fnn.Dense(self.out)(pm.T @ x)
            yn = fnn.LayerNorm()(yn)
            h = self.out // 2
            xn = jnp.concatenate([fnn.relu(xn[:, :h]), xn[:, h:]], 1)
            yn = jnp.concatenate([fnn.relu(yn[:, :h]), yn[:, h:]], 1)
            return xn, yn

    class LGNN(fnn.Module):
        @fnn.compact
        def __call__(self, g, lg, deg, pm):
            x = deg
            y = jnp.ones((lg.num_nodes(), 1), jnp.float32)
            for _ in range(3):
                x, y = LGNNLayer(16)(g, lg, x, y, pm)
            return fnn.Dense(K)(x)
    model = LGNN()
    params = jax.jit(lambda k: model.init(k, g, lg, deg, pm))(
        jax.random.PRNGKey(0))
    c = jnp.asarray(comm)

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.apply(p, g, lg, deg, pm))
        l1 = -jnp.take_along_axis(logp, c[:, None], 1).mean()
        l2 = -jnp.take_along_axis(logp, (1 - c)[:, None], 1).mean()
        return jnp.minimum(l1, l2)
    ref = _adam(loss_fn, params, 5e-3, [()] * STEPS)
    res = twin.train(data, epochs=STEPS, n_train=1, params=_state(params),
                     device="cpu")
    assert_losses_close(res["losses"], ref)


def test_pointcloud_twin_matches_jax():
    """examples/train_pointcloud.py's clouds, kNN graphs and DGCNN (two
    EdgeConvs, max ++ mean pooling, MLP), 5 Adam steps over the first 5
    clouds."""
    twin = _twin("train_pointcloud_torch")
    data = twin.make_data(clouds=9)
    rng = np.random.default_rng(0)
    NP = 64
    clouds = []
    for i in range(9):
        lbl = i % 3
        if lbl == 0:
            x = rng.normal(size=(NP, 3))
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        elif lbl == 1:
            x = rng.uniform(-1, 1, (NP, 3))
            ax = rng.integers(0, 3, NP)
            x[np.arange(NP), ax] = np.sign(x[np.arange(NP), ax])
        else:
            c = rng.integers(0, 2, NP)[:, None] * 2.0 - 1.0
            x = c * np.array([1.0, 0, 0]) + 0.3 * rng.normal(size=(NP, 3))
        x = x.astype(np.float32)
        clouds.append((dgl.knn_graph(x, 8), jnp.asarray(x), lbl))
        np.testing.assert_array_equal(x, data[i][1])
        _same_edges(clouds[-1][0], data[i][0])

    class DGCNN(fnn.Module):
        @fnn.compact
        def __call__(self, g, x):
            h = fnn.relu(EdgeConv(32)(g, x))
            h = fnn.relu(EdgeConv(32)(g, h))
            hg = jnp.concatenate([h.max(0), h.mean(0)])
            return fnn.Dense(3)(fnn.relu(fnn.Dense(32)(hg)))
    model = DGCNN()
    params = jax.jit(lambda k: model.init(k, *clouds[0][:2]))(
        jax.random.PRNGKey(0))
    ref = _adam(lambda p, g, x, y: -jax.nn.log_softmax(model.apply(p, g, x))[y],
                params, 5e-3, clouds[:STEPS])
    res = twin.train(data, epochs=1, n_train=STEPS, params=_state(params),
                     device="cpu")
    assert_losses_close(res["losses"], ref)
