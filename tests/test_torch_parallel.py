"""The port's multi-GPU layer (``parallel/``) on 8 spawned gloo ranks
against the JAX package's ``parallel/`` on the 8-device CPU mesh of
tests/conftest.py (the cases of tests/test_parallel.py, on the port).

One pool of 8 ranks (``parallel.launch.RankPool``) is started for the
file and serves every test; each rank runs the port on its slice of the
plan, and the test unshards the ranks' rows and holds them against the
JAX function's.  Every wait is time-limited (the pool's calls and the
group's collectives).  Cases:

* halo gspmm: sum, mean, max and min with overlap on and off, forward and
  dx; weighted u_mul_e (dx and dw, overlap on and off); hub replication;
  the distributed dense hub (sum and mean, dx, with and without plans
  attached); bf16 on the wire;
* spatial GCN, GAT and R-GCN from the JAX model's parameters: the
  forward, the gradient of the global masked loss and one Adam step;
* the data-parallel sampled GraphSAGE step, the spmd step at dropout 0
  on a (4, 2) mesh, ``KEModel.shard`` against the unsharded step.

The dry-run twin is held in tests/test_torch_parallel_dryrun.py.
Tolerances (JAX's own in tests/test_parallel.py): 1e-4 forward, 1e-3
gradients and parameters after a step, 2e-2 relative / 2e-4 absolute for
GAT parameter gradients.  The JAX package is
imported inside the tests, not at the top: the spawned ranks import this
module and need only the port."""
import numpy as np
import pytest
import torch

from dgl_hack_tpu_torch.parallel import halo as th
from dgl_hack_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

P = 8
WAIT_S = 120


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(P, "gloo", "cpu", timeout=WAIT_S)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:P]), ("node",))


def _jax():
    import jax
    import jax.numpy as jnp
    import dgl_hack_tpu as jdgl
    from dgl_hack_tpu.parallel import halo as jh
    return jax, jnp, jdgl, jh


def _rand_edges(rng, n, e):
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


def _plans(src, dst, n, **kw):
    """(JAX graph, port graph, JAX plan, port plan) of the same edges."""
    import dgl_hack_tpu_torch as dt
    _, _, jdgl, jh = _jax()
    jg = jdgl.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n)
    return (jg, tg, jh.build_spatial_plan(jg, P, **kw),
            th.build_spatial_plan(tg, P, **kw))


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# rank functions (run by every rank of the pool: port only)
# ---------------------------------------------------------------------------
def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def halo_rank(device, plan, x, reduce_op, overlap, w=None, comm=None):
    """This rank's halo gspmm of x's rows and the gradient of sum(out²)
    with respect to them (and to the split weights)."""
    r = _rank()
    dev = plan.device_arrays(r, device)
    xs = torch.from_numpy(th.shard_features(plan, x)[r]).requires_grad_()
    f = th.make_halo_gspmm(plan, None, reduce_op=reduce_op, overlap=overlap,
                           weighted=w is not None, comm_dtype=comm)
    ws = ()
    if w is not None:
        ws = tuple(torch.from_numpy(a[r]).requires_grad_()
                   for a in th.shard_edata(plan, w, layout="split"))
    out = f(xs, dev, *ws)
    (out * out).sum().backward()
    return [out.detach().numpy(), xs.grad.numpy()] + \
        [a.grad.numpy() for a in ws]


def spatial_rank(device, kind, plan, x, labels, mask, params, cfg,
                 etypes=None):
    """This rank's logits of a spatial model from ``params`` (the JAX
    model's), then one train step: (logits, loss, summed gradients,
    parameters after the step)."""
    from dgl_hack_tpu_torch.interop import spatial_params_from_jax
    r = _rank()
    dev = plan.device_arrays(r, device)

    def own(a):
        return torch.from_numpy(th.shard_features(plan, a)[r])

    xs, ys, ms = own(x), own(labels), own(mask)
    extras = () if etypes is None else (
        torch.from_numpy(th.shard_edata(plan, etypes)[r]),)
    make = {"gcn": th.make_spatial_gcn, "gat": th.make_spatial_gat,
            "rgcn": th.make_spatial_rgcn}[kind]
    init, fwd = make(plan, None, **cfg)
    model = init(0, x.shape[1], device)
    sd = spatial_params_from_jax(params)
    if kind == "gcn":
        with torch.no_grad():
            for k, v in sd.items():
                model[k].copy_(v)
        named = dict(model)
    else:
        model.load_state_dict(sd)
        named = dict(model.named_parameters())
    with torch.no_grad():
        logits = fwd(model, xs, dev, *extras).numpy()
    step = th.spatial_train_step(fwd, torch.optim.Adam(
        list(named.values()), lr=1e-2))
    loss = float(step(model, xs, dev, ys, ms, *extras))
    return (logits, loss, {k: v.grad.numpy() for k, v in named.items()},
            {k: v.detach().numpy() for k, v in named.items()})


# ---------------------------------------------------------------------------
# halo gspmm
# ---------------------------------------------------------------------------
def _jax_halo(mesh, jg, jplan, x, reduce_op, overlap=True, w=None,
              comm=None):
    """The JAX halo gspmm's output and d sum(out²)/dx (and dw) in global
    order.  max and min run the overlap form with the Pallas plans
    attached (the JAX kernel path, in interpret mode), whose backward
    gives every tied edge the full cotangent, as the port's K5 does with
    overlap on or off; the JAX composed path (its non-overlap form, or no
    plans) splits it among the ties (tests/test_torch_segment_max.py)."""
    jax, jnp, _, jh = _jax()
    if reduce_op in ("max", "min"):
        jplan, overlap = jh.attach_spmm_plans(jplan, te=64), True
    n = jg.num_nodes()
    dev = jplan.device_arrays()
    xs = jnp.asarray(jh.shard_features(jplan, x))
    f = jh.make_halo_gspmm(jplan, mesh, reduce_op=reduce_op,
                           overlap=overlap, weighted=w is not None,
                           comm_dtype=comm)
    ws = () if w is None else tuple(
        jnp.asarray(a) for a in jh.shard_edata(jplan, w, layout="split"))

    def loss(a, *ws_):
        out = f(a, dev, *ws_)
        return (out ** 2).sum(), out

    with mesh:
        grads, out = jax.jit(jax.grad(loss, argnums=tuple(
            range(1 + len(ws))), has_aux=True))(xs, *ws)
    res = [jh.unshard_rows(jplan, np.asarray(out), n),
           jh.unshard_rows(jplan, np.asarray(grads[0]), n)]
    return res + [np.asarray(g) for g in grads[1:]]


def _unshard(tplan, res, i, n):
    return th.unshard_rows(tplan, np.stack([r[i] for r in res]), n)


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("overlap", [True, False])
def test_halo_gspmm_reducers(pool, mesh, reduce_op, overlap):
    rng = np.random.default_rng(4)
    n, e, F = 150, 900, 8
    src, dst = _rand_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    jg, _, jp, tp = _plans(src, dst, n, method="random", seed=0)
    res = pool.run(halo_rank, tp, x, reduce_op, overlap)
    ref = _jax_halo(mesh, jg, jp, x, reduce_op, overlap)
    _close(_unshard(tp, res, 0, n), ref[0], 1e-4)
    _close(_unshard(tp, res, 1, n), ref[1], 1e-3)


@pytest.mark.parametrize("overlap", [True, False])
def test_halo_gspmm_weighted_u_mul_e(pool, mesh, overlap):
    """Per-edge weights in split plan order; dw lands in split order on
    each rank.  JAX runs its overlap form (its non-overlap form takes the
    weights in the general layout's length)."""
    rng = np.random.default_rng(5)
    n, e, F = 120, 700, 8
    src, dst = _rand_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    w = rng.normal(size=(e,)).astype(np.float32)
    jg, _, jp, tp = _plans(src, dst, n, method="random", seed=0)
    res = pool.run(halo_rank, tp, x, "sum", overlap, w)
    ref = _jax_halo(mesh, jg, jp, x, "sum", True, w)
    _close(_unshard(tp, res, 0, n), ref[0], 1e-4)
    _close(_unshard(tp, res, 1, n), ref[1], 1e-3)
    _close(np.stack([r[2] for r in res]), ref[2], 1e-3)
    _close(np.stack([r[3] for r in res]), ref[3], 1e-3)


def _power_edges(rng, n, e):
    deg = np.clip(rng.pareto(1.1, n) + 1, 1, None)
    src = rng.choice(n, e, p=deg / deg.sum()).astype(np.int32)
    return src, rng.integers(0, n, e).astype(np.int32)


def test_halo_gspmm_hub_replication(pool, mesh):
    rng = np.random.default_rng(7)
    n, e, F = 300, 3000, 16
    src, dst = _power_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    jg, _, jp, tp = _plans(src, dst, n, method="random", seed=0, hub_k=16)
    assert tp.hk_max > 0
    for overlap in (True, False):
        res = pool.run(halo_rank, tp, x, "sum", overlap)
        ref = _jax_halo(mesh, jg, jp, x, "sum", overlap)
        _close(_unshard(tp, res, 0, n), ref[0], 1e-4)
        _close(_unshard(tp, res, 1, n), ref[1], 1e-3)


@pytest.mark.parametrize("reduce_op", ["sum", "mean"])
def test_halo_gspmm_dense_hub(pool, mesh, reduce_op):
    """The distributed dense hub: hub dst rows as the rank's columns of C
    times its rows and one reduce_scatter, the rest over the reduced
    plan's exchange; with and without the plans attached."""
    rng = np.random.default_rng(45)
    n, e = 1500, 15000
    w = (np.arange(n) + 1.0) ** -0.8
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.choice(n, e, p=w / w.sum()).astype(np.int32)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    jg, _, jp, tp = _plans(src, dst, n, method="fennel", seed=0, hub_k=8,
                           dense_threshold=40)
    assert tp.reduced is not None
    ref = _jax_halo(mesh, jg, jp, x, reduce_op)
    for plan in (tp, th.attach_spmm_plans(tp, te=64)):
        res = pool.run(halo_rank, plan, x, reduce_op, True)
        _close(_unshard(tp, res, 0, n), ref[0], 1e-4)
        _close(_unshard(tp, res, 1, n), ref[1], 1e-3)


@pytest.mark.parametrize("hub_k", [0, 8])
def test_halo_gspmm_bf16_wire(pool, mesh, hub_k):
    """comm_dtype=bf16 rounds the shipped rows (and the returning
    cotangent) to bf16 in both packages: the forward within 1e-4.  dx
    within 1e-3 without hubs; with hubs the hub rows' cotangents are
    summed over the ranks in bf16 (gloo's reduce_scatter against XLA's
    psum_scatter, in another order), so there the forward alone is
    held."""
    _, jnp, _, _ = _jax()
    rng = np.random.default_rng(9)
    n, e, F = 200, 1500, 8
    src, dst = _power_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    jg, _, jp, tp = _plans(src, dst, n, method="random", seed=0,
                           hub_k=hub_k)
    res = pool.run(halo_rank, tp, x, "sum", True, None, torch.bfloat16)
    ref = _jax_halo(mesh, jg, jp, x, "sum", True, None, jnp.bfloat16)
    _close(_unshard(tp, res, 0, n), ref[0], 1e-4)
    if not hub_k:
        _close(_unshard(tp, res, 1, n), ref[1], 1e-3)
    exact = _jax_halo(mesh, jg, jp, x, "sum")[0]
    assert np.abs(ref[0] - exact).max() > 1e-4      # the wire did round


# ---------------------------------------------------------------------------
# spatial models
# ---------------------------------------------------------------------------
def _jax_spatial(mesh, kind, jplan, x, labels, mask, cfg, etypes=None,
                 seed=0):
    """The JAX model's params, global-loss gradients and params after one
    step of adam(1e-2), its logits and loss (``spatial_train_step``'s
    loss and update, composed here under one compile)."""
    import optax
    jax, jnp, _, jh = _jax()
    make = {"gcn": jh.make_spatial_gcn, "gat": jh.make_spatial_gat,
            "rgcn": jh.make_spatial_rgcn}[kind]
    init, fwd = make(jplan, mesh, **cfg)
    params = init(jax.random.PRNGKey(seed), x.shape[1])
    dev = jplan.device_arrays()
    xs = jnp.asarray(jh.shard_features(jplan, x))
    ys = jnp.asarray(jh.shard_features(jplan, labels))
    ms = jnp.asarray(jh.shard_features(jplan, mask))
    extras = () if etypes is None else (
        jnp.asarray(jh.shard_edata(jplan, etypes)),)

    def loss_fn(p):
        logits = fwd(p, xs, dev, *extras)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, ys[..., None], axis=-1)[..., 0]
        m = ms.astype(logits.dtype)
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0), logits

    # one compile: the loss of spatial_train_step's loss_fn, its gradient
    # and the logits; the step's adam update applied to that gradient
    tx = optax.adam(1e-2)
    with mesh:
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    tree = jax.tree.map(np.asarray, (params, grads, new))
    return tree + (np.asarray(logits), float(loss))


def _model_data(seed, n, e, F, C):
    rng = np.random.default_rng(seed)
    src, dst = _rand_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    m = rng.random(n) < 0.5
    return src, dst, x, y, m


@pytest.mark.parametrize("kind", ["gcn", "gat", "rgcn"])
def test_spatial_models_match_jax(pool, mesh, kind):
    from dgl_hack_tpu_torch.interop import spatial_params_from_jax
    n, e, F, C = 120, 700, 10, 4
    src, dst, x, y, m = _model_data(6, n, e, F, C)
    cfg = {"gcn": dict(hidden=8, out_feats=C),
           "gat": dict(hidden=6, out_feats=C, heads=(4, 1)),
           "rgcn": dict(hidden=12, out_feats=C, num_rels=5,
                        num_bases=3)}[kind]
    etypes = np.random.default_rng(1).integers(0, 5, e).astype(np.int32) \
        if kind == "rgcn" else None
    jg, _, jp, tp = _plans(src, dst, n, method="random", seed=0)
    params, grads, new, jlogits, jloss = _jax_spatial(
        mesh, kind, jp, x, y, m, cfg, etypes)
    res = pool.run(spatial_rank, kind, tp, x, y, m, params, cfg, etypes)
    _close(np.stack([r[0] for r in res]), jlogits, 1e-4)
    for r in res:
        assert abs(r[1] - jloss) <= 1e-4 * max(1.0, abs(jloss))
    jg_sd = spatial_params_from_jax(grads)
    jn_sd = spatial_params_from_jax(new)
    for k, ref in jg_sd.items():
        for r in res:           # every rank holds the same summed grads
            if kind == "gat":
                np.testing.assert_allclose(r[2][k], ref.numpy(), rtol=2e-2,
                                           atol=2e-4, err_msg=k)
            else:
                _close(r[2][k], ref.numpy(), 1e-3)
    for k, ref in jn_sd.items():
        for r in res:
            _close(r[3][k], ref.numpy(), 1e-3)


# ---------------------------------------------------------------------------
# spmd: sampled data parallel, the mesh step, KEModel.shard
# ---------------------------------------------------------------------------
def sampled_dp_rank(device, src, dst, n, x, y, seed_shards, sd):
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.models import GraphSAGE
    from dgl_hack_tpu_torch.parallel.spmd import (make_sampled_dp_step,
                                                  sample_sharded_batch)
    from dgl_hack_tpu_torch.sampling import MultiLayerNeighborSampler
    g = dt.graph((src, dst), num_nodes=n)
    sampler = MultiLayerNeighborSampler([3, 3], replace=True, pad=True,
                                        seed=0)
    blocks, bx, by = sample_sharded_batch(g, sampler, seed_shards, x, y,
                                          device=device)
    model = GraphSAGE(8, 4, num_layers=2, dropout=0.0)
    model.load_state_dict(sd)
    step = make_sampled_dp_step(model, torch.optim.Adam(model.parameters(),
                                                        lr=1e-2))
    loss = float(step(blocks, bx, by))
    return loss, {k: v.detach().numpy() for k, v in
                  model.state_dict().items()}


def test_sampled_dp_step(pool, mesh):
    import optax
    jax, jnp, jdgl, _ = _jax()
    from dgl_hack_tpu.models import GraphSAGE as JSAGE
    from dgl_hack_tpu.parallel.spmd import (make_sampled_dp_step,
                                            sample_sharded_batch)
    from dgl_hack_tpu.sampling import MultiLayerNeighborSampler as JS
    from dgl_hack_tpu_torch.interop import flax_to_state_dict
    rng = np.random.default_rng(8)
    n, e, F, C, B = 300, 2400, 8, 4, 16
    src, dst = _rand_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    seed_shards = rng.integers(0, n, (P, B)).astype(np.int32)
    jg = jdgl.graph((src, dst), num_nodes=n)
    model = JSAGE(hidden_feats=8, out_feats=C, num_layers=2, dropout=0.0)
    sampler = JS([3, 3], replace=True, pad=True, seed=0)
    blocks, xs, ys = sample_sharded_batch(jg, sampler, seed_shards, x, y)
    params = model.init(jax.random.PRNGKey(0),
                        jax.tree.map(lambda a: a[0], blocks), xs[0])
    tx = optax.adam(1e-2)
    step = make_sampled_dp_step(model, tx, mesh)
    with mesh:
        new, _, loss = step(params, tx.init(params), blocks, xs, ys)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    res = pool.run(sampled_dp_rank, src, dst, n, x, y, seed_shards, sd)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, new))
    for r_loss, r_sd in res:
        assert abs(r_loss - float(loss)) <= 1e-5 * abs(float(loss))
        for k, v in ref.items():
            np.testing.assert_allclose(r_sd[k], v.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=k)


def spmd_rank(device, src, dst, n, x, y, m, sd):
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.models import GCN
    from dgl_hack_tpu_torch.parallel import spmd
    mesh = spmd.make_mesh(P, tp=2)
    g = dt.graph((src, dst), num_nodes=n)
    model = GCN(32, 4, dropout=0.0)
    model.load_state_dict(sd)
    params = spmd.shard_params(mesh, dict(model.named_parameters()))
    tx = torch.optim.AdamW(list(params.values()), lr=1e-2,
                           weight_decay=1e-4)
    step = spmd.make_spmd_train_step(model, tx, mesh)
    rows = [spmd.shard_rows(mesh, torch.from_numpy(a)) for a in (x, y, m)]
    loss = float(step(params, spmd.shard_graph(mesh, g), *rows))
    full = {}
    for k, v in params.items():        # the shards gathered back
        if v.shape != model.get_parameter(k).shape:
            v = spmd.Sharded(v.t().contiguous(), model.get_parameter(
                k).shape[1], 0, mesh.get_group("tp")).full().t()
        full[k] = v.detach().numpy()
    return loss, full, {k: tuple(v.shape) for k, v in params.items()}


def test_spmd_step_dropout0(pool, mesh):
    """The JAX step on a (node 4, tp 2) mesh against the port's: the
    weights column-sharded over 'tp', the rows over 'node'."""
    import optax
    jax, jnp, jdgl, _ = _jax()
    from dgl_hack_tpu.models import GCN as JGCN
    from dgl_hack_tpu.parallel import (make_mesh, make_spmd_train_step,
                                       replicate, shard_graph, shard_params,
                                       shard_rows)
    from dgl_hack_tpu_torch.interop import flax_to_state_dict
    rng = np.random.default_rng(12)
    n, e, F = 256, 1500, 8
    src, dst = _rand_edges(rng, n, e)
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    m = rng.random(n) < 0.4
    jg = jdgl.graph((src, dst), num_nodes=n)
    jmesh = make_mesh(P, tp=2)
    model = JGCN(hidden_feats=32, out_feats=4, dropout=0.0)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key}, jg,
                        jnp.asarray(x))
    tx = optax.adamw(1e-2)
    with jmesh:
        sp = shard_params(jmesh, params)
        new, _, loss = make_spmd_train_step(model, tx, jmesh)(
            sp, replicate(jmesh, tx.init(sp)), shard_graph(jmesh, jg),
            shard_rows(jmesh, jnp.asarray(x)), shard_rows(jmesh,
                                                          jnp.asarray(y)),
            shard_rows(jmesh, jnp.asarray(m)), key)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    res = pool.run(spmd_rank, src, dst, n, x, y, m, sd)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, new))
    for r_loss, r_full, r_shapes in res:
        assert abs(r_loss - float(loss)) <= 1e-5 * abs(float(loss))
        assert r_shapes["layer0.weight"] == (F, 16)     # a column block
        for k, v in ref.items():
            _close(r_full[k], v.numpy(), 1e-3)


def kg_shard_rank(device, n, tables, batches):
    from dgl_hack_tpu_torch.models import kg as tkg
    m = tkg.KEModel(n, 3, 8, "DistMult", device=device)
    m.params = {k: torch.from_numpy(v) for k, v in tables.items()}
    m.shard(None)
    tx = tkg.adagrad(0.1)
    state = tx.init(m.params)
    step = tkg.make_train_step(m, tx, chunk_size=4)
    ms = tkg.make_sparse_train_step(m, 0.1, chunk_size=4)
    sparse = {k: v.clone() for k, v in m.params.items()}
    sstate = tkg.init_sparse_state(m)
    losses = []
    for b in batches:
        b = [torch.from_numpy(a) for a in b]
        _, _, loss = step(m.params, state, *b, False)
        _, _, sloss = ms(sparse, sstate, *b, False)
        losses.append((float(loss), float(sloss)))
    return (losses, tkg.gather_entity(m, m.params["entity"]).numpy(),
            tkg.gather_entity(m, sparse["entity"]).numpy(),
            m.params["relation"].numpy(), sparse["relation"].numpy())


@pytest.mark.parametrize("n", [64, 61])
def test_keemodel_shard_equals_unsharded(pool, mesh, n):
    """The entity table row-sharded over 8 ranks (64 rows: 8 a rank; 61:
    the last block padded): 3 dense and 3 sparse steps from the JAX
    model's tables equal the JAX model's to 1e-5 (the losses relative,
    the tables of max|ref|, as tests/test_torch_kg.py holds the unsharded
    port), and the unsharded port's to 1e-6.  The JAX model is sharded
    over the 8-device mesh where 8 divides the rows; JAX refuses an
    uneven split, so at 61 it runs unsharded."""
    import optax
    jax, jnp, _, _ = _jax()
    from dgl_hack_tpu.models import kg as jkg
    from dgl_hack_tpu_torch.interop import kg_params_from_jax
    from dgl_hack_tpu_torch.models import kg as tkg
    jm = jkg.KEModel(n, 3, 8, "DistMult")
    m = tkg.KEModel(n, 3, 8, "DistMult", device="cpu")
    m.params, _ = kg_params_from_jax(jm.params)
    tables = {k: v.numpy().copy() for k, v in m.params.items()}
    rng = np.random.default_rng(3)
    batches = [tuple(rng.integers(0, hi, shape).astype(np.int32)
                     for hi, shape in ((n, 8), (3, 8), (n, 8),
                                       (n, (2, 5)))) for _ in range(3)]
    tx = tkg.adagrad(0.1)
    state = tx.init(m.params)
    step = tkg.make_train_step(m, tx, chunk_size=4)
    ms = tkg.make_sparse_train_step(m, 0.1, chunk_size=4)
    sparse = {k: v.clone() for k, v in m.params.items()}
    sstate = tkg.init_sparse_state(m)
    ref = []
    for b in batches:
        b = [torch.from_numpy(a) for a in b]
        _, _, loss = step(m.params, state, *b, False)
        _, _, sloss = ms(sparse, sstate, *b, False)
        ref.append((float(loss), float(sloss)))
    # the JAX model sharded over the mesh, dense (optax) and sparse steps
    if n % P == 0:
        jm.shard(mesh)
        assert len(jm.params["entity"].sharding.device_set) == P
    jtx = optax.adagrad(0.1)
    jstep = jkg.make_train_step(jm, jtx, chunk_size=4)
    jsstep = jkg.make_sparse_train_step(jm, 0.1, 4)
    jp, jopt = jm.params, jtx.init(jm.params)
    jsp, jss = jm.params, jkg.init_sparse_state(jm)
    jref = []
    with mesh:
        for b in batches:
            b = tuple(jnp.asarray(a) for a in b)
            jp, jopt, jl = jstep(jp, jopt, *b, jnp.asarray(False))
            jsp, jss, jsl = jsstep(jsp, jss, *b, False)
            jref.append((float(jl), float(jsl)))
    jtab = [np.asarray(t) for t in (jp["entity"], jsp["entity"],
                                    jp["relation"], jsp["relation"])]

    def held(got, want, rel):
        want = np.asarray(want, np.float64)
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= rel * np.abs(want).max(), err

    for losses, ent, sent, rel, srel in pool.run(kg_shard_rank, n, tables,
                                                 batches):
        np.testing.assert_allclose(losses, jref, rtol=1e-5)
        for got, want in zip((ent, sent, rel, srel), jtab):
            held(got, want, 1e-5)
        np.testing.assert_allclose(losses, ref, rtol=1e-6)
        for got, want in zip((ent, sent, rel, srel),
                             (m.params["entity"], sparse["entity"],
                              m.params["relation"], sparse["relation"])):
            held(got, want.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# the collectives' transposes and the spmd helpers
# ---------------------------------------------------------------------------
def collectives_rank(device):
    """Each collective of ``parallel.collectives`` on rank-tagged rows and
    the gradient of sum(out * c) through it, c tagged by rank too."""
    from dgl_hack_tpu_torch.parallel import collectives as coll
    r = _rank()
    out = {}
    x = (r * 10 + torch.arange(P, dtype=torch.float32))[:, None].repeat(
        1, 3).requires_grad_()
    y = coll.all_to_all(x)
    (y * (100 * r + torch.arange(P))[:, None]).sum().backward()
    out["a2a"], out["a2a_grad"] = y.detach().numpy(), x.grad.numpy()
    pend = coll.all_to_all(x.detach(), async_op=True)
    out["a2a_async"] = pend.wait().numpy()
    z = torch.full((2, 3), float(r), requires_grad=True)
    gz = coll.all_gather(z)
    (gz * torch.arange(2 * P, dtype=torch.float32)[:, None]).sum().backward()
    out["gather"], out["gather_grad"] = gz.detach().numpy(), z.grad.numpy()
    s = torch.full((2 * P, 3), float(r + 1), requires_grad=True)
    rs = coll.reduce_scatter(s)
    (rs * (r + 1)).sum().backward()
    out["scatter"], out["scatter_grad"] = rs.detach().numpy(), s.grad.numpy()
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(r))
    coll.all_reduce_grads([p], mean=True)
    out["grad_mean"] = p.grad.numpy()
    return out


def test_collectives_transposes(pool):
    res = pool.run(collectives_rank)
    q = np.arange(P)
    tot = P * (P + 1) / 2
    for r, o in enumerate(res):
        # row q from rank q: q*10 + r; the cotangent comes back the same way
        np.testing.assert_array_equal(o["a2a"][:, 0], q * 10 + r)
        np.testing.assert_array_equal(o["a2a_async"], o["a2a"])
        np.testing.assert_array_equal(o["a2a_grad"][:, 0], 100 * q + r)
        np.testing.assert_array_equal(o["gather"][:, 0], np.repeat(q, 2))
        # all_gather's transpose: the summed cotangent of this rank's rows
        np.testing.assert_array_equal(o["gather_grad"][:, 0],
                                      P * np.arange(2 * r, 2 * r + 2))
        np.testing.assert_array_equal(o["scatter"], np.full((2, 3), tot))
        # reduce_scatter's transpose: every rank's cotangent, gathered
        np.testing.assert_array_equal(o["scatter_grad"][:, 0],
                                      np.repeat(q + 1, 2))
        np.testing.assert_array_equal(o["grad_mean"], [(P - 1) / 2] * 2)


def spmd_helpers_rank(device):
    from dgl_hack_tpu_torch.parallel import spmd
    r = _rank()
    mesh = spmd.make_mesh(P, tp=2)
    rep = spmd.replicate(mesh, {"a": torch.full((3,), float(r)),
                                "b": [torch.tensor([r])]})
    rows = spmd.shard_rows(mesh, torch.arange(21.0)[:, None].repeat(1, 2))
    w = spmd.shard_params(mesh, {"w": torch.arange(12.0).reshape(2, 6),
                                 "v": torch.arange(5.0).reshape(1, 5)})
    return (rep["a"].numpy(), rep["b"][0].numpy(), rows.local.numpy(),
            rows.full().numpy(), w["w"].detach().numpy(),
            w["v"].detach().numpy())


def test_spmd_helpers(pool):
    """``replicate`` takes rank 0's copy; ``shard_rows`` gives node block
    r // 2 (blocks of ceil(21 / 4) = 6 rows, the last padded) and
    ``full`` gathers it back; ``shard_params`` splits a 2-D weight's
    columns over 'tp' where they divide, and leaves the rest whole."""
    from dgl_hack_tpu_torch.parallel.spmd import stack_shards
    res = pool.run(spmd_helpers_rank)
    full = np.arange(21.0)[:, None].repeat(2, 1)
    for r, (a, b, loc, got, w, v) in enumerate(res):
        np.testing.assert_array_equal(a, [0.0] * 3)
        np.testing.assert_array_equal(b, [0])
        n = r // 2
        want = np.zeros((6, 2))
        blk = full[6 * n:6 * n + 6]
        want[:len(blk)] = blk
        np.testing.assert_array_equal(loc, want)
        np.testing.assert_array_equal(got, full)
        t = r % 2
        np.testing.assert_array_equal(
            w, np.arange(12.0).reshape(2, 6)[:, 3 * t:3 * t + 3])
        np.testing.assert_array_equal(v, np.arange(5.0).reshape(1, 5))
    st = stack_shards([{"x": np.ones(2) * i, "y": [torch.tensor(i)]}
                       for i in range(3)])
    np.testing.assert_array_equal(st["x"].numpy(), [[0, 0], [1, 1], [2, 2]])
    np.testing.assert_array_equal(st["y"][0].numpy(), [0, 1, 2])
