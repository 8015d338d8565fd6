"""The port's twin of the multi-device dry run
(``parallel/dryrun.py``) on 8 spawned gloo ranks against the JAX dry run
(``__graft_entry__.dryrun_multichip(8)``, its phases step for step on the
8-device CPU mesh of tests/conftest.py), from the JAX run's own initial
parameters: the five dropout-free losses within 1e-4 (and equal to those
MULTICHIP_r05.json recorded, to its 4 decimals), and the gspmd loss at
dropout 0, where no ``jax.random`` dropout mask is drawn.  The pool's
calls and the group's collectives are time-limited; the JAX package is
imported inside the functions, as the spawned ranks import this module
and need only the port."""
import numpy as np
import pytest
import torch

from dgl_hack_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

P = 8
WAIT_S = 120


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(P, "gloo", "cpu", timeout=WAIT_S)
    yield pool
    pool.close()


def _jax():
    import jax
    import jax.numpy as jnp
    import dgl_hack_tpu as jdgl
    from dgl_hack_tpu.parallel import halo as jh
    return jax, jnp, jdgl, jh


def _jax_dryrun_params_and_losses():
    """The JAX dry run's phases (``__graft_entry__.dryrun_multichip(8)``,
    step for step) with gspmd at dropout 0: each phase's initial
    parameters and loss."""
    import optax
    jax, jnp, jdgl, jh = _jax()
    from dgl_hack_tpu.data import planted_partition
    from dgl_hack_tpu.models import GCN, GraphSAGE
    from dgl_hack_tpu.nn import RelGraphConv
    from dgl_hack_tpu.parallel import (make_mesh, make_spmd_train_step,
                                       replicate, shard_graph, shard_params,
                                       shard_rows)
    from dgl_hack_tpu.parallel.spmd import (make_sampled_dp_step,
                                            sample_sharded_batch)
    from dgl_hack_tpu.sampling import MultiLayerNeighborSampler
    from jax.sharding import Mesh
    n_dev = P
    mesh = make_mesh(n_dev, tp=2)
    ds = planted_partition(512 * n_dev, 4, 32, avg_degree=4.0, seed=0,
                           train_per_class=4, num_val=8, num_test=8)
    params, losses = {}, {}
    model = GCN(hidden_feats=32, out_feats=ds.num_classes, dropout=0.0)
    with mesh:
        key = jax.random.PRNGKey(0)
        p = model.init({"params": key, "dropout": key}, ds.graph,
                       jnp.asarray(ds.features))
        params["gspmd"] = p
        tx = optax.adamw(1e-2)
        sp = shard_params(mesh, p)
        _, _, loss = make_spmd_train_step(model, tx, mesh)(
            sp, replicate(mesh, tx.init(sp)), shard_graph(mesh, ds.graph),
            shard_rows(mesh, jnp.asarray(ds.features)),
            shard_rows(mesh, jnp.asarray(ds.labels)),
            shard_rows(mesh, jnp.asarray(ds.train_mask)), key)
        losses["gspmd"] = float(loss)
    mesh1d = Mesh(np.asarray(jax.devices()[:n_dev]), ("node",))
    plan = jh.build_spatial_plan(ds.graph, n_dev, method="fennel", seed=0,
                                 dense_threshold=16)
    plan = jh.attach_spmm_plans(plan, te=64, flat_width=2 * 8 + 2 * 2)
    dev = plan.device_arrays()
    xs = jnp.asarray(jh.shard_features(plan, ds.features))
    ys = jnp.asarray(jh.shard_features(plan, ds.labels))
    ms = jnp.asarray(jh.shard_features(plan, ds.train_mask))
    tx2 = optax.adam(1e-2)
    C, Fin = ds.num_classes, ds.features.shape[1]
    etypes = np.random.default_rng(0).integers(
        0, 4, ds.graph.num_edges()).astype(np.int32)
    ets = jnp.asarray(jh.shard_edata(plan, etypes, layout="graph"))
    for name, make, key, extras in (
            ("spatial_halo", lambda: jh.make_spatial_gcn(
                plan, mesh1d, hidden=16, out_feats=C), 1, ()),
            ("spatial_gat", lambda: jh.make_spatial_gat(
                plan, mesh1d, hidden=8, out_feats=C, heads=(2, 1)), 2, ()),
            ("spatial_rgcn", lambda: jh.make_spatial_rgcn(
                plan, mesh1d, hidden=8, out_feats=C, num_rels=4,
                num_bases=2), 4, (ets,))):
        init, fwd = make()
        p = init(jax.random.PRNGKey(key), Fin)
        params[name] = p
        step = jh.spatial_train_step(fwd, tx2, n_extra=len(extras))
        with mesh1d:
            _, _, loss = step(p, tx2.init(p), xs, dev, ys, ms, *extras)
        losses[name] = float(loss)
    rplan = jdgl.prepare_rgcn(ds.graph, etypes, 4, te=64)
    conv = RelGraphConv(out_feats=8, num_rels=4, num_bases=2)
    xfull = jnp.asarray(ds.features)
    et_dev = jnp.asarray(etypes)
    p = conv.init(jax.random.PRNGKey(5), ds.graph, xfull, et_dev,
                  plan=rplan)
    params["rgcn_pair"] = p
    with mesh:
        def lf(p_, x):
            h = conv.apply(p_, ds.graph, x, et_dev, plan=rplan)
            return (h * h).mean()
        losses["rgcn_pair"] = float(jax.jit(lf)(p, shard_rows(mesh,
                                                              xfull)))
    model2 = GraphSAGE(hidden_feats=8, out_feats=C, num_layers=2,
                       dropout=0.0)
    sampler = MultiLayerNeighborSampler([2, 2], replace=True, pad=True,
                                        seed=0)
    seed_shards = np.random.default_rng(0).integers(
        0, ds.graph.num_nodes(), (n_dev, 8)).astype(np.int32)
    blocks, bx, by = sample_sharded_batch(ds.graph, sampler, seed_shards,
                                          ds.features, ds.labels)
    p = model2.init(jax.random.PRNGKey(3),
                    jax.tree.map(lambda a: a[0], blocks), bx[0])
    params["sampled_dp"] = p
    with mesh1d:
        _, _, loss = make_sampled_dp_step(model2, tx2, mesh1d)(
            p, tx2.init(p), blocks, bx, by)
    losses["sampled_dp"] = float(loss)
    return jax.tree.map(np.asarray, params), losses


def test_dryrun_twin_matches_jax(pool):
    """The twin's six phases from the JAX dry run's initial parameters:
    the five dropout-free losses (MULTICHIP_r05.json recorded 2.2965,
    1.9744, 8.1275, 20.6246, 2.2374) and, at dropout 0, the gspmd loss,
    each within 1e-4; every rank reports the same losses."""
    from dgl_hack_tpu_torch.interop import flax_to_state_dict
    from dgl_hack_tpu_torch.parallel import dryrun
    params, ref = _jax_dryrun_params_and_losses()
    for k, v in zip(("spatial_halo", "spatial_gat", "spatial_rgcn",
                     "rgcn_pair", "sampled_dp"),
                    (2.2965, 1.9744, 8.1275, 20.6246, 2.2374)):
        assert abs(ref[k] - v) <= 5e-5, (k, ref[k])
    tparams = {k: (v if k == "spatial_halo" else flax_to_state_dict(v))
               for k, v in params.items()}
    tparams["spatial_gat"] = _pair_state(params["spatial_gat"])
    tparams["spatial_rgcn"] = _pair_state(params["spatial_rgcn"])
    inputs = dryrun.prepare(P, gspmd_dropout=0.0)
    out = pool.run(dryrun.dryrun_rank, inputs, tparams)
    for o in out:
        for k in dryrun.PHASES:
            assert abs(o[k] - ref[k]) <= 1e-4 * max(1.0, abs(ref[k])), \
                (k, o[k], ref[k])
    assert out[0]["mesh"] == {"node": 4, "tp": 2}
    assert dryrun.format_line(P, out[0]).startswith(
        "dryrun_multichip(8): mesh={'node': 4, 'tp': 2} gspmd_loss=")


def _pair_state(p):
    from dgl_hack_tpu_torch.interop import spatial_params_from_jax
    return spatial_params_from_jax(p)
