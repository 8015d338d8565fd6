"""The port's twin of the multi-device dry run
(``__graft_entry__.dryrun_multichip``): six phases, each one training step
(or one value-and-gradient) on tiny shapes, run by every rank of a group:

* ``gspmd`` — GCN (hidden 32, dropout 0.1) over a ('node', 'tp') mesh
  through ``make_spmd_train_step`` under AdamW (optax.adamw's defaults);
* ``spatial_halo`` — spatial GCN (hidden 16) over a Fennel plan with the
  distributed dense hub (threshold 16) and the kernel plans attached;
* ``spatial_gat`` — spatial GAT (hidden 8, heads (2, 1));
* ``spatial_rgcn`` — spatial R-GCN (4 relations, 2 bases, hidden 8);
* ``rgcn_pair`` — RelGraphConv over the (dst, etype)-pair plan on the full
  graph, features row-sharded and gathered, loss mean(h²) and its
  gradient;
* ``sampled_dp`` — sampled GraphSAGE ([2, 2] fanouts, 8 seeds a rank),
  data parallel.

``prepare(n)`` builds the host inputs once (the dataset, the plan, the
relation types, the seed rows), ``dryrun_rank(device, inputs, params)``
runs the phases on one rank and returns their losses, and
``dryrun_multichip(n, device, backend)`` starts n local ranks, runs them
and prints the JAX function's line.  ``params`` (phase -> state dict, or
the spatial GCN's raw {W1, b1, W2, b2}) replaces each phase's own
initial parameters, which are drawn from torch's generator: the tests
carry the JAX dry run's own across (``interop.spatial_params_from_jax``,
``flax_to_state_dict``).  The gspmd loss equals JAX's only at dropout 0:
a dropout mask from ``jax.random`` is one the port cannot draw.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

PHASES = ("gspmd", "spatial_halo", "spatial_gat", "spatial_rgcn",
          "rgcn_pair", "sampled_dp")


def prepare(n_devices: int, gspmd_dropout: float = 0.1) -> Dict:
    """The host inputs of every rank (numpy and the plan, which pickle):
    the JAX dry run's dataset, plan, relation types and seed rows."""
    from ..data import planted_partition
    from .halo import attach_spmm_plans, build_spatial_plan
    ds = planted_partition(512 * n_devices, 4, 32, avg_degree=4.0, seed=0,
                           train_per_class=4, num_val=8, num_test=8)
    plan = build_spatial_plan(ds.graph, n_devices, method="fennel", seed=0,
                              dense_threshold=16)
    plan = attach_spmm_plans(plan, te=64, flat_width=2 * 8 + 2 * 2)
    src, dst = ds.graph.host_edges()
    E = len(src)
    return {
        "n": ds.graph.num_nodes(), "src": src, "dst": dst,
        "features": ds.features, "labels": ds.labels,
        "train_mask": ds.train_mask, "num_classes": ds.num_classes,
        "plan": plan, "gspmd_dropout": gspmd_dropout,
        "etypes": np.random.default_rng(0).integers(0, 4, E).astype(
            np.int32),
        "seed_shards": np.random.default_rng(0).integers(
            0, ds.graph.num_nodes(), (n_devices, 8)).astype(np.int32),
    }


def _build(make, seed: int, *args, **kwargs):
    """``make()`` and one forward of it on the CPU, under ``seeded(seed)``,
    so that its lazy layers take their shapes and the same initial values
    on every rank."""
    from .halo import seeded
    with seeded(seed), torch.no_grad():
        module = make()
        module(*args, **kwargs)
    return module


def _load(module, params, name):
    if params is not None and name in params:
        module.load_state_dict(params[name])


def dryrun_rank(device, inputs: Dict, params: Optional[Dict] = None,
                phases=PHASES) -> Dict[str, float]:
    """The phases named in ``phases`` (every one by default) on this rank
    of the default group; their losses (the same on every rank)."""
    from .. import graph
    from ..interop import spatial_params_from_jax
    from ..models import GCN, GraphSAGE
    from ..nn import RelGraphConv
    from ..ops.rgcn import prepare_rgcn
    from ..sampling import MultiLayerNeighborSampler
    from .halo import (make_spatial_gat, make_spatial_gcn, make_spatial_rgcn,
                       shard_edata, shard_features, spatial_train_step)
    from .spmd import (make_mesh, make_sampled_dp_step, make_spmd_train_step,
                       sample_sharded_batch, shard_graph, shard_params,
                       shard_rows)
    n_dev = dist.get_world_size()
    rank = dist.get_rank()
    losses: Dict = {}
    g_host = graph((inputs["src"], inputs["dst"]), num_nodes=inputs["n"])
    g = g_host.to(device)
    X, Y, M = inputs["features"], inputs["labels"], inputs["train_mask"]
    C = inputs["num_classes"]
    Fin = X.shape[1]
    xcpu = torch.from_numpy(X)
    tp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(n_dev, tp=tp)
    losses["mesh"] = {"node": n_dev // tp, "tp": tp}

    def rows(a):
        return shard_rows(mesh, torch.from_numpy(a).to(device))

    # ---- phase 1: GCN over the ('node', 'tp') mesh
    if "gspmd" in phases:
        model = _build(lambda: GCN(32, C, dropout=inputs["gspmd_dropout"]),
                       0, g_host, xcpu, deterministic=True)
        _load(model, params, "gspmd")
        model.to(device)
        sp = shard_params(mesh, dict(model.named_parameters()))
        tx = torch.optim.AdamW(list(sp.values()), lr=1e-2,
                               weight_decay=1e-4)
        step = make_spmd_train_step(model, tx, mesh)
        gen = torch.Generator(device).manual_seed(0)
        losses["gspmd"] = float(step(sp, shard_graph(mesh, g), rows(X),
                                     rows(Y), rows(M), gen))

    # ---- phase 2: spatial GCN / GAT / R-GCN over the halo exchange
    plan = inputs["plan"]
    if {"spatial_halo", "spatial_gat", "spatial_rgcn"} & set(phases):
        dev = plan.device_arrays(rank, device)

        def own(a):
            return torch.from_numpy(shard_features(plan, a)[rank]).to(
                device)

        xs, ys, ms = own(X), own(Y), own(M)
    if "spatial_halo" in phases:
        init, forward = make_spatial_gcn(plan, None, hidden=16,
                                         out_feats=C)
        p = init(1, Fin, device)
        if params is not None and "spatial_halo" in params:
            with torch.no_grad():
                for k, v in spatial_params_from_jax(
                        params["spatial_halo"]).items():
                    p[k].copy_(v)
        sstep = spatial_train_step(forward, torch.optim.Adam(
            list(p.values()), lr=1e-2))
        losses["spatial_halo"] = float(sstep(p, xs, dev, ys, ms))
    if "spatial_gat" in phases:
        ginit, gfwd = make_spatial_gat(plan, None, hidden=8, out_feats=C,
                                       heads=(2, 1))
        gm = ginit(2, Fin, device)
        _load(gm, params, "spatial_gat")
        gstep = spatial_train_step(gfwd, torch.optim.Adam(gm.parameters(),
                                                          lr=1e-2))
        losses["spatial_gat"] = float(gstep(gm, xs, dev, ys, ms))
    if "spatial_rgcn" in phases:
        ets = torch.from_numpy(shard_edata(plan, inputs["etypes"],
                                           layout="graph")[rank]).to(device)
        rinit, rfwd = make_spatial_rgcn(plan, None, hidden=8, out_feats=C,
                                        num_rels=4, num_bases=2)
        rm = rinit(4, Fin, device)
        _load(rm, params, "spatial_rgcn")
        rstep = spatial_train_step(rfwd, torch.optim.Adam(
            rm.parameters(), lr=1e-2), n_extra=1)
        losses["spatial_rgcn"] = float(rstep(rm, xs, dev, ys, ms, ets))

    # ---- phase 2b: R-GCN over the (dst, etype)-pair plan
    if "rgcn_pair" in phases:
        et = torch.from_numpy(inputs["etypes"]).to(device)
        rplan = prepare_rgcn(g, et, 4, te=64)
        conv = _build(lambda: RelGraphConv(8, 4, num_bases=2), 5, g_host,
                      xcpu, torch.from_numpy(inputs["etypes"]))
        _load(conv, params, "rgcn_pair")
        conv.to(device)
        h = conv(g, rows(X).full(), et, plan=rplan)
        pair_loss = (h * h).mean()
        pair_loss.backward()
        losses["rgcn_pair"] = float(pair_loss.detach())

    # ---- phase 3: data-parallel sampled GraphSAGE
    if "sampled_dp" in phases:
        sampler = MultiLayerNeighborSampler([2, 2], replace=True, pad=True,
                                            seed=0)
        blocks, bx, by = sample_sharded_batch(g_host, sampler,
                                              inputs["seed_shards"], X, Y,
                                              rank, "cpu")
        model2 = _build(lambda: GraphSAGE(8, C, num_layers=2, dropout=0.0),
                        3, blocks, bx)
        _load(model2, params, "sampled_dp")
        model2.to(device)
        dp_step = make_sampled_dp_step(model2, torch.optim.Adam(
            model2.parameters(), lr=1e-2))
        losses["sampled_dp"] = float(dp_step(
            [b.to(device) for b in blocks], bx.to(device), by.to(device)))
    return losses


def format_line(n_devices: int, losses: Dict) -> str:
    """The JAX dry run's line."""
    return (f"dryrun_multichip({n_devices}): mesh={losses['mesh']} "
            + " ".join(f"{k}_loss={losses[k]:.4f}" for k in PHASES)
            + " OK")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "nccl", params: Optional[Dict] = None,
                     timeout: float = 600.0) -> Dict:
    """The dry run on ``n_devices`` local ranks over ``backend`` (NCCL
    needs a card a rank; gloo for the CPU or ranks that share a card).
    Prints the JAX function's line and returns rank 0's losses; every
    loss must be finite and equal on every rank."""
    from .launch import run_ranks
    if backend == "nccl" and (device != "cuda"
                              or torch.cuda.device_count() < n_devices):
        raise RuntimeError(f"NCCL needs a card a rank ({n_devices} ranks, "
                           f"{torch.cuda.device_count()} cards); pass "
                           "backend='gloo' for the CPU or ranks that share "
                           "a card")
    inputs = prepare(n_devices)
    if device == "cuda":
        from ..ops.cuda.build import library
        library()                  # built once here, loaded by the ranks
    out = run_ranks(n_devices, dryrun_rank, inputs, params, backend=backend,
                    device=device, timeout=timeout)
    for k in PHASES:
        vals = [o[k] for o in out]
        if not all(np.isfinite(v) for v in vals):
            raise RuntimeError(f"{k}: a loss is not finite: {vals}")
        if max(vals) - min(vals) > 1e-6 * max(1.0, abs(vals[0])):
            raise RuntimeError(f"{k}: the ranks disagree: {vals}")
    print(format_line(n_devices, out[0]))
    return out[0]
