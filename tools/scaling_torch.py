"""Scaling harness of the PyTorch port's spatial (halo-exchange) path (twin
of tools/scaling.py).

Runs the spatial halo gspmm step at P = 1/2/4/8 partitions, one process a
rank over ``torch.distributed`` (``parallel.launch.RankPool``), and prints
ONE JSON line per P with:
  * edges/s and the step's ms: each rank times the chain ``h =
    halo_gspmm(h) * 1e-3`` with ``utils.profiling.timed_loop`` (CUDA
    events on the card, two loop lengths whose difference cancels launch
    and readback latency); the step is the slowest rank's;
  * the halo gspmm's rows against the single-process gspmm over the whole
    graph (``rel_err_vs_single``; ``ok``);
  * bytes moved by the exchange per step (``_exchange_bytes``: the padded
    pairwise all_to_all and the hub all_gather, tools/scaling.py's
    formula) and the plan's padding factors and edge-cut;
then full spatial GAT / R-GCN train steps at ``--model-parts`` with
per-layer exchange bytes, and a fennel-vs-random comparison of plans on a
clustered graph.

Backends.  ``--backend`` defaults to ``nccl``, one rank a card, as
examples/train_spatial_torch.py does; a P with more ranks than cards is
skipped with its reason.  ``gloo`` must be asked for: under it the ranks
may share a card.  The backend is never switched.  Every row carries
``backend`` and ``ranks_share_card``; a row whose ranks share the card
(or the CPU) reports ``shared_card_efficiency`` (``shared_cpu_efficiency``)
where tools/scaling.py reports ``cpu_emulation_efficiency``: that is not
a scaling number.  Only ranks on cards of their own give
``scaling_efficiency``.

Projection.  ``project_link`` is tools/scaling.py's ``project_ici`` with
no TPU constant in it: its per-edge rate comes from this run's P = 1 row
(the copy_u rows) or P = 1 model row, and its link throughput from
``--link-gbps``, which has no default; without it no projection is
printed.

Usage:
  python tools/scaling_torch.py --parts 1 --models        # one card, NCCL
  python tools/scaling_torch.py --backend gloo --parts 1 2 --models gat \\
      --model-nodes 20000 --model-parts 2   # ranks sharing one card
  python tools/scaling_torch.py --device cpu --backend gloo --parts 1 2
Without a card it raises unless given ``--device cpu`` (with ``--backend
gloo``).
"""
import argparse
import contextlib
import importlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
# the spawned ranks import this module's rank functions by its name, so
# tools/ is on the path they inherit from here
if HERE not in sys.path:
    sys.path.append(HERE)

WIRE_BYTES = {"f32": 4, "bf16": 2}
# seconds a call of the ranks may take before the pool stops them
RANK_TIMEOUT_S = 600.0
HEADS = (4, 1)
# fennel vs random on a clustered graph, tools/scaling.py's methods
COMPARE_METHODS = ("random", "fennel-nodes", "fennel", "fennel-refine",
                   "multilevel")


def project_link(st, width_words: int, ns_per_edge: float,
                 link_gbps: float, wire_bytes: int = 4):
    """Analytic step and efficiency of one spatial plan on ranks joined by
    links of ``link_gbps`` GB/s each: per-rank step = max(local reduce,
    exchange) + remote reduce, against the unpartitioned step at
    ``ns_per_edge`` (this run's P = 1 rate).  tools/scaling.py's
    ``project_ici``, formula for formula."""
    P_ = st["num_parts"]
    if P_ <= 1:
        return {"proj_efficiency": 1.0,
                "proj_step_ms": st["edges_real"] * ns_per_edge * 1e-6}
    e_pad_dev = st["edges_padded"] / P_
    cut = st["cut_fraction"]
    t_local = e_pad_dev * (1 - cut) * ns_per_edge * 1e-9
    t_remote = e_pad_dev * cut * ns_per_edge * 1e-9
    rows_dev = (st["halo_rows_padded"] + P_ * st.get("hub_rows_padded", 0)
                ) / P_
    bytes_dev = rows_dev * width_words * wire_bytes
    t_comm = bytes_dev / (link_gbps * 1e9)
    t_step = max(t_local, t_comm) + t_remote
    t_single = st["edges_real"] * ns_per_edge * 1e-9
    return {
        "proj_efficiency": t_single / (P_ * t_step),
        "proj_step_ms": t_step * 1e3,
        "proj_comm_ms": t_comm * 1e3,
        "proj_local_ms": t_local * 1e3,
        "proj_comm_hidden": bool(t_comm <= t_local),
        "proj_link_gbps": link_gbps,
    }


def _exchange_bytes(plan, width):
    """Padded bytes one halo exchange of a width-``width`` f32 activation
    moves across the fabric: pairwise all_to_all + hub all_gather."""
    P_ = plan.num_parts
    return int((P_ ** 2 * plan.s_max + P_ ** 2 * plan.hk_max) * width * 4)


def copy_bytes(plan, width, wire="f32"):
    """All_to_all bytes a step of the copy_u halo gspmm at ``width``."""
    return _exchange_bytes(plan, width) * WIRE_BYTES[wire] // 4


def layer_widths(model, feats, hidden, heads=HEADS):
    """The activation width each layer of a spatial model exchanges."""
    if model == "gat":
        return [feats, hidden * heads[0]]
    if model == "rgcn":
        return [feats, hidden]
    raise ValueError(model)


def model_bytes(plan, widths, wire="f32"):
    """(per-layer forward bytes, bytes a train step: forward and the
    transposed backward)."""
    per_layer = [_exchange_bytes(plan, w) * WIRE_BYTES[wire] // 4
                 for w in widths]
    return per_layer, 2 * sum(per_layer)


def plan_stats(plan):
    """``plan.stats()`` with the keys tools/scaling.py's rows read."""
    st = plan.stats()
    return {k: st[k] for k in (
        "num_parts", "edges_real", "edges_padded", "edge_pad_factor",
        "halo_rows_real", "halo_rows_padded", "halo_pad_factor",
        "cut_fraction", "hub_rows", "hub_rows_padded")}


def _comm_dtype(wire):
    return torch.bfloat16 if wire == "bf16" else None


# ---------------------------------------------------------------------------
# rank functions (imported by name in the spawned ranks)
# ---------------------------------------------------------------------------
def _spatial_rank(device, plan, x, wire, k_lo, k_hi, reps):
    """This rank's halo gspmm (copy_u sum, overlap on): its output rows
    once, and the seconds an iteration of the timed chain."""
    import torch.distributed as dist
    from dgl_hack_tpu_torch.parallel import make_halo_gspmm, shard_features
    from dgl_hack_tpu_torch.utils.profiling import timed_loop
    r = dist.get_rank()
    dev = plan.device_arrays(r, device)
    xs = torch.from_numpy(shard_features(plan, x)[r]).to(device)
    halo_fn = make_halo_gspmm(plan, None, reduce_op="sum", overlap=True,
                              comm_dtype=_comm_dtype(wire))
    with torch.no_grad():
        out = halo_fn(xs, dev)
        step_s = timed_loop(lambda h: halo_fn(h, dev) * 1e-3, xs,
                            k_lo=k_lo, k_hi=k_hi, repeats=reps)
    return {"out": out.cpu().numpy(), "step_s": step_s}


def _model_rank(device, plan, model, x, labels, etypes, hidden,
                num_classes, num_rels, wire, k_lo, k_hi, reps):
    """This rank's spatial model train step (forward, backward, SGD at lr
    1e-4 after the ranks' gradients are summed): the first step's loss and
    the seconds a step of the timed chain."""
    import torch.distributed as dist
    from dgl_hack_tpu_torch.parallel import (make_spatial_gat,
                                             make_spatial_rgcn,
                                             shard_edata, shard_features,
                                             spatial_train_step)
    from dgl_hack_tpu_torch.utils.profiling import timed_loop
    r = dist.get_rank()
    dev = plan.device_arrays(r, device)

    def own(a):
        return torch.from_numpy(shard_features(plan, a)[r]).to(device)

    xs, ys = own(x), own(labels)
    ms = own(np.ones(x.shape[0], bool))
    cd = _comm_dtype(wire)
    if model == "gat":
        init, fwd = make_spatial_gat(plan, None, hidden=hidden,
                                     out_feats=num_classes, heads=HEADS,
                                     comm_dtype=cd)
        extras = ()
    elif model == "rgcn":
        init, fwd = make_spatial_rgcn(plan, None, hidden=hidden,
                                      out_feats=num_classes,
                                      num_rels=num_rels, num_bases=4,
                                      comm_dtype=cd)
        extras = (torch.from_numpy(shard_edata(
            plan, etypes, layout="graph")[r]).to(device),)
    else:
        raise ValueError(model)
    params = init(0, x.shape[1], device)
    step = spatial_train_step(fwd, torch.optim.SGD(params.parameters(),
                                                   lr=1e-4),
                              n_extra=len(extras))
    loss = float(step(params, xs, dev, ys, ms, *extras))
    step_s = timed_loop(
        lambda h: (step(params, xs, dev, ys, ms, *extras), h)[1],
        torch.zeros(1, device=device), k_lo=k_lo, k_hi=k_hi, repeats=reps)
    return {"loss": loss, "step_s": step_s}


def _rank_fns():
    """This module's rank functions as the spawned ranks import them: by
    the module's name (a rank pool must start after this module is
    imported, so that its ranks have tools/ on their path)."""
    mod = importlib.import_module("scaling_torch")
    return mod._spatial_rank, mod._model_rank


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------
def setting(device, p):
    """(ranks_share_card, the name of the efficiency) of P ranks."""
    if device == "cpu":
        return False, "shared_cpu_efficiency"
    share = p > torch.cuda.device_count()
    return share, ("shared_card_efficiency" if share
                   else "scaling_efficiency")


def run_spatial(g, x, p, method, pool, device="cuda", backend="nccl",
                reps=3, k_lo=2, k_hi=8, hub_k=0, wire="f32"):
    """The halo gspmm step at P = ``p`` on ``pool``'s ranks: (row, the
    output rows in global order, the plan's stats)."""
    from dgl_hack_tpu_torch.ops.spmm import gspmm
    from dgl_hack_tpu_torch.parallel import build_spatial_plan, unshard_rows
    spatial_rank, _ = _rank_fns()
    plan = build_spatial_plan(g, p, method=method, seed=0, hub_k=hub_k)
    res = pool.run(spatial_rank, plan, x, wire, k_lo, k_hi, reps)
    out = unshard_rows(plan, np.stack([r_["out"] for r_ in res]),
                       g.num_nodes())
    gd = g.to(device)
    with torch.no_grad():
        ref = gspmm(gd, "copy_lhs", "sum", torch.from_numpy(x).to(device))
        err = (torch.from_numpy(out).to(device) - ref).abs()
        rel = float(err.max() / ref.abs().max().clamp(min=1e-30))
        if wire == "bf16":
            # each shipped row rounded once to bf16: |err| <= 2^-8 of the
            # row's sum of |terms|
            lim = 2.0 ** -8 * gspmm(gd, "copy_lhs", "sum",
                                    torch.from_numpy(np.abs(x)).to(device))
            ok = bool((err <= lim + 1e-6).all())
        else:
            ok = rel <= 1e-5
    step_s = max(r_["step_s"] for r_ in res)
    st = plan_stats(plan)
    row = {
        "P": p, "method": method, "hub_k": hub_k, "backend": backend,
        "device": device, "ranks_share_card": setting(device, p)[0],
        "edges_per_s": g.num_edges() / step_s,
        "step_ms": step_s * 1e3,
        "step_ms_per_rank": [r_["step_s"] * 1e3 for r_ in res],
        "comm_dtype": wire,
        "a2a_bytes_per_step": copy_bytes(plan, x.shape[1], wire),
        "a2a_real_rows": st["halo_rows_real"],
        "halo_rows_padded": st["halo_rows_padded"],
        "hub_rows_padded": st["hub_rows_padded"],
        "edge_pad_factor": st["edge_pad_factor"],
        "halo_pad_factor": st["halo_pad_factor"],
        "cut_fraction": st["cut_fraction"],
        "plan_build_s": plan.build_seconds,
        "rel_err_vs_single": rel, "ok": ok}
    return row, out, st


def run_spatial_model(model, g, x, p, method, pool, device="cuda",
                      backend="nccl", hub_k=0, num_rels=8, hidden=32,
                      num_classes=8, reps=2, k_lo=1, k_hi=3, wire="f32"):
    """A full spatial model train step (forward, backward, SGD) at P =
    ``p``, with per-layer exchange bytes (each layer's halo rides its
    activation width; the backward ships the same bytes back): (row, the
    plan's stats)."""
    from dgl_hack_tpu_torch.parallel import build_spatial_plan
    _, model_rank = _rank_fns()
    rng = np.random.default_rng(0)
    n, F = g.num_nodes(), x.shape[1]
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    etypes = rng.integers(0, num_rels, g.num_edges()).astype(np.int32) \
        if model == "rgcn" else None
    plan = build_spatial_plan(g, p, method=method, seed=0, hub_k=hub_k)
    res = pool.run(model_rank, plan, model, x, labels, etypes, hidden,
                   num_classes, num_rels, wire, k_lo, k_hi, reps)
    step_s = max(r_["step_s"] for r_ in res)
    per_layer, per_step = model_bytes(
        plan, layer_widths(model, F, hidden), wire)
    st = plan_stats(plan)
    return {
        "model": model, "P": p, "method": method, "hub_k": hub_k,
        "backend": backend, "device": device,
        "ranks_share_card": setting(device, p)[0],
        "nodes": n, "edges": g.num_edges(),
        "step_ms": step_s * 1e3,
        "step_ms_per_rank": [r_["step_s"] * 1e3 for r_ in res],
        "edges_per_s": g.num_edges() / step_s,
        "loss": res[0]["loss"], "ok": bool(np.isfinite(res[0]["loss"])),
        "comm_dtype": wire,
        "a2a_bytes_per_layer_fwd": per_layer,
        "a2a_bytes_per_step": per_step,
        "halo_rows_padded": st["halo_rows_padded"],
        "hub_rows_padded": st["hub_rows_padded"],
        "edge_pad_factor": st["edge_pad_factor"],
        "halo_pad_factor": st["halo_pad_factor"],
        "cut_fraction": st["cut_fraction"],
        "plan_build_s": plan.build_seconds}, st


def _check(args):
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu (with "
                           "--backend gloo) to run on the CPU")
    if args.backend == "nccl" and args.device != "cuda":
        raise RuntimeError("NCCL runs between cards; pass --backend gloo "
                           "for the CPU")


def _fits(args, p):
    """None, or why P ranks cannot run on this backend here."""
    if args.backend == "nccl" and p > torch.cuda.device_count():
        return (f"NCCL needs a card a rank: {p} ranks, "
                f"{torch.cuda.device_count()} cards; pass --backend gloo "
                "to share the cards")
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--avg-degree", type=float, default=16.0)
    ap.add_argument("--feats", type=int, default=128)
    ap.add_argument("--parts", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--method", default="fennel")
    ap.add_argument("--clustered-nodes", type=int, default=100000,
                    help="size of the fennel-vs-random comparison graph")
    ap.add_argument("--skip-compare", action="store_true")
    ap.add_argument("--hub-k", type=int, default=0)
    ap.add_argument("--models", nargs="*", default=["gat", "rgcn"],
                    help="full spatial models to time at --model-nodes")
    ap.add_argument("--model-nodes", type=int, default=100000)
    ap.add_argument("--model-parts", type=int, nargs="*", default=[8],
                    help="partition counts of the model rows (a 1 among "
                         "them gives the model projection its rate)")
    ap.add_argument("--comm-dtype", default="bf16", choices=["f32", "bf16"],
                    help="wire precision of the halo activations")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="per-rank link throughput for the projection "
                         "(no default: without it nothing is projected)")
    ap.add_argument("--project-parts", type=int, nargs="*",
                    default=[16, 32],
                    help="plan-only projections at larger P (with "
                         "--link-gbps and a P = 1 row)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = ap.parse_args()
    _check(args)

    from dgl_hack_tpu_torch.data import (planted_partition,
                                         random_power_law_graph)
    from dgl_hack_tpu_torch.parallel import build_spatial_plan
    from dgl_hack_tpu_torch.parallel.launch import RankPool
    if args.device == "cuda":
        from dgl_hack_tpu_torch.ops.cuda.build import library
        library()                  # built once here, loaded by the ranks

    g = random_power_law_graph(args.nodes, avg_degree=args.avg_degree,
                               alpha=2.1, seed=0)
    x = np.random.default_rng(0).normal(
        size=(args.nodes, args.feats)).astype(np.float32)
    wire = args.comm_dtype
    bad = []
    pools = {}

    def pool_of(stack, p):
        if p not in pools:
            pools[p] = stack.enter_context(RankPool(
                p, args.backend, args.device, timeout=RANK_TIMEOUT_S))
        return pools[p]

    with contextlib.ExitStack() as stack:
        ns_copy = None
        base = None
        for p in sorted(args.parts):
            why = _fits(args, p)
            if why:
                print(json.dumps({"P": p, "skipped": why}), flush=True)
                continue
            r, _, st = run_spatial(g, x, p, args.method, pool_of(stack, p),
                                   args.device, args.backend,
                                   hub_k=args.hub_k, wire=wire)
            if p == 1:
                ns_copy = r["step_ms"] * 1e6 / g.num_edges()
            if base is None:
                base = r["edges_per_s"] / r["P"]
            r[setting(args.device, p)[1]] = r["edges_per_s"] / (p * base)
            if ns_copy is not None and args.link_gbps:
                r.update(project_link(st, args.feats, ns_copy,
                                      args.link_gbps, WIRE_BYTES[wire]))
            bad += [] if r["ok"] else [f"P={p}"]
            print(json.dumps(r), flush=True)

        # plan-only projections at larger P (host stats, no ranks)
        if ns_copy is not None and args.link_gbps:
            for p in args.project_parts or []:
                plan = build_spatial_plan(g, p, method=args.method, seed=0,
                                          hub_k=args.hub_k)
                st = plan_stats(plan)
                pr = project_link(st, args.feats, ns_copy, args.link_gbps,
                                  WIRE_BYTES[wire])
                pr.update({"projection_only": True, "P": p,
                           "method": args.method,
                           "cut_fraction": st["cut_fraction"],
                           "edge_pad_factor": st["edge_pad_factor"],
                           "ns_per_edge_from_P1": ns_copy})
                print(json.dumps(pr), flush=True)

        if args.models:
            gm = random_power_law_graph(args.model_nodes, avg_degree=8.0,
                                        alpha=2.1, seed=1)
            xm = np.random.default_rng(1).normal(
                size=(args.model_nodes, args.feats)).astype(np.float32)
            for model in args.models:
                ns_model = None
                for p in sorted(args.model_parts):
                    why = _fits(args, p)
                    if why:
                        print(json.dumps({"model": model, "P": p,
                                          "skipped": why}), flush=True)
                        continue
                    r, st = run_spatial_model(
                        model, gm, xm, p, args.method, pool_of(stack, p),
                        args.device, args.backend, hub_k=args.hub_k,
                        wire=wire)
                    if p == 1:
                        ns_model = r["step_ms"] * 1e6 / r["edges"]
                    if ns_model is not None and args.link_gbps:
                        # forward and backward, 2 layers at the widest
                        r.update(project_link(
                            st, 2 * 2 * max(layer_widths(model, args.feats,
                                                         32)),
                            ns_model, args.link_gbps, WIRE_BYTES[wire]))
                    bad += [] if r["ok"] else [f"{model} P={p}"]
                    print(json.dumps(r), flush=True)

    if not args.skip_compare:
        # fennel vs random on a clustered graph: cut quality and the
        # padding it buys.  The partition seed differs from the dataset's:
        # with equal seeds 'random' recovers the planted communities
        ds = planted_partition(args.clustered_nodes, 8, 8, avg_degree=12.0,
                               homophily=0.9, seed=0, train_per_class=8)
        for method in COMPARE_METHODS:
            st = plan_stats(build_spatial_plan(ds.graph, 8, method=method,
                                               seed=7))
            print(json.dumps({
                "compare": method, "nodes": args.clustered_nodes,
                "cut_fraction": st["cut_fraction"],
                "halo_rows_real": st["halo_rows_real"],
                "halo_pad_factor": st["halo_pad_factor"],
                "edge_pad_factor": st["edge_pad_factor"]}), flush=True)
    if bad:
        raise SystemExit(f"scaling_torch: rows not ok: {bad}")


if __name__ == "__main__":
    main()
