"""Spatial (graph-partitioned) GCN training with a halo exchange on the
PyTorch port (twin of train_spatial.py; reference analogue:
apps/kg/distributed + contrib/graph_store.py workers).

One process per part (rank) over ``torch.distributed``: each rank holds
its part's rows of the plan (``SpatialPlan.device_arrays``), exchanges
its halo rows with an all_to_all every layer, and sums its gradients with
the other ranks' before an identical Adam step.  GraphConv's aggregation
runs K1 on the card.

Usage:
  python examples/train_spatial_torch.py --parts 8
      spawns 8 local ranks; NCCL (the default backend) needs a card a
      rank and raises otherwise;
  python examples/train_spatial_torch.py --parts 2 --backend gloo
      two ranks sharing the one card over gloo;
  python examples/train_spatial_torch.py --device cpu --backend gloo
      ranks on the CPU (the kernels' plain versions).
With the bootstrap's variables set (DGL_TPU_COORDINATOR, DGL_TPU_NUM_PROC,
DGL_TPU_PROC_ID, or DGL_TPU_IP_CONFIG) the process is one rank of that
group and spawns nothing.  Prints the JAX example's JSON line.  With no
card and no ``--device cpu`` it exits with an error.

``make_data``, ``train_rank`` (one rank's loop, which ``chip_smoke.py``
and the tests drive) and ``run`` (spawned ranks, from the JAX example's
initial parameters where given: ``interop.spatial_params_from_jax``) are
the pieces.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402


def make_data(nodes: int):
    """The JAX example's planted-partition graph."""
    from dgl_hack_tpu_torch.data import planted_partition
    return planted_partition(nodes, 6, 64, avg_degree=8.0, homophily=0.88,
                             feat_noise=1.5, seed=0, train_per_class=40,
                             num_val=300, num_test=600)


def train_rank(device, plan, features, labels, train_mask, epochs: int,
               hidden: int, lr: float, params=None, num_classes: int = 6):
    """This rank's training loop: spatial GCN from seed 0 (or ``params``),
    Adam, ``epochs`` steps.  Returns {"losses" (each step's global loss),
    "seconds" (the loop, synchronised), "logits" (every rank's rows,
    all-gathered: (P, n_owned_max, C))}."""
    import torch.distributed as dist
    from dgl_hack_tpu_torch.interop import spatial_params_from_jax
    from dgl_hack_tpu_torch.parallel import (make_spatial_gcn,
                                             shard_features,
                                             spatial_train_step)
    from dgl_hack_tpu_torch.parallel.collectives import all_gather
    rank = dist.get_rank()
    dev = plan.device_arrays(rank, device)

    def own(a):
        return torch.from_numpy(shard_features(plan, a)[rank]).to(device)

    xs, ys, ms = own(features), own(labels), own(train_mask)
    init, forward = make_spatial_gcn(plan, None, hidden=hidden,
                                     out_feats=num_classes)
    p = init(0, features.shape[1], device)
    if params is not None:
        with torch.no_grad():
            for k, v in spatial_params_from_jax(params).items():
                p[k].copy_(v)
    step = spatial_train_step(forward, torch.optim.Adam(list(p.values()),
                                                        lr=lr))
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        losses.append(step(p, xs, dev, ys, ms))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        logits = forward(p, xs, dev)
        full = all_gather(logits[None], None)
    return {"losses": [float(v) for v in losses], "seconds": seconds,
            "logits": full.cpu().numpy()}


def _check(args):
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu (with "
                           "--backend gloo) to run on the CPU")
    if args.backend == "nccl" and args.device != "cuda":
        raise RuntimeError("NCCL runs between cards; pass --backend gloo "
                           "for the CPU")
    if args.backend == "nccl" and torch.cuda.device_count() < args.parts:
        raise RuntimeError(f"NCCL needs a card a rank: {args.parts} ranks, "
                           f"{torch.cuda.device_count()} cards; pass "
                           "--backend gloo to share the cards")


def run(parts=8, epochs=60, hidden=32, nodes=4000, method="fennel",
        lr=1e-2, device="cuda", backend="nccl", params=None,
        timeout=600.0):
    """Spawn ``parts`` local ranks and train; returns rank 0's
    ``train_rank`` result with the plan and the dataset."""
    import importlib
    from dgl_hack_tpu_torch.parallel import build_spatial_plan
    from dgl_hack_tpu_torch.parallel.launch import run_ranks
    # the ranks import ``train_rank`` by this file's module name
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.append(here)
    rank_fn = importlib.import_module("train_spatial_torch").train_rank
    ds = make_data(nodes)
    plan = build_spatial_plan(ds.graph, parts, method=method)
    if device == "cuda":
        from dgl_hack_tpu_torch.ops.cuda.build import library
        library()                  # built once here, loaded by the ranks
    out = run_ranks(parts, rank_fn, plan, ds.features, ds.labels,
                    ds.train_mask, epochs, hidden, lr, params,
                    ds.num_classes, backend=backend, device=device,
                    timeout=timeout)
    return out[0], plan, ds


def _line(parts, res, plan, ds):
    from dgl_hack_tpu_torch.parallel import unshard_rows
    out = unshard_rows(plan, res["logits"], ds.graph.num_nodes())
    pred = out.argmax(-1)
    acc = float((pred[ds.test_mask] == ds.labels[ds.test_mask]).mean())
    return json.dumps({"parts": parts, "test_acc": acc,
                       "train_time_s": res["seconds"],
                       "loss": res["losses"][-1]})


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--nodes", type=int, default=4000)
    p.add_argument("--method", default="fennel")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    args = p.parse_args()
    _check(args)

    from dgl_hack_tpu_torch.distributed import initialize_from_env
    if any(k in os.environ for k in ("DGL_TPU_COORDINATOR",
                                     "DGL_TPU_IP_CONFIG")):
        import torch.distributed as dist
        from dgl_hack_tpu_torch.parallel import build_spatial_plan
        from dgl_hack_tpu_torch.parallel.launch import rank_device
        initialize_from_env(device=args.device, backend=args.backend)
        dev = rank_device(args.device, dist.get_rank())
        ds = make_data(args.nodes)
        plan = build_spatial_plan(ds.graph, dist.get_world_size(),
                                  method=args.method)
        res = train_rank(dev, plan, ds.features, ds.labels, ds.train_mask,
                         args.epochs, args.hidden, args.lr, None,
                         ds.num_classes)
        if dist.get_rank() == 0:
            print(_line(dist.get_world_size(), res, plan, ds))
        dist.destroy_process_group()
        return
    res, plan, ds = run(args.parts, args.epochs, args.hidden, args.nodes,
                        args.method, args.lr, args.device, args.backend)
    print(_line(args.parts, res, plan, ds))


if __name__ == "__main__":
    main()
