"""Cluster-GCN on the PyTorch port (twin of train_cluster_gcn.py;
reference: examples/pytorch/cluster_gcn, METIS clusters as batches).

``metis_partition`` (Fennel in METIS's role) splits synthetic Cora, the
JAX example's data, into ``--parts`` parts; each step trains GCN on one
part with self-loops added, one Adam over all parts in turn, and the
model is evaluated on the full graph.  The JAX example partitions with
``extra_cached_hops=0``, which gives parts with no edges (only the self
loops added here); ``make_batches(..., hops=1)`` keeps each part's
in-edges and their halo.  Every GraphConv runs K1 on the card.

Usage: python examples/train_cluster_gcn_torch.py --epochs 15 --parts 8
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_batches`` (or ``batches_of`` given the partitions), ``train``,
``full_graph`` and ``evaluate`` are the pieces, for callers
that drive them themselves (``chip_smoke.py``, the tests); ``train``
starts from parameters given as arrays (``interop.flax_to_state_dict`` of
the JAX example's) or from the layers' own initialisation under seed 0.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def make_batches(ds, parts, hops=0):
    """One batch per part of ``metis_partition(ds.graph, parts,
    extra_cached_hops=hops)``, as ``batches_of`` makes them."""
    from dgl_hack_tpu_torch.partition import metis_partition
    return batches_of(ds, metis_partition(ds.graph, parts,
                                          extra_cached_hops=hops))


def batches_of(ds, partitions):
    """Each ``Partition``'s batch, on the host: (its graph with self-loops,
    its rows of the features, labels and train mask)."""
    import dgl_hack_tpu_torch as dt
    X, y = np.asarray(ds.features), np.asarray(ds.labels)
    train_mask = np.asarray(ds.train_mask)
    batches = []
    for part in partitions:
        nid = np.asarray(part.node_map)
        batches.append((dt.add_self_loop(part.graph), X[nid], y[nid],
                        train_mask[nid]))
    return batches


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return device


def to_device(batches, device):
    """Each batch moved to ``device`` once, its graph readied by
    ``prepare_spmm`` (K1's row plans of both directions)."""
    import dgl_hack_tpu_torch as dt
    out = []
    for sub, x, y, m in batches:
        out.append((dt.prepare_spmm(sub, device=device),
                    torch.from_numpy(x).to(device),
                    torch.from_numpy(y).long().to(device),
                    torch.from_numpy(m).to(device)))
    return out


def build_model(hidden, classes, device, example, params=None):
    """The JAX example's GCN (two GraphConvs, relu, no dropout at
    train time: it applies the model deterministically), materialised on
    ``example`` (a batch) under seed 0 and loaded from ``params`` where
    given."""
    from dgl_hack_tpu_torch.models import GCN
    torch.manual_seed(0)
    model = GCN(hidden_feats=hidden, out_feats=classes).to(device)
    with torch.no_grad():
        model(example[0], example[1], deterministic=True)
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    return model


def train(ds, batches, *, hidden=32, lr=1e-2, epochs=15, params=None,
          device="cuda", max_steps=None, on_step=None):
    """Adam (the JAX example's ``optax.adam`` defaults) over the parts in
    turn, one part a step, ``epochs`` times (or ``max_steps`` steps).
    ``batches``: ``make_batches``'s host batches.  ``on_step(n)`` runs
    after step n's sync.  Returns the per-step losses and ms, the model
    and the batches on the device."""
    from dgl_hack_tpu_torch.models.training import masked_cross_entropy
    device = _check_device(device)
    dev_batches = to_device(batches, device)
    model = build_model(hidden, ds.num_classes, device, dev_batches[0],
                        params)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, step_ms = [], []
    steps = epochs * len(dev_batches) if max_steps is None else max_steps
    for n in range(steps):
        sub, x, y, m = dev_batches[n % len(dev_batches)]
        t0 = time.perf_counter()
        loss = masked_cross_entropy(model(sub, x, deterministic=True), y, m)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if on_step is not None:
            on_step(n + 1)
    return {"losses": losses, "step_ms": step_ms, "model": model,
            "batches": dev_batches}


def full_graph(ds, device="cuda"):
    """The JAX example's evaluation graph: the whole graph with self-loops
    added, on ``device``, readied by ``prepare_spmm``."""
    import dgl_hack_tpu_torch as dt
    device = _check_device(device)
    return dt.prepare_spmm(dt.add_self_loop(ds.graph), device=device)


@torch.no_grad()
def evaluate(model, g, ds):
    """Test accuracy of the model on ``full_graph``'s graph ``g``."""
    x = torch.from_numpy(np.asarray(ds.features)).to(g.device)
    pred = model(g, x, deterministic=True).argmax(-1).cpu().numpy()
    return float((pred == np.asarray(ds.labels))[np.asarray(ds.test_mask)]
                 .mean())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    from dgl_hack_tpu_torch.data import synthetic_cora
    ds = synthetic_cora(seed=0)
    batches = make_batches(ds, args.parts, hops=0)
    t0 = time.perf_counter()
    res = train(ds, batches, hidden=args.hidden, lr=args.lr,
                epochs=args.epochs, device=args.device)
    train_time = time.perf_counter() - t0
    acc = evaluate(res["model"], full_graph(ds, args.device), ds)
    print(json.dumps({"model": "ClusterGCN", "parts": args.parts,
                      "epochs": args.epochs, "test_acc": round(acc, 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
