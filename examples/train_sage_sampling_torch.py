"""Minibatch GraphSAGE with neighbor sampling on the PyTorch port (twin of
train_sage_sampling.py): per step the host samples one block per layer
(``MultiLayerNeighborSampler``, padded to static shapes, so every block
carries an edge mask), the blocks and the input rows go to the card, and
GraphSAGE trains on them through the segment-sum kernel (mean and gcn
aggregators), the segment-max kernels (pool) or an LSTM over each dst
node's padded mailbox in torch (lstm).

Usage: python examples/train_sage_sampling_torch.py --num-epochs 3
       [--aggregator mean|gcn|pool|lstm]   (the JAX example's is mean)
       [--prefetch none|thread|pool] [--num-workers 2]
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an
error.  The dataset is the JAX example's ``data.RedditDataset(scale=
--reddit-scale)``: the Reddit npz files where present, else the stand-in
at that share of its 232,965 nodes; the
sampler and the loaders are seeded as there.  ``train`` is the loop, for
callers that drive it themselves (``chip_smoke.py``).
"""
import argparse
import itertools
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(ds, *, fanouts=(10, 25), batch_size=1024, num_hidden=16,
          lr=3e-3, dropout=0.5, aggregator="mean", num_epochs=1,
          max_steps=None, eval_batches=None, device="cuda", seed=0,
          log=print, on_step=None, prefetch=None, num_workers=2,
          train_nids=None):
    """Train GraphSAGE on ``ds`` (a NodeClassificationDataset) over sampled
    blocks, then evaluate on its test nodes (at most 8,192, or
    ``eval_batches`` batches of them).

    Each step is timed in four parts, each ended by a device sync:
    ``sample_ms`` the host's sampling and block build (with a prefetcher,
    the wait for the next batch), ``copy_ms`` the blocks' copy to the
    device and the gather of the input rows and labels there,
    ``plan_ms`` the blocks' kernel plans (``prepare_spmm``: the real-edge
    view and the row plans), ``step_ms`` forward, backward and the Adam
    update.  ``max_steps`` stops training early.  ``on_step(n)``, where
    given, is called after the sync that ends the n-th step (1-based).

    ``prefetch`` samples ahead of the training loop and copies each batch
    to the device in worker threads: ``"thread"`` one thread over the
    loader (``ThreadedPrefetcher``, two batches ahead: the same batches in
    the same order), ``"pool"`` ``num_workers`` threads, each over its own
    shard of the training nodes with its own sampler, every node of a
    shard in a batch (``PooledPrefetcher``).  ``train_nids`` replaces the
    dataset's training nodes.  Returns the losses, the per-step times, the
    step count, the number of distinct seeds trained on and test_acc."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.models import GraphSAGE
    from dgl_hack_tpu_torch.models.training import masked_cross_entropy
    from dgl_hack_tpu_torch.distributed import (PooledPrefetcher,
                                                ThreadedPrefetcher)
    from dgl_hack_tpu_torch.sampling import (MultiLayerNeighborSampler,
                                             NodeDataLoader)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    g = ds.graph
    feats = torch.as_tensor(ds.features, dtype=torch.float32).to(device)
    labels = torch.as_tensor(ds.labels, dtype=torch.int64).to(device)
    model = GraphSAGE(hidden_feats=num_hidden, out_feats=ds.num_classes,
                      num_layers=len(fanouts), aggregator_type=aggregator,
                      dropout=dropout).to(device)
    sampler = MultiLayerNeighborSampler(fanouts, replace=True, seed=seed)
    train_nid = np.nonzero(ds.train_mask)[0] if train_nids is None \
        else np.asarray(train_nids)
    loader = NodeDataLoader(g, train_nid, sampler, batch_size,
                            drop_last=True, seed=seed)
    if prefetch == "thread":
        source = ThreadedPrefetcher(loader, capacity=2, device=device)
    elif prefetch == "pool":
        shards = np.array_split(train_nid, num_workers)

        def make_loader(i):
            return NodeDataLoader(
                g, shards[i], MultiLayerNeighborSampler(
                    fanouts, replace=True, seed=seed + 1000 + i),
                batch_size, drop_last=False, seed=seed + i)
        source = PooledPrefetcher(make_loader, num_workers=num_workers,
                                  capacity=4, device=device)
    elif prefetch is None:
        source = loader
    else:
        raise ValueError(f"prefetch must be None, 'thread' or 'pool', got "
                         f"{prefetch!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def batch_on_device(input_nodes, seeds, blocks, times):
        t = time.perf_counter()
        blocks = [b.to(device) for b in blocks]
        x = feats[torch.as_tensor(input_nodes).to(device).long()]
        y = labels[torch.as_tensor(seeds).to(device).long()]
        _sync(device)
        times["copy_ms"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        blocks = [dt.prepare_spmm(b) for b in blocks]
        _sync(device)
        times["plan_ms"].append(1e3 * (time.perf_counter() - t))
        return blocks, x, y

    times = {k: [] for k in ("sample_ms", "copy_ms", "plan_ms", "step_ms")}
    losses, opt, steps, seen = [], None, 0, []
    for epoch in range(num_epochs):
        t_epoch = time.perf_counter()
        it = iter(source)
        while max_steps is None or steps < max_steps:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            times["sample_ms"].append(1e3 * (time.perf_counter() - t))
            seen.append(torch.as_tensor(batch[1]).cpu().numpy())
            blocks, x, y = batch_on_device(*batch, times)
            if opt is None:
                with torch.no_grad():
                    model.eval()
                    model(blocks, x)        # materialise lazy parameters
                opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
            t = time.perf_counter()
            model.train()
            opt.zero_grad(set_to_none=True)
            logits = model(blocks, x, generator=gen)
            loss = masked_cross_entropy(logits, y, torch.ones_like(y))
            loss.backward()
            opt.step()
            _sync(device)
            times["step_ms"].append(1e3 * (time.perf_counter() - t))
            losses.append(float(loss.detach()))
            steps += 1
            if on_step is not None:
                on_step(steps)
        it.close()              # stops a prefetcher's workers
        if log is not None and losses:
            log(f"epoch {epoch}: {steps} batches, "
                f"{time.perf_counter() - t_epoch:.2f}s, loss {losses[-1]:.4f}")
        if max_steps is not None and steps >= max_steps:
            break

    # evaluate on test seeds, sampled as in training
    test_nid = np.nonzero(ds.test_mask)[0][:8192]
    eval_loader = NodeDataLoader(g, test_nid, sampler, batch_size,
                                 shuffle=False, seed=seed + 1)
    model.eval()
    correct = total = 0
    eval_times = {k: [] for k in ("copy_ms", "plan_ms")}
    with torch.no_grad():
        for input_nodes, seeds, blocks in itertools.islice(eval_loader,
                                                           eval_batches):
            blocks, x, _ = batch_on_device(input_nodes, seeds, blocks,
                                           eval_times)
            pred = model(blocks, x).argmax(-1).cpu().numpy()
            take = min(len(seeds), len(test_nid) - total)
            correct += int((pred[:take] == ds.labels[seeds[:take]]).sum())
            total += take
    return {"losses": losses, "steps": steps, "times": times,
            "distinct_seeds": int(len(np.unique(np.concatenate(seen))))
            if seen else 0,
            "test_acc": correct / max(total, 1), "test_nodes": total}


def main():
    p = argparse.ArgumentParser()
    # either name loads RedditDataset: the raw files under
    # DGL_DOWNLOAD_DIR where they are there, else the synthetic stand-in
    # at --reddit-scale (the JAX example reads no value from the flag)
    p.add_argument("--dataset", default="reddit-synth",
                   choices=["reddit-synth", "reddit"])
    p.add_argument("--reddit-scale", type=float, default=0.05)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--fan-out", default="10,25")
    p.add_argument("--num-hidden", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--aggregator", default="mean",
                   choices=["mean", "gcn", "pool", "lstm"])
    p.add_argument("--prefetch", default="none",
                   choices=["none", "thread", "pool"])
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    from dgl_hack_tpu_torch.data import RedditDataset
    ds = RedditDataset(scale=args.reddit_scale)
    res = train(ds, fanouts=[int(f) for f in args.fan_out.split(",")],
                batch_size=args.batch_size, num_hidden=args.num_hidden,
                lr=args.lr, dropout=args.dropout, aggregator=args.aggregator,
                num_epochs=args.num_epochs, device=args.device,
                prefetch=None if args.prefetch == "none" else args.prefetch,
                num_workers=args.num_workers)
    print(json.dumps({"dataset": ds.name, "test_acc": float(res["test_acc"])}))


if __name__ == "__main__":
    main()
