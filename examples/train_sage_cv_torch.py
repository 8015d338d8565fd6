"""GraphSAGE with control-variate (history) sampling on the PyTorch port
(twin of train_sage_cv.py; DGL: examples/pytorch/graphsage/train_cv.py,
VR-GCN-style variance reduction).

Per layer l the estimator is
    h_neigh = AGG_full(hist_l) + AGG_sampled(h - hist_l)
so only the change from the running history is sampled: the history
mean over the full in-neighborhood is exact (a host numpy segment mean),
the sampled part is gspmm mean over a padded block (``to_block`` with
``pad_num_src``/``pad_num_edges``: on the card the segment-sum kernel
through the block's real-edge view).  After each step the dst nodes' new
activations refresh the history.  Evaluation is full-graph exact
inference (gspmm mean over the whole graph).

Usage: python examples/train_sage_cv_torch.py --epochs 15
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an
error.  The dataset is the JAX example's planted-partition stand-in for
Reddit; the sampler and the batch order are seeded as there.
``CVSampler``, ``init_params`` and ``train`` are the steps, for callers
that drive them themselves (``chip_smoke.py``).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


class CVSampler:
    """One padded block per layer (``sample_neighbors`` with replacement,
    then ``to_block``), with each layer's src and dst node ids, which the
    history needs."""

    def __init__(self, fanouts, seed=0):
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, g, seeds):
        from dgl_hack_tpu_torch.core.transform import to_block
        from dgl_hack_tpu_torch.sampling.neighbor import (_round_up_pow2,
                                                          sample_neighbors)
        blocks, layer_dst, layer_src = [], [], []
        cur = np.asarray(seeds, np.int32)
        for fanout in reversed(self.fanouts):
            frontier, _ = sample_neighbors(g, cur, fanout, replace=True,
                                           rng=self.rng)
            cap = len(cur) * fanout
            blk, src_ids, dst_ids = to_block(
                frontier, cur, pad_num_src=_round_up_pow2(len(cur) + cap),
                pad_num_edges=cap)
            blocks.insert(0, blk)
            layer_dst.insert(0, dst_ids)
            layer_src.insert(0, src_ids)
            cur = src_ids
        return blocks, layer_src, layer_dst


def exact_hist_mean(g, seeds, hist):
    """Mean of ``hist`` over the full in-neighborhood of each seed."""
    indptr = g.host("csc_indptr")
    src = g.host("src")
    out = np.zeros((len(seeds), hist.shape[1]), hist.dtype)
    for i, v in enumerate(np.asarray(seeds)):
        lo, hi = indptr[v], indptr[v + 1]
        if hi > lo:
            out[i] = hist[src[lo:hi]].mean(0)
    return out


def init_params(dims, seed=0):
    """Each layer's (kernel (2 * in, out), bias) in numpy, glorot-uniform
    kernels and zero biases, as flax's Dense initialises them."""
    rng = np.random.default_rng(seed)
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (2 * din + dout))
        params.append((rng.uniform(-lim, lim, (2 * din, dout)).astype(
            np.float32), np.zeros(dout, np.float32)))
    return params


def _forward(blocks, x, hist_srcs, agg_hists, params):
    """The SAGE-CV layers: h_neigh = agg_hist + mean over the block of
    (h - hist), then dense over [h_dst, h_neigh], relu but on the last.
    Returns the logits and each layer's output."""
    import dgl_hack_tpu_torch as dt
    h, outs = x, []
    for l, (blk, (W, b)) in enumerate(zip(blocks, params)):
        h_dst = h[:blk.num_dst_nodes]
        h_neigh = agg_hists[l] + dt.gspmm(blk, "copy_lhs", "mean",
                                          h - hist_srcs[l])
        h = torch.cat([h_dst, h_neigh], 1) @ W + b
        if l < len(blocks) - 1:
            h = torch.relu(h)
        outs.append(h)
    return h, outs


def train(ds, params, *, fanouts=(2, 2), batch_size=128, epochs=15,
          lr=1e-2, seed=0, device="cuda", max_steps=None):
    """Train on ``ds`` (a NodeClassificationDataset) from ``params``
    (``init_params``).  Returns the per-step losses and times (host
    sampling and history ms, device step ms, each ended by a sync), the
    trained parameters and the full-graph test accuracy."""
    import dgl_hack_tpu_torch as dt
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    g = ds.graph
    feats = ds.features.astype(np.float32)
    n_layers = len(fanouts)
    dims = [feats.shape[1]] + [W.shape[1] for W, _ in params]
    prm = [tuple(torch.nn.Parameter(torch.as_tensor(a, device=device)
                                    .clone()) for a in layer)
           for layer in params]
    opt = torch.optim.Adam([p for layer in prm for p in layer], lr=lr,
                           eps=1e-8)
    sampler = CVSampler(fanouts, seed=seed)
    train_nid = np.nonzero(ds.train_mask)[0]
    # hist[0] is the raw features (never refreshed), hist[l >= 1] layer
    # l's activations, from zeros
    hists = [feats] + [np.zeros((g.num_nodes(), dims[l + 1]), np.float32)
                       for l in range(n_layers - 1)]
    # the JAX example draws its model.init batch first; drawn here too, so
    # that the sampler's generator stays in step with it
    sampler.sample(g, train_nid[:batch_size])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(seed)
    losses = []
    times = {"host_ms": [], "step_ms": []}
    for _ in range(epochs):
        order = rng.permutation(len(train_nid))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            if max_steps is not None and len(losses) >= max_steps:
                break
            t0 = time.perf_counter()
            seeds = train_nid[order[i:i + batch_size]]
            blocks, srcs, dsts = sampler.sample(g, seeds)
            ah = [exact_hist_mean(g, dsts[l], hists[l])
                  for l in range(n_layers)]
            blocks = [b.to(device) for b in blocks]
            x = dev(feats[srcs[0]])
            hs = [dev(hists[l][srcs[l]]) for l in range(n_layers)]
            ah = [dev(a) for a in ah]
            y = dev(ds.labels[seeds].astype(np.int64))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            logits, new_hists = _forward(blocks, x, hs, ah, prm)
            loss = F.cross_entropy(logits, y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            for l in range(n_layers - 1):
                hists[l + 1][dsts[l]] = new_hists[l].detach().cpu().numpy()
            losses.append(float(loss.detach()))
            times["host_ms"].append(1e3 * (t1 - t0))
            times["step_ms"].append(1e3 * (time.perf_counter() - t1))

    # full-graph exact inference with the trained weights
    with torch.no_grad():
        gd = g.to(device)
        h = dev(feats)
        for l, (W, b) in enumerate(prm):
            h = torch.cat([h, dt.gspmm(gd, "copy_lhs", "mean", h)], 1) @ W + b
            if l < n_layers - 1:
                h = torch.relu(h)
        pred = h.argmax(-1).cpu().numpy()
    test_acc = float((pred[ds.test_mask] == ds.labels[ds.test_mask]).mean())
    return {"losses": losses, "times": times, "test_acc": test_acc,
            "params": [tuple(p.detach().cpu().numpy() for p in layer)
                       for layer in prm]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--nodes", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--fan-out", default="2,2")
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    from dgl_hack_tpu_torch.data import planted_partition
    ds = planted_partition(args.nodes, 5, 32, avg_degree=10.0,
                           homophily=0.85, feat_noise=1.5, seed=args.seed,
                           train_per_class=60, num_val=100, num_test=400)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    dims = [ds.features.shape[1]] + [args.hidden] * (len(fanouts) - 1) \
        + [ds.num_classes]
    res = train(ds, init_params(dims, args.seed), fanouts=fanouts,
                batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                seed=args.seed, device=args.device)
    print(json.dumps({"dataset": ds.name, "test_acc": res["test_acc"],
                      "epochs": args.epochs, "loss": res["losses"][-1]}))


if __name__ == "__main__":
    main()
