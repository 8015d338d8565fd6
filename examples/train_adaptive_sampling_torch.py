"""Adaptive (importance) layer-sampling GCN on the PyTorch port (twin of
train_adaptive_sampling.py; DGL: examples/pytorch/adaptive_sampling).

Each layer samples a fixed-size node set on the host, drawn with
degree-proportional importance q, and reweights each message by
1 / (S * q_norm(u)) divided by the seed's degree, so that the
aggregation (a ``segment_reduce`` sum over padded, fixed-size edge
lists) estimates the full-graph mean layer without bias.  Evaluation runs
the same weights on the full graph through gspmm mean (the segment-sum
kernel on the card).  The parameters, the seeds and every sample come
from one numpy generator seeded as in the JAX example.

Usage: python examples/train_adaptive_sampling_torch.py --epochs 150
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an
error.  ``train`` is the loop, for callers that drive it themselves
(``chip_smoke.py``).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


class LayerSampler:
    """The JAX example's ``sample_layer`` over one graph's CSC arrays."""

    def __init__(self, g, batch_size, layer_size, rng):
        self.indptr = g.host("csc_indptr").astype(np.int64)
        self.src = g.host("src").astype(np.int64)
        self.deg = np.maximum(np.diff(self.indptr), 1).astype(np.float64)
        self.n = g.num_nodes()
        self.B, self.S, self.rng = batch_size, layer_size, rng

    def __call__(self, seeds):
        """Importance-sample S sources for the seeds' in-edges.  Returns
        (the sampled sources padded to S, and the edges padded to B * 32:
        local src, local dst (position in ``seeds``), weight)."""
        ip, src, deg, rng = self.indptr, self.src, self.deg, self.rng
        S, n = self.S, self.n
        pos = np.concatenate([np.arange(ip[v], ip[v + 1]) for v in seeds])
        cand = np.unique(src[pos])
        q = deg[cand] / deg[cand].sum()
        take = min(S, len(cand))
        sel = rng.choice(len(cand), size=take, replace=False, p=q)
        chosen = cand[sel]
        w_node = 1.0 / (take * q[sel])
        lut = np.full(n, -1, np.int64)
        lut[chosen] = np.arange(take)
        keep = lut[src[pos]] >= 0
        pos_k = pos[keep]
        dst_k = np.repeat(seeds, np.diff(ip)[seeds])[keep]
        src_loc = lut[src[pos_k]]
        w_edge = (w_node[src_loc] / deg[dst_k]).astype(np.float32)
        e_cap = self.B * 32
        e = len(pos_k)
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


def _agg(h_src, src, dst, w, num_dst):
    """The weighted-mean estimator: a segment sum of weighted messages."""
    import dgl_hack_tpu_torch as dt
    msg = h_src[src] * w[:, None]
    return dt.segment.segment_reduce("sum", msg, dst, num_dst)


def train(ds, *, epochs=150, batch_size=256, layer_size=256, hidden=32,
          lr=1e-2, device="cuda", log=print):
    """Train on ``ds`` with one numpy generator (seed 0) drawing the
    parameters, then each epoch's seeds and samples.  Returns the losses,
    per-epoch host (sampling) and device ms (each ended by a sync), the
    training seconds, the parameters and the full-graph test accuracy."""
    import dgl_hack_tpu_torch as dt
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    g = ds.graph
    feats = np.asarray(ds.features, np.float32)
    labels = np.asarray(ds.labels, np.int64)
    F_in, C = feats.shape[1], ds.num_classes
    rng = np.random.default_rng(0)
    train_ids = np.nonzero(np.asarray(ds.train_mask))[0]
    B, S = batch_size, layer_size
    sample_layer = LayerSampler(g, B, S, rng)

    def init_dense(shape):
        return (rng.normal(size=shape)
                * (2.0 / sum(shape)) ** 0.5).astype(np.float32)

    prm = {k: torch.nn.Parameter(torch.from_numpy(init_dense(s)).to(device))
           for k, s in (("W1", (F_in, hidden)), ("W2", (hidden, C)))}
    opt = torch.optim.Adam(prm.values(), lr=lr, eps=1e-8)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    losses, times = [], {"host_ms": [], "step_ms": []}
    t_train = time.perf_counter()
    for ep in range(epochs):
        t0 = time.perf_counter()
        seeds = rng.choice(train_ids, B, replace=len(train_ids) < B)
        l1_nodes, s1, d1, w1 = sample_layer(seeds)
        l2_nodes, s2, d2, w2 = sample_layer(l1_nodes)
        x2 = dev(feats[l2_nodes])
        s2, d2, w2, s1, d1, w1 = (dev(a) for a in (s2, d2, w2, s1, d1, w1))
        y = dev(labels[seeds])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        h1 = torch.relu(_agg(x2 @ prm["W1"], s2.long(), d2, w2, S))
        logits = _agg(h1, s1.long(), d1, w1, B) @ prm["W2"]
        loss = F.cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        times["host_ms"].append(1e3 * (t1 - t0))
        times["step_ms"].append(1e3 * (time.perf_counter() - t1))
        if log is not None and (ep + 1) % 50 == 0:
            log(f"epoch {ep+1:4d} loss {losses[-1]:.4f}")
    train_s = time.perf_counter() - t_train

    # full-graph evaluation with the same weights (mean aggregation)
    with torch.no_grad():
        gd = g.to(device)
        x = dev(feats)
        h1 = torch.relu(dt.gspmm(gd, "copy_lhs", "mean", x @ prm["W1"]))
        logits = dt.gspmm(gd, "copy_lhs", "mean", h1) @ prm["W2"]
        pred = logits.argmax(-1).cpu().numpy()
    mask = np.asarray(ds.test_mask)
    return {"losses": losses, "times": times, "train_s": train_s,
            "test_acc": float((pred[mask] == labels[mask]).mean()),
            "params": {k: v.detach().cpu().numpy() for k, v in prm.items()}}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--layer-size", type=int, default=256)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")

    from dgl_hack_tpu_torch.data import synthetic_cora
    ds = synthetic_cora()
    res = train(ds, epochs=args.epochs, batch_size=args.batch_size,
                layer_size=args.layer_size, hidden=args.hidden, lr=args.lr,
                device=args.device, log=lambda s: print(s, flush=True))
    print(json.dumps({"dataset": ds.name, "model": "adaptive-sampling-gcn",
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(res["train_s"], 2)}))


if __name__ == "__main__":
    main()
