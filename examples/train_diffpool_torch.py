"""DiffPool graph classification on the PyTorch port (twin of
train_diffpool.py; reference: examples/pytorch/diffpool): graphs densified
to (B, maxN, .) tensors, a DenseSAGEConv stage, a soft assignment S,
coarsened X' = S^T Z and A' = S^T A S, a second DenseSAGEConv and a mean
readout, with DiffPool's link-prediction and entropy auxiliaries.

The SBM mixture and its batches are the JAX example's, drawn from the same
numpy seed.  As in the JAX example, every layer is a dense batched matmul
(the JAX example imports GraphConv and calls no sparse op), so no
hand-written kernel runs on this path.

Usage: python examples/train_diffpool_torch.py --epochs 25
Runs on the GPU; ``--device cpu`` runs on the CPU instead.  With no card
and no ``--device cpu`` it exits with an error.  ``make_batches``,
``DiffPool`` and ``train`` are the pieces, for callers that drive them
themselves (``chip_smoke.py``, the tests); ``train`` starts from
parameters given as arrays (``interop.flax_to_state_dict`` of the JAX
example's) or from the layers' own initialisation under a seed.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

MAX_N = 24


def densify(bg, x):
    """(batched graph, node features) -> dense (B, maxN, F+1) features with
    the scaled in-degree appended, (B, maxN, maxN) adjacency and (B, maxN)
    node mask, on the host, as the JAX example builds them."""
    deg = bg.in_degrees().numpy().astype(np.float32)[:, None] / 10.0
    x = np.concatenate([np.asarray(x), deg], axis=1)
    B, F_ = len(bg.batch_num_nodes), x.shape[1]
    offs = np.concatenate([[0], np.cumsum(bg.batch_num_nodes)])
    s, d = bg.host_edges()
    Xd = np.zeros((B, MAX_N, F_), np.float32)
    Ad = np.zeros((B, MAX_N, MAX_N), np.float32)
    M = np.zeros((B, MAX_N), np.float32)
    gi = np.searchsorted(offs[1:], s, side="right")
    for b in range(B):
        n = bg.batch_num_nodes[b]
        Xd[b, :n] = x[offs[b]:offs[b + 1]]
        M[b, :n] = 1
    Ad[gi, s - offs[gi], d - offs[gi]] = 1.0
    return Xd, Ad, M


def make_batches(graphs=120, batch_size=24):
    """The JAX example's SBM mixture (24-node graphs with 1 or 4
    communities) in dense batches: [((X, A, M), labels)], and the number
    of classes."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.data import sbm_mixture
    ds = sbm_mixture(num_graphs=graphs, nodes_per_graph=MAX_N,
                     communities=(1, 4), p_in=0.6, p_out=0.05, seed=0)
    batches = []
    for i in range(0, graphs - batch_size + 1, batch_size):
        bg = dt.batch(ds.graphs[i:i + batch_size])
        x = np.concatenate(ds.features[i:i + batch_size])
        batches.append((densify(bg, x),
                        np.asarray(ds.labels[i:i + batch_size], np.int64)))
    return batches, ds.num_classes


class DiffPool(nn.Module):
    """The flax model's layers and names: DenseSAGEConv_0 -> Dense_0 (the
    assignment) -> DenseSAGEConv_1 on the coarse graph -> Dense_1."""

    def __init__(self, hidden, clusters, classes):
        super().__init__()
        from dgl_hack_tpu_torch.nn import DenseSAGEConv
        from dgl_hack_tpu_torch.nn.init import Dense
        self.DenseSAGEConv_0 = DenseSAGEConv(hidden)
        self.Dense_0 = Dense(clusters)
        self.DenseSAGEConv_1 = DenseSAGEConv(hidden)
        self.Dense_1 = Dense(classes)

    def forward(self, X, A, M):
        Z = F.relu(self.DenseSAGEConv_0(A, X))
        S = self.Dense_0(Z)
        S = torch.softmax(torch.where(M[:, :, None] > 0, S,
                                      torch.full_like(S, -1e9)), dim=-1)
        Xp = torch.einsum("bnk,bnf->bkf", S, Z)
        Ap = torch.einsum("bnk,bnm,bml->bkl", S, A, S)
        lp = ((A - torch.einsum("bnk,bmk->bnm", S, S)) ** 2).mean()
        ent = (-S * torch.log(S + 1e-9)).sum(-1)
        ent = (ent * M).sum() / M.sum().clamp(min=1.0)
        Z2 = F.relu(self.DenseSAGEConv_1(Ap, Xp))
        return self.Dense_1(Z2.mean(1)), lp, ent


def train(batches, classes, *, hidden=32, clusters=6, epochs=25, lr=5e-3,
          n_train=None, params=None, seed=0, device="cuda"):
    """Adam over the first ``n_train`` batches (the JAX example's 80%),
    ``epochs`` times, on NLL + 0.01 link loss + 0.01 entropy.
    ``params``: a state dict (arrays) to start from, else the layers'
    initialisation under ``seed``.  Returns the per-step losses and ms, the
    test accuracy over the other batches and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    torch.manual_seed(seed)
    dev = [(tuple(torch.from_numpy(a).to(device) for a in xam),
            torch.from_numpy(y).to(device)) for xam, y in batches]
    if n_train is None:
        n_train = int(0.8 * len(batches))
    model = DiffPool(hidden, clusters, classes).to(device)
    with torch.no_grad():
        model(*dev[0][0])                     # materialise the lazy layers
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, step_ms = [], []
    for _ in range(epochs):
        for xam, y in dev[:n_train]:
            t0 = time.perf_counter()
            logits, lp, ent = model(*xam)
            loss = F.cross_entropy(logits, y) + 0.01 * lp + 0.01 * ent
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_ms.append(1e3 * (time.perf_counter() - t0))
    correct = tot = 0
    with torch.no_grad():
        for xam, y in dev[n_train:]:
            correct += int((model(*xam)[0].argmax(-1) == y).sum())
            tot += len(y)
    return {"losses": losses, "step_ms": step_ms,
            "test_acc": correct / max(tot, 1), "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--graphs", type=int, default=120)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--clusters", type=int, default=6)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    batches, classes = make_batches(args.graphs, args.batch_size)
    t0 = time.perf_counter()
    res = train(batches, classes, hidden=args.hidden,
                clusters=args.clusters, epochs=args.epochs, lr=args.lr,
                n_train=int(0.8 * args.graphs) // args.batch_size,
                device=args.device)
    train_time = time.perf_counter() - t0
    print(json.dumps({"model": "DiffPool", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
