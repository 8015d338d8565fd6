"""HAN on the PyTorch port (twin of train_han.py; DGL: examples/pytorch/han):
a GAT per metapath over ``metapath_reachable_graph`` (with self-loops),
then semantic attention across the metapaths.

The synthetic ACM-style world is the JAX example's, drawn from the same
numpy seed: papers belong to latent areas, and authors and fields link
papers mostly of one area, so the PAP and PFP metapath graphs carry the
label signal.  Each GATConv's edge phase is the fused GAT: on the card K2
(forward) and K3 + K1 (backward).

Usage: python examples/train_han_torch.py --epochs 40
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
The module names follow the flax model's (``HANLayer_0.GATConv_0``, ...),
so ``interop.flax_to_state_dict`` of the JAX example's parameters loads
into it; without them the layers take torch's own initialisation.
``make_data``, ``HAN`` and ``train`` are the pieces, for callers that drive
them themselves (``chip_smoke.py``, the tests).
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

METAPATHS = (("written-by", "writes"), ("in", "has"))


def make_data(papers=300, classes=3):
    """The JAX example's heterograph, drawn as it draws it: returns the
    metapath graphs (self-loops added, on the CPU), paper features
    (papers, classes), labels and the training mask."""
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(0)
    NP, NA, NF = papers, papers // 3, 3 * classes
    area = rng.integers(0, classes, NP)

    def affil(n_other, per, noise=0.1):
        # each 'other' node links papers, mostly within one area
        own = rng.integers(0, classes, n_other)
        src, dst = [], []
        for o in range(n_other):
            pool = np.nonzero(area == own[o])[0]
            k = min(per, len(pool))
            picked = rng.choice(pool, size=k, replace=False)
            flip = rng.random(k) < noise
            picked[flip] = rng.integers(0, NP, int(flip.sum()))
            src.extend([o] * k)
            dst.extend(picked.tolist())
        return np.asarray(src, np.int32), np.asarray(dst, np.int32)

    asrc, adst = affil(NA, 9)
    fsrc, fdst = affil(NF, 60, noise=0.25)
    hg = dt.heterograph({
        ("author", "writes", "paper"): (asrc, adst),
        ("paper", "written-by", "author"): (adst, asrc),
        ("field", "has", "paper"): (fsrc, fdst),
        ("paper", "in", "field"): (fdst, fsrc),
    }, num_nodes_dict={"paper": NP, "author": NA, "field": NF})
    graphs = [dt.add_self_loop(dt.metapath_reachable_graph(hg, list(mp)))
              for mp in METAPATHS]
    feats = (np.eye(classes)[area]
             + 0.5 * rng.normal(size=(NP, classes))).astype(np.float32)
    train_mask = rng.random(NP) < 0.4
    return graphs, feats, area, train_mask


class HANLayer(nn.Module):
    """A GATConv per metapath, then semantic attention (reference:
    han/model.py SemanticAttention): beta = softmax over metapaths of the
    node-mean of Dense_0(tanh(Dense_1(z))), the flax model's names (it
    builds the outer Dense first)."""

    def __init__(self, num_metapaths, out_feats, num_heads):
        super().__init__()
        from dgl_hack_tpu_torch.nn import GATConv
        self.num_metapaths = num_metapaths
        for i in range(num_metapaths):
            self.add_module(f"GATConv_{i}", GATConv(out_feats, num_heads))
        self.Dense_0 = nn.LazyLinear(1)
        self.Dense_1 = nn.LazyLinear(64)

    def forward(self, graphs, h):
        zs = [getattr(self, f"GATConv_{i}")(g, h).reshape(h.shape[0], -1)
              for i, g in enumerate(graphs)]
        z = torch.stack(zs, 1)                          # (N, M, H*D)
        w = self.Dense_0(torch.tanh(self.Dense_1(z)))   # (N, M, 1)
        beta = torch.softmax(w.mean(0), dim=0)          # (M, 1)
        return (z * beta[None]).sum(1)


class HAN(nn.Module):
    def __init__(self, num_metapaths, hidden, heads, classes):
        super().__init__()
        self.HANLayer_0 = HANLayer(num_metapaths, hidden, heads)
        self.Dense_0 = nn.LazyLinear(classes)

    def forward(self, graphs, h):
        return self.Dense_0(F.elu(self.HANLayer_0(graphs, h)))


def train(graphs, feats, labels, train_mask, *, hidden=16, heads=4,
          epochs=40, lr=5e-3, state=None, seed=0, device="cuda"):
    """Full-batch training with Adam on the masked NLL.  ``state``: a
    state dict to start from (``interop.flax_to_state_dict`` of the JAX
    example's parameters), else torch's initialisation under ``seed``.
    Returns the per-epoch losses and ms (each ended by a sync), the test
    accuracy (the papers outside the training mask) and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    torch.manual_seed(seed)
    gs = [g.to(device) for g in graphs]
    x = torch.from_numpy(feats).to(device)
    y = torch.as_tensor(labels, dtype=torch.int64, device=device)
    mask = torch.as_tensor(train_mask, device=device)
    model = HAN(len(gs), hidden, heads, int(labels.max()) + 1).to(device)
    with torch.no_grad():
        model(gs, x)                          # materialise the lazy layers
    if state is not None:
        model.load_state_dict(state)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, epoch_ms = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        logits = model(gs, x)
        loss = F.cross_entropy(logits[mask], y[mask])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        sync()
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        pred = model(gs, x).argmax(-1)
    test = ~mask
    acc = float((pred[test] == y[test]).float().mean())
    return {"losses": losses, "epoch_ms": epoch_ms, "test_acc": acc,
            "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--papers", type=int, default=300)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    graphs, feats, labels, train_mask = make_data(args.papers, args.classes)
    t0 = time.perf_counter()
    res = train(graphs, feats, labels, train_mask, hidden=args.hidden,
                heads=args.heads, epochs=args.epochs, lr=args.lr,
                device=args.device)
    train_time = time.perf_counter() - t0
    print(json.dumps({"model": "HAN", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
