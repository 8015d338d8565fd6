"""Deep Graph Infomax on the PyTorch port (twin of train_dgi.py;
reference: examples/pytorch/dgi): a GCN encoder trained to tell the graph's
nodes from a row-permuted copy of the features through a bilinear
discriminator against the graph summary, then a linear probe on the frozen
embeddings.  Synthetic Cora with self-loops, the JAX example's data; the
corruption permutations are drawn from the same numpy seed.  The encoder's
GraphConv runs K1 on the card.

Usage: python examples/train_dgi_torch.py --epochs 60
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_data``, ``DGI``, ``train`` and ``probe`` are the pieces, for callers
that drive them themselves (``chip_smoke.py``, the tests); ``train`` starts
from parameters given as arrays (``interop.flax_to_state_dict`` of the JAX
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


def make_data():
    """Synthetic Cora with self-loops (on the CPU): (graph, features,
    labels, train mask, test mask, classes)."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.data import synthetic_cora
    ds = synthetic_cora(seed=0)
    return (dt.add_self_loop(ds.graph), ds.features, np.asarray(ds.labels),
            np.asarray(ds.train_mask), np.asarray(ds.test_mask),
            ds.num_classes)


class PReLU(nn.Module):
    """flax's PReLU: one learned slope ``negative_slope`` (init 0.01)."""

    def __init__(self, init=0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


class Encoder(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        from dgl_hack_tpu_torch.nn import GraphConv
        self.GraphConv_0 = GraphConv(hidden)
        self.PReLU_0 = PReLU()

    def forward(self, g, x):
        return self.PReLU_0(self.GraphConv_0(g, x))


class DGI(nn.Module):
    """The flax model's names: ``Encoder_0`` and the discriminator
    ``disc`` (hidden, hidden), glorot-uniform.  Returns (loss, positive
    embeddings)."""

    def __init__(self, hidden):
        super().__init__()
        from dgl_hack_tpu_torch.nn.init import glorot_uniform_
        self.Encoder_0 = Encoder(hidden)
        self.disc = nn.Parameter(torch.empty(hidden, hidden))
        glorot_uniform_(self.disc, hidden, hidden)

    def forward(self, g, x, x_corrupt):
        h_pos = self.Encoder_0(g, x)
        h_neg = self.Encoder_0(g, x_corrupt)
        s = torch.sigmoid(h_pos.mean(0))                  # graph summary
        d_pos = (h_pos @ self.disc) @ s
        d_neg = (h_neg @ self.disc) @ s
        loss = -(F.logsigmoid(d_pos).mean() + F.logsigmoid(-d_neg).mean())
        return loss, h_pos


def train(data, *, hidden=64, epochs=60, lr=5e-3, params=None, seed=0,
          device="cuda"):
    """Adam on the DGI loss, one corruption permutation an epoch from
    ``np.random.default_rng(0)`` as the JAX example draws them.
    ``params``: a state dict (arrays) to start from, else the layers'
    initialisation under ``seed``.  Returns the per-epoch losses and ms,
    the final embeddings (numpy) and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    g, feats = data[0].to(device), torch.from_numpy(data[1]).to(device)
    torch.manual_seed(seed)
    model = DGI(hidden).to(device)
    with torch.no_grad():
        model(g, feats, feats)                # materialise the lazy layer
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    rng = np.random.default_rng(0)
    losses, epoch_ms = [], []
    for _ in range(epochs):
        perm = torch.from_numpy(rng.permutation(feats.shape[0])).to(device)
        t0 = time.perf_counter()
        loss, _ = model(g, feats, feats[perm])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        _, H = model(g, feats, feats)
    return {"losses": losses, "epoch_ms": epoch_ms,
            "embeddings": H.cpu().numpy(), "model": model}


def probe(H, labels, train_mask, test_mask, classes, epochs=100):
    """The JAX example's linear probe on frozen embeddings (zero-initialised
    W, b; Adam 1e-2, full batch): the test accuracy."""
    Htr = torch.from_numpy(H[train_mask])
    ytr = torch.as_tensor(labels[train_mask], dtype=torch.int64)
    W = torch.zeros((H.shape[1], classes), requires_grad=True)
    b = torch.zeros((classes,), requires_grad=True)
    opt = torch.optim.Adam([W, b], lr=1e-2, eps=1e-8)
    for _ in range(epochs):
        loss = F.cross_entropy(Htr @ W + b, ytr)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        pred = (torch.from_numpy(H) @ W + b).argmax(1).numpy()
    return float((pred == labels)[test_mask].mean())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--probe_epochs", type=int, default=100)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    data = make_data()
    t0 = time.perf_counter()
    res = train(data, hidden=args.hidden, epochs=args.epochs, lr=args.lr,
                device=args.device)
    train_time = time.perf_counter() - t0
    acc = probe(res["embeddings"], *data[2:], epochs=args.probe_epochs)
    print(json.dumps({"model": "DGI", "epochs": args.epochs,
                      "probe_test_acc": round(acc, 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
