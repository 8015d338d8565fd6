"""MoNet (GMMConv) node classification on the PyTorch port (twin of
train_monet.py; reference: examples/pytorch/monet/citation.py): edge
pseudo-coordinates [1/sqrt(deg_u), 1/sqrt(deg_v)] and two GMM layers on
synthetic Cora with self-loops, the JAX example's data from the same seed.
Each layer's sum runs K1's edge-row mode on the card.

Usage: python examples/train_monet_torch.py --epochs 60
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_data``, ``MoNet`` and ``train`` are the pieces, for callers that
drive them themselves (``chip_smoke.py``, the tests); ``train`` starts from
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


def make_data():
    """Synthetic Cora with self-loops (on the CPU) and the pseudo-
    coordinates of its edges in user order, as the JAX example builds
    them: (graph, features, labels, train mask, test mask, classes,
    pseudo)."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.data import synthetic_cora
    ds = synthetic_cora(seed=0)
    g = dt.add_self_loop(ds.graph)
    s, d = g.host_edges()
    deg = g.in_degrees().numpy().astype(np.float64)
    pseudo = np.stack([1.0 / np.sqrt(np.maximum(deg[s], 1)),
                       1.0 / np.sqrt(np.maximum(deg[d], 1))],
                      axis=1).astype(np.float32)
    return (g, ds.features, ds.labels, np.asarray(ds.train_mask),
            np.asarray(ds.test_mask), ds.num_classes, pseudo)


class MoNet(nn.Module):
    """Two GMMConv layers (dim 2), relu between: the flax model's names."""

    def __init__(self, hidden, classes, kernels):
        super().__init__()
        from dgl_hack_tpu_torch.nn import GMMConv
        self.GMMConv_0 = GMMConv(hidden, dim=2, n_kernels=kernels)
        self.GMMConv_1 = GMMConv(classes, dim=2, n_kernels=kernels)

    def forward(self, g, x, pseudo):
        return self.GMMConv_1(g, F.relu(self.GMMConv_0(g, x, pseudo)),
                              pseudo)


def train(data, *, hidden=16, kernels=3, epochs=60, lr=1e-2, params=None,
          seed=0, device="cuda"):
    """Full-batch Adam on the masked NLL.  ``params``: a state dict (arrays)
    to start from, else the layers' initialisation under ``seed``.  Returns
    the per-epoch losses and ms (each ended by a sync), the test accuracy
    and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    g, feats, labels, train_mask, test_mask, classes, pseudo = data
    torch.manual_seed(seed)
    g = g.to(device)
    x = torch.from_numpy(feats).to(device)
    ps = torch.from_numpy(pseudo).to(device)
    y = torch.as_tensor(labels, dtype=torch.int64, device=device)
    tr = torch.as_tensor(train_mask, device=device)
    model = MoNet(hidden, classes, kernels).to(device)
    with torch.no_grad():
        model(g, x, ps)                       # materialise the lazy layers
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, epoch_ms = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        loss = F.cross_entropy(model(g, x, ps)[tr], y[tr])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        pred = model(g, x, ps).argmax(-1).cpu().numpy()
    acc = float((pred == np.asarray(labels))[np.asarray(test_mask)].mean())
    return {"losses": losses, "epoch_ms": epoch_ms, "test_acc": acc,
            "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--kernels", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    data = make_data()
    t0 = time.perf_counter()
    res = train(data, hidden=args.hidden, kernels=args.kernels,
                epochs=args.epochs, lr=args.lr, device=args.device)
    train_time = time.perf_counter() - t0
    print(json.dumps({"model": "MoNet", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
