"""DGCNN-style point-cloud classification on the PyTorch port (twin of
train_pointcloud.py; reference: examples/pytorch/pointcloud): a kNN graph
per cloud, two EdgeConv layers (u_sub_v on K6, the max over in-edges a
torch scatter), max ++ mean pooling and an MLP.  The clouds (sphere shell,
cube surface, two clusters) are the JAX example's, drawn from the same
numpy seed.

Usage: python examples/train_pointcloud_torch.py --epochs 20
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_data``, ``DGCNN`` and ``train`` are the pieces, for callers that
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


def make_data(clouds=90, points=64, k=8):
    """The JAX example's clouds, each as (kNN graph on the CPU, points
    (P, 3), label)."""
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(0)
    NP = points

    def cloud(label):
        if label == 0:        # sphere shell
            x = rng.normal(size=(NP, 3))
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        elif label == 1:      # cube surface
            x = rng.uniform(-1, 1, (NP, 3))
            ax = rng.integers(0, 3, NP)
            x[np.arange(NP), ax] = np.sign(x[np.arange(NP), ax])
        else:                 # two gaussian clusters
            c = rng.integers(0, 2, NP)[:, None] * 2.0 - 1.0
            x = c * np.array([1.0, 0, 0]) + 0.3 * rng.normal(size=(NP, 3))
        return x.astype(np.float32)

    data = []
    for i in range(clouds):
        lbl = i % 3
        x = cloud(lbl)
        data.append((dt.knn_graph(x, k), x, lbl))
    return data


class DGCNN(nn.Module):
    """Two EdgeConvs, max ++ mean pooling, Dense_1 (hidden) then Dense_0
    (3): flax names the outer Dense first."""

    def __init__(self, hidden):
        super().__init__()
        from dgl_hack_tpu_torch.nn import EdgeConv
        from dgl_hack_tpu_torch.nn.init import Dense
        self.EdgeConv_0 = EdgeConv(hidden)
        self.EdgeConv_1 = EdgeConv(hidden)
        self.Dense_0 = Dense(3)
        self.Dense_1 = Dense(hidden)

    def forward(self, g, x):
        h = F.relu(self.EdgeConv_0(g, x))
        h = F.relu(self.EdgeConv_1(g, h))
        hg = torch.cat([h.max(0).values, h.mean(0)])
        return self.Dense_0(F.relu(self.Dense_1(hg)))


def train(data, *, hidden=32, epochs=20, lr=5e-3, n_train=None,
          params=None, seed=0, device="cuda"):
    """Adam, one step per training cloud (the first 80%), ``epochs`` times,
    on the cross-entropy of its label.  ``params``: a state dict (arrays)
    to start from, else the layers' initialisation under ``seed``.  Returns
    the per-step losses and ms, the test accuracy and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    if n_train is None:
        n_train = int(0.8 * len(data))
    dev = [(g.to(device), torch.from_numpy(x).to(device), y)
           for g, x, y in data]
    torch.manual_seed(seed)
    model = DGCNN(hidden).to(device)
    with torch.no_grad():
        model(*dev[0][:2])                    # materialise the lazy layers
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, step_ms = [], []
    for _ in range(epochs):
        for g, x, y in dev[:n_train]:
            t0 = time.perf_counter()
            loss = -torch.log_softmax(model(g, x), -1)[y]
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_ms.append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        correct = sum(int(model(g, x).argmax()) == y
                      for g, x, y in dev[n_train:])
    return {"losses": losses, "step_ms": step_ms,
            "test_acc": correct / max(1, len(dev) - n_train),
            "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--clouds", type=int, default=90)
    p.add_argument("--points", type=int, default=64)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    data = make_data(args.clouds, args.points, args.k)
    t0 = time.perf_counter()
    res = train(data, hidden=args.hidden, epochs=args.epochs, lr=args.lr,
                device=args.device)
    train_time = time.perf_counter() - t0
    print(json.dumps({"model": "DGCNN", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
