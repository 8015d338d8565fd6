"""GGNN on a typed-edge reachability task, on the PyTorch port (twin of
train_ggnn.py; reference: examples/pytorch/ggnn, GatedGraphConv's per-etype
messages and GRU steps).

Random graphs with R edge types; node 0 is annotated; the task is which
nodes are reachable from node 0 over type-0 edges within ``steps`` hops.
The graphs are the JAX example's, drawn from the same numpy seed.  Each
step's message sum runs K1's edge-row mode on the card.

Prints one JSON line: {"dataset", "test_acc", "epochs", "loss"}.
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_task``, ``GGNN`` and ``train`` are the pieces, for callers that
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


def make_task(num_graphs, n, etypes, steps, seed):
    """The JAX example's graphs (on the CPU), their edge types (user
    order) and reachability labels."""
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(seed)
    graphs, labels, ets = [], [], []
    for _ in range(num_graphs):
        E = n * 3
        src = rng.integers(0, n, E).astype(np.int32)
        dst = rng.integers(0, n, E).astype(np.int32)
        et = rng.integers(0, etypes, E).astype(np.int32)
        g = dt.graph((src, dst), num_nodes=n)
        # BFS over type-0 edges only, limited to `steps` hops
        reach = np.zeros(n, bool)
        reach[0] = True
        for _ in range(steps):
            m = reach[src] & (et == 0)
            nxt = reach.copy()
            nxt[dst[m]] = True
            if (nxt == reach).all():
                break
            reach = nxt
        graphs.append(g)
        ets.append(et)
        labels.append(reach)
    return graphs, ets, labels


class GGNN(nn.Module):
    """GatedGraphConv then a glorot Dense to one logit per node: the flax
    model's names."""

    def __init__(self, hidden, steps, etypes):
        super().__init__()
        from dgl_hack_tpu_torch.nn import GatedGraphConv
        from dgl_hack_tpu_torch.nn.init import Dense
        self.GatedGraphConv_0 = GatedGraphConv(hidden, n_steps=steps,
                                               n_etypes=etypes)
        self.Dense_0 = Dense(1, kernel_init="xavier")

    def forward(self, g, x, etypes):
        return self.Dense_0(self.GatedGraphConv_0(g, x, etypes))[:, 0]


def train(task, *, hidden=32, steps=4, etypes=3, epochs=30, lr=5e-3,
          n_train=None, params=None, seed=0, device="cuda"):
    """Adam, one step per training graph, ``epochs`` times, on the mean
    sigmoid cross-entropy.  ``params``: a state dict (arrays) to start
    from, else the layers' initialisation under ``seed``.  Returns the
    per-step losses and ms, the test accuracy (the last 20% of the graphs)
    and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    graphs, ets, labels = task
    n = graphs[0].num_nodes()
    if n_train is None:
        n_train = int(0.8 * len(graphs))
    torch.manual_seed(seed)
    gs = [g.to(device) for g in graphs]
    et = [torch.from_numpy(e).to(device) for e in ets]
    ys = [torch.from_numpy(y.astype(np.float32)).to(device) for y in labels]
    x0 = torch.zeros((n, 2), device=device)
    x0[0, 0] = 1.0                    # annotation: "is the start node"
    model = GGNN(hidden, steps, etypes).to(device)
    with torch.no_grad():
        model(gs[0], x0, et[0])               # materialise the lazy layer
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, step_ms = [], []
    for _ in range(epochs):
        for i in range(n_train):
            t0 = time.perf_counter()
            loss = F.binary_cross_entropy_with_logits(
                model(gs[i], x0, et[i]), ys[i])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_ms.append(1e3 * (time.perf_counter() - t0))
    correct = total = 0
    with torch.no_grad():
        for i in range(n_train, len(gs)):
            pred = (model(gs[i], x0, et[i]) > 0).cpu().numpy()
            correct += int((pred == labels[i]).sum())
            total += n
    return {"losses": losses, "step_ms": step_ms,
            "test_acc": correct / max(total, 1), "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--graphs", type=int, default=60)
    p.add_argument("--nodes", type=int, default=24)
    p.add_argument("--etypes", type=int, default=3)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    task = make_task(args.graphs, args.nodes, args.etypes, args.steps,
                     args.seed)
    res = train(task, hidden=args.hidden, steps=args.steps,
                etypes=args.etypes, epochs=args.epochs, lr=args.lr,
                seed=args.seed, device=args.device)
    print(json.dumps({"dataset": "reachability-synth",
                      "test_acc": float(res["test_acc"]),
                      "epochs": args.epochs, "loss": res["losses"][-1]}))


if __name__ == "__main__":
    main()
