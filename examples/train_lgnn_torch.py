"""LGNN community detection on the PyTorch port (twin of train_lgnn.py;
reference: examples/pytorch/line_graph): message passing on a graph and on
its non-backtracking line graph, coupled by the incidence operator, trained
with a permutation-invariant community loss on 2-community SBM graphs.  The
graphs are the JAX example's, drawn from the same numpy seed.  The
aggregations over g and over its line graph run K1 on the card.

Usage: python examples/train_lgnn_torch.py --epochs 40
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``make_data``, ``LGNN`` and ``train`` are the pieces, for callers that
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

K = 2


def make_data(graphs=40, nodes=24):
    """The JAX example's SBM graphs, each as (graph, line graph, incidence
    (n, E), in-degree (n, 1), communities), on the CPU."""
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(0)
    out = []
    for _ in range(graphs):
        n = nodes
        comm = rng.permutation(np.repeat(np.arange(K), n // K))
        prob = np.where(comm[:, None] == comm[None, :], 0.6, 0.08)
        a = (rng.random((n, n)) < prob) & ~np.eye(n, dtype=bool)
        a = np.triu(a) | np.triu(a).T
        s, d = np.nonzero(a)
        g = dt.graph((s.astype(np.int32), d.astype(np.int32)), num_nodes=n)
        lg = dt.line_graph(g, backtracking=False)
        # incidence transfer (node <-> edge spaces): Pm[v, e] = 1 iff v is
        # an endpoint of e (reference: line_graph/gnn.py Pm/Pd)
        E = g.num_edges()
        pm = np.zeros((n, E), np.float32)
        pm[s, np.arange(E)] = 1
        pm[d, np.arange(E)] = 1
        deg = g.in_degrees().numpy().astype(np.float32)[:, None]
        out.append((g, lg, pm, deg, comm))
    return out


class LGNNLayer(nn.Module):
    """The operator family {I, A, A^2, Pm y} on the nodes and {I, B,
    Pm^T x} on the line graph's nodes, each LayerNormed, half the channels
    through relu: the flax layer's Denses ``Dense_0`` ... ``Dense_6`` and
    ``LayerNorm_0``/``LayerNorm_1``."""

    def __init__(self, out):
        super().__init__()
        from dgl_hack_tpu_torch.nn.init import Dense
        self.out = out
        for i in range(7):
            self.add_module(f"Dense_{i}", Dense(out))
        self.LayerNorm_0 = nn.LayerNorm(out, eps=1e-6)
        self.LayerNorm_1 = nn.LayerNorm(out, eps=1e-6)

    def forward(self, g, lg, x, y, pm):
        from dgl_hack_tpu_torch import gspmm
        d = [getattr(self, f"Dense_{i}") for i in range(7)]
        ax = gspmm(g, "copy_lhs", "sum", x)
        a2x = gspmm(g, "copy_lhs", "sum", ax)
        xn = self.LayerNorm_0(d[0](x) + d[1](ax) + d[2](a2x) + d[3](pm @ y))
        by = gspmm(lg, "copy_lhs", "sum", y)
        yn = self.LayerNorm_1(d[4](y) + d[5](by) + d[6](pm.T @ x))
        h = self.out // 2
        xn = torch.cat([F.relu(xn[:, :h]), xn[:, h:]], 1)
        yn = torch.cat([F.relu(yn[:, :h]), yn[:, h:]], 1)
        return xn, yn


class LGNN(nn.Module):
    def __init__(self, hidden, layers):
        super().__init__()
        from dgl_hack_tpu_torch.nn.init import Dense
        self.layers = layers
        for i in range(layers):
            self.add_module(f"LGNNLayer_{i}", LGNNLayer(hidden))
        self.Dense_0 = Dense(K)

    def forward(self, g, lg, deg, pm):
        x = deg
        y = torch.ones((lg.num_nodes(), 1), device=deg.device)
        for i in range(self.layers):
            x, y = getattr(self, f"LGNNLayer_{i}")(g, lg, x, y, pm)
        return self.Dense_0(x)


def perm_inv_loss(logits, comm):
    """Community labels are defined up to permutation: the smaller NLL of
    the two labellings."""
    logp = torch.log_softmax(logits, -1)
    l1 = -logp.gather(1, comm[:, None]).mean()
    l2 = -logp.gather(1, (1 - comm)[:, None]).mean()
    return torch.minimum(l1, l2)


def train(data, *, hidden=16, layers=3, epochs=40, lr=5e-3, n_train=None,
          params=None, seed=0, device="cuda"):
    """Adam, one step per training graph (the first 80%), ``epochs``
    times.  ``params``: a state dict (arrays) to start from, else the
    layers' initialisation under ``seed``.  Returns the per-step losses and
    ms, the test accuracy (best of the two labellings) and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    if n_train is None:
        n_train = int(0.8 * len(data))
    dev = [(g.to(device), lg.to(device), torch.from_numpy(pm).to(device),
            torch.from_numpy(deg).to(device),
            torch.from_numpy(comm).long().to(device))
           for g, lg, pm, deg, comm in data]
    torch.manual_seed(seed)
    model = LGNN(hidden, layers).to(device)
    g0, lg0, pm0, deg0, _ = dev[0]
    with torch.no_grad():
        model(g0, lg0, deg0, pm0)             # materialise the lazy layers
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, step_ms = [], []
    for _ in range(epochs):
        for g, lg, pm, deg, comm in dev[:n_train]:
            t0 = time.perf_counter()
            loss = perm_inv_loss(model(g, lg, deg, pm), comm)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_ms.append(1e3 * (time.perf_counter() - t0))
    accs = []
    with torch.no_grad():
        for g, lg, pm, deg, comm in dev[n_train:]:
            pred = model(g, lg, deg, pm).argmax(-1)
            accs.append(max(float((pred == comm).float().mean()),
                            float((pred == 1 - comm).float().mean())))
    return {"losses": losses, "step_ms": step_ms,
            "test_acc": float(np.mean(accs)), "model": model}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--graphs", type=int, default=40)
    p.add_argument("--nodes", type=int, default=24)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    data = make_data(args.graphs, args.nodes)
    t0 = time.perf_counter()
    res = train(data, hidden=args.hidden, layers=args.layers,
                epochs=args.epochs, lr=args.lr, device=args.device)
    train_time = time.perf_counter() - t0
    print(json.dumps({"model": "LGNN", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
