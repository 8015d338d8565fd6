"""Capsule network with dynamic routing as graph message passing on the
PyTorch port (twin of train_capsule.py; DGL: examples/pytorch/capsule,
DGLRoutingLayer): routing-by-agreement over a complete bipartite capsule
graph.

Each routing iteration runs over the same bipartite ``block``: coupling
logits b live on edges, c = softmax of b as the JAX example lays it out
(``b.reshape(IC, OC)`` over internal edge order), s = copy_e sum of
c * u_hat (gspmm copy_rhs over (E, B, OD) edge data: on the card K1's
rows route), squash on nodes, and the agreement b += <u_hat, v[dst]>, an
e-dot-v gsddmm over (E, B, OD) operands (on the card K6's dot, one item a
(edge, sample)).  The synthetic digits and the margin loss are the JAX
example's.

Usage: python examples/train_capsule_torch.py --epochs 60
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``init_params`` draws the JAX example's shapes and scales from a numpy
seed (the JAX example draws from jax.random); ``train`` takes any
parameters as numpy arrays, so the tests start it from the JAX example's
own.  ``synthetic_digits``, ``routing_graph`` and ``train`` are the pieces
``chip_smoke.py`` drives.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def synthetic_digits(n, noise=0.15, seed=0):
    """Procedural 8x8 'digit' templates (10 classes) + bit-flip noise, as
    the JAX example draws them."""
    rng = np.random.default_rng(seed)
    base = np.zeros((10, 8, 8), np.float32)
    for c in range(10):
        r = np.random.default_rng(1000 + c)
        base[c] = (r.random((8, 8)) < 0.4).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = base[y].copy()
    flips = rng.random((n, 8, 8)) < noise
    x[flips] = 1.0 - x[flips]
    return x.reshape(n, 64), y


def routing_graph(in_caps, out_caps):
    """The complete bipartite block in capsule i -> out capsule j, and
    each internal-order edge's (i, j) pair index i * out_caps + j."""
    import dgl_hack_tpu_torch as dt
    src = np.repeat(np.arange(in_caps), out_caps).astype(np.int32)
    dst = np.tile(np.arange(out_caps), in_caps).astype(np.int32)
    g = dt.block((src, dst), num_src=in_caps, num_dst=out_caps)
    s_int, d_int = g.edges(order="internal")
    pair = s_int.long().numpy() * out_caps + d_int.long().numpy()
    return g, pair


def init_params(in_caps, out_caps, in_dim, out_dim, seed=0):
    """``primary`` (64, IC * ID) and ``W`` (IC, OC, ID, OD), standard
    normal times 0.1, as the JAX example scales them."""
    rng = np.random.default_rng(seed)
    return {"primary": (0.1 * rng.normal(size=(64, in_caps * in_dim))
                        ).astype(np.float32),
            "W": (0.1 * rng.normal(size=(in_caps, out_caps, in_dim,
                                         out_dim))).astype(np.float32)}


def squash(s, dim=-1):
    sq = (s ** 2).sum(dim, keepdim=True)
    return (sq / (1.0 + sq)) * s / torch.sqrt(sq + 1e-9)


def margin_loss(lengths, labels, m_pos=0.9, m_neg=0.1, lam=0.5):
    t = torch.nn.functional.one_hot(labels, lengths.shape[1]).to(
        lengths.dtype)
    pos = torch.clamp(m_pos - lengths, min=0.0) ** 2
    neg = torch.clamp(lengths - m_neg, min=0.0) ** 2
    return (t * pos + lam * (1 - t) * neg).sum(1).mean()


def forward(g, pair, params, x, routing):
    """Capsule lengths (B, OC) of the batch x (B, 64)."""
    import dgl_hack_tpu_torch as dt
    IC, OC, ID, OD = params["W"].shape
    E = g.num_edges()
    B = x.shape[0]
    prim = squash(torch.tanh(x @ params["primary"]).reshape(B, IC, ID))
    # u_hat per edge pair, then into internal edge order: (E, B, OD)
    u_hat_pair = torch.einsum("bif,ijfo->ijbo", prim, params["W"])
    u_hat = u_hat_pair.reshape(IC * OC, B, OD)[pair]

    def couple(b):
        c = torch.softmax(b.reshape(IC, OC), dim=1).reshape(E, 1, 1)
        return dt.gspmm(g, "copy_rhs", "sum", None, c * u_hat, "u", "e")

    b = torch.zeros(E, dtype=x.dtype, device=x.device)
    for _ in range(routing):
        v = squash(couple(b))                                  # (OC, B, OD)
        agree = dt.gsddmm(g, "dot", u_hat, v, "e", "v")        # (E, B, 1)
        b = b + agree.mean(1)[:, 0]
    v = squash(couple(b))
    return torch.sqrt((v ** 2).sum(-1) + 1e-9).T                # (B, OC)


def train(params, xtr, ytr, *, epochs=60, lr=3e-3, routing=3,
          device="cuda", xte=None, yte=None):
    """Full-batch Adam on the margin loss from ``params`` (numpy arrays;
    ``init_params`` or the JAX example's).  Returns the per-epoch losses
    and ms (each ended by a sync), the test accuracy where a test set is
    given, and the trained parameters."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    IC, OC = params["W"].shape[:2]
    g, pair = routing_graph(IC, OC)
    g = g.to(device)
    pair = torch.from_numpy(pair).to(device)
    prm = {k: torch.nn.Parameter(torch.tensor(np.asarray(v, np.float32),
                                              device=device))
           for k, v in params.items()}
    opt = torch.optim.Adam(prm.values(), lr=lr, eps=1e-8)
    x = torch.from_numpy(xtr).to(device)
    y = torch.as_tensor(ytr, dtype=torch.int64, device=device)
    losses, epoch_ms = [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        loss = margin_loss(forward(g, pair, prm, x, routing), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
    acc = None
    if xte is not None:
        with torch.no_grad():
            pred = forward(g, pair, prm, torch.from_numpy(xte).to(device),
                           routing).argmax(1).cpu().numpy()
        acc = float((pred == yte).mean())
    return {"losses": losses, "epoch_ms": epoch_ms, "test_acc": acc,
            "params": {k: v.detach().cpu().numpy() for k, v in prm.items()}}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--train", type=int, default=1024)
    p.add_argument("--test", type=int, default=256)
    p.add_argument("--in-caps", type=int, default=16)
    p.add_argument("--out-caps", type=int, default=10)
    p.add_argument("--in-dim", type=int, default=8)
    p.add_argument("--out-dim", type=int, default=16)
    p.add_argument("--routing", type=int, default=3)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    xtr, ytr = synthetic_digits(args.train, seed=args.seed)
    xte, yte = synthetic_digits(args.test, seed=args.seed + 1)
    params = init_params(args.in_caps, args.out_caps, args.in_dim,
                         args.out_dim, args.seed)
    t0 = time.time()
    res = train(params, xtr, ytr, epochs=args.epochs, lr=args.lr,
                routing=args.routing, device=args.device, xte=xte, yte=yte)
    print(json.dumps({
        "example": "capsule", "epochs": args.epochs,
        "loss": round(res["losses"][-1], 4),
        "test_acc": round(res["test_acc"], 4),
        "train_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
