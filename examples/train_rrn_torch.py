"""Recurrent Relational Network on 4x4 Sudoku, on the PyTorch port (twin
of train_rrn.py; reference: examples/pytorch/rrn, Palm et al.'s RRN):
iterated relational message passing on the row/column/box constraint
graph.  Each of T steps runs an edge-UDF message MLP through
``apply_edges``, a copy_e/sum ``update_all`` (K1's edge-row mode on the
card) and a GRU node update; the loss is the cross-entropy of every step.

The puzzles, the parameters and their draw order are the JAX example's,
from the same numpy generator (the parameters first, then a batch of
puzzles an epoch).

Usage: python examples/train_rrn_torch.py --epochs 300
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``sudoku4_batch``, ``constraint_graph``, ``init_params`` and ``train`` are
the pieces, for callers that drive them themselves (``chip_smoke.py``, the
tests).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PARAMS = ("emb", "pos", "m1", "m2", "wz", "wr", "wh", "out")


def sudoku4_batch(rng, batch, mask_lo=6, mask_hi=10):
    """(B, 16) puzzles (0 = blank) + (B, 16) solutions, 4x4 Sudoku."""
    base = np.array([[1, 2, 3, 4],
                     [3, 4, 1, 2],
                     [2, 1, 4, 3],
                     [4, 3, 2, 1]])
    sols = np.empty((batch, 4, 4), np.int32)
    for b in range(batch):
        g = base.copy()
        perm = rng.permutation(4) + 1
        g = perm[g - 1]
        # swap rows within each band, columns within each stack
        for band in (0, 2):
            if rng.random() < 0.5:
                g[[band, band + 1]] = g[[band + 1, band]]
            if rng.random() < 0.5:
                g[:, [band, band + 1]] = g[:, [band + 1, band]]
        if rng.random() < 0.5:
            g = g.T
        sols[b] = g
    sols = sols.reshape(batch, 16)
    n_mask = rng.integers(mask_lo, mask_hi + 1, batch)
    puzzles = sols.copy()
    for b in range(batch):
        puzzles[b, rng.choice(16, n_mask[b], replace=False)] = 0
    return puzzles, sols


def constraint_graph(B):
    """Batched 4x4 Sudoku constraint graph (row/col/box peers), on the
    CPU."""
    import dgl_hack_tpu_torch as dt
    cells = np.arange(16).reshape(4, 4)
    pairs = set()
    for i in range(4):
        for j in range(4):
            u = cells[i, j]
            peers = set(cells[i, :]) | set(cells[:, j]) | \
                set(cells[2 * (i // 2):2 * (i // 2) + 2,
                          2 * (j // 2):2 * (j // 2) + 2].ravel())
            for v in peers - {u}:
                pairs.add((u, v))
    src1 = np.array([p[0] for p in sorted(pairs)])
    dst1 = np.array([p[1] for p in sorted(pairs)])
    src = np.concatenate([src1 + 16 * b for b in range(B)]).astype(np.int32)
    dst = np.concatenate([dst1 + 16 * b for b in range(B)]).astype(np.int32)
    return dt.graph((src, dst), num_nodes=16 * B)


def init_params(rng, hidden=64):
    """The JAX example's parameters, drawn from ``rng`` in its order:
    normal with variance 2 / (fan_in + fan_out)."""
    shapes = {"emb": (5, hidden), "pos": (16, hidden),
              "m1": (2 * hidden, hidden), "m2": (hidden, hidden),
              "wz": (2 * hidden, hidden), "wr": (2 * hidden, hidden),
              "wh": (2 * hidden, hidden), "out": (hidden, 4)}
    return {k: (rng.normal(size=shapes[k])
                * (2.0 / sum(shapes[k][-2:])) ** 0.5).astype(np.float32)
            for k in PARAMS}


def rrn_forward(prm, g, puzzles, steps):
    """(T, B*16, 4) logits of every step."""
    B = puzzles.shape[0]
    pos = torch.arange(16, device=puzzles.device).repeat(B)
    x0 = prm["emb"][puzzles.reshape(-1)] + prm["pos"][pos]
    from dgl_hack_tpu_torch import function as fn
    h, logits = x0, []
    for _ in range(steps):
        g.ndata["h"] = h
        g.apply_edges(lambda e: {"m": F.relu(
            torch.cat([e.src["h"], e.dst["h"]], -1) @ prm["m1"])
            @ prm["m2"]})
        g.update_all(fn.copy_e("m", "m"), fn.sum("m", "agg"))
        agg = g.ndata.pop("agg")
        inp = torch.cat([agg + x0, h], -1)
        z = torch.sigmoid(inp @ prm["wz"])
        r = torch.sigmoid(inp @ prm["wr"])
        cand = torch.tanh(torch.cat([agg + x0, r * h], -1) @ prm["wh"])
        h = (1 - z) * h + z * cand
        logits.append(h @ prm["out"])
    return torch.stack(logits)


def loss_and_acc(prm, g, puzzles, sols, steps):
    logits_t = rrn_forward(prm, g, puzzles, steps)
    tgt = (sols.reshape(-1) - 1).long()
    logp = torch.log_softmax(logits_t, -1)
    nll = -logp.gather(-1, tgt[None, :, None].expand(steps, -1, 1))
    acc = (logits_t[-1].argmax(-1) == tgt).float().mean()
    return nll.mean(), acc


def train(params, rng, *, batch=64, steps=8, epochs=300, lr=2e-3,
          device="cuda", log=print):
    """Adam, one fresh batch of puzzles from ``rng`` an epoch; ``params``
    are numpy arrays (``init_params``).  Returns the per-epoch losses and
    ms, the held-out cell accuracy (puzzles of seed 123) and the
    parameters."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    g = constraint_graph(batch).to(device)
    prm = {k: torch.tensor(v, device=device, requires_grad=True)
           for k, v in params.items()}
    opt = torch.optim.Adam(prm.values(), lr=lr, eps=1e-8)
    losses, epoch_ms = [], []
    for ep in range(epochs):
        puz, sol = sudoku4_batch(rng, batch)
        t0 = time.perf_counter()
        loss, acc = loss_and_acc(prm, g, torch.from_numpy(puz).to(device),
                                 torch.from_numpy(sol).to(device), steps)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_ms.append(1e3 * (time.perf_counter() - t0))
        if log is not None and (ep + 1) % 100 == 0:
            log(f"epoch {ep+1:4d} loss {losses[-1]:.4f} "
                f"cell_acc {float(acc):.3f}", flush=True)
    puz, sol = sudoku4_batch(np.random.default_rng(123), batch)
    with torch.no_grad():
        _, test_acc = loss_and_acc(prm, g, torch.from_numpy(puz).to(device),
                                   torch.from_numpy(sol).to(device), steps)
    return {"losses": losses, "epoch_ms": epoch_ms,
            "cell_acc": float(test_acc), "params": prm}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    rng = np.random.default_rng(0)
    params = init_params(rng, args.hidden)
    t0 = time.perf_counter()
    res = train(params, rng, batch=args.batch, steps=args.steps,
                epochs=args.epochs, lr=args.lr, device=args.device)
    print(json.dumps({"dataset": "sudoku4-synth", "model": "rrn",
                      "cell_acc": round(res["cell_acc"], 4),
                      "train_time_s": round(time.perf_counter() - t0, 2)}))


if __name__ == "__main__":
    main()
