"""Child-Sum Tree-LSTM over topological propagation on the PyTorch port
(twin of train_tree_lstm.py): the same synthetic expression trees from the
same numpy seed, a ``pull`` per topological frontier with a UDF message
and a UDF reduce over the padded mailbox (``max_degree=2``), Adam.

Usage: python examples/train_tree_lstm_torch.py --epochs 30
Runs on the GPU; ``--device cpu`` runs on the CPU instead.  With no card
and no ``--device cpu`` it exits with an error.  The mailbox and the LSTM
gates are torch: this model reaches no hand-written kernel.  ``make_trees``,
``init_params``, ``params_from_numpy`` and ``train`` are the pieces, for
callers that drive them themselves (``chip_smoke.py``, the tests).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARAM_NAMES = ("emb", "W_iou", "b_iou", "U_iou", "U_f", "b_f", "W_out")


def make_trees(n_trees, vocab, classes, seed=0):
    """Random binary trees, edges child -> parent, drawn as the JAX
    example draws them: leaf tokens carry the class signal (token %
    classes), the root's label is the leaves' majority class.  Returns
    (graph, tokens, root, label, topological frontiers) per tree, graphs
    on the CPU."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.core.traversal import topological_nodes_generator
    rng = np.random.default_rng(seed)
    V, C = vocab, classes
    trees = []
    for _ in range(n_trees):
        n_leaves = int(rng.integers(3, 7))
        tokens, parents = [], []
        for _ in range(n_leaves):
            tokens.append(int(rng.integers(0, V)))
            parents.append(-1)
        roots = list(range(n_leaves))
        while len(roots) > 1:
            a = roots.pop(int(rng.integers(0, len(roots))))
            b = roots.pop(int(rng.integers(0, len(roots))))
            pid = len(tokens)
            tokens.append(V)          # internal marker token
            parents.append(-1)
            parents[a] = pid
            parents[b] = pid
            roots.append(pid)
        src = [i for i, pa in enumerate(parents) if pa >= 0]
        dst = [parents[i] for i in src]
        g = dt.graph((np.asarray(src, np.int32), np.asarray(dst, np.int32)),
                     num_nodes=len(tokens))
        leaf_cls = [t % C for t in tokens[:n_leaves]]
        label = int(np.bincount(leaf_cls, minlength=C).argmax())
        frontiers = tuple(tuple(int(v) for v in f)
                          for f in topological_nodes_generator(g))
        trees.append((g, np.asarray(tokens, np.int32), roots[0], label,
                      frontiers))
    return trees


def init_params(vocab, hidden, classes, seed=0):
    """The JAX example's parameter dict, drawn from torch's generator:
    normals times 0.2, zero biases (numpy arrays)."""
    gen = torch.Generator().manual_seed(seed)
    V, H, C = vocab, hidden, classes
    shapes = {"emb": (V + 1, H), "W_iou": (H, 3 * H), "U_iou": (H, 3 * H),
              "U_f": (H, H), "W_out": (H, C)}
    out = {k: (torch.randn(s, generator=gen) * 0.2).numpy()
           for k, s in shapes.items()}
    out["b_iou"] = np.zeros(3 * H, np.float32)
    out["b_f"] = np.zeros(H, np.float32)
    return {k: out[k] for k in PARAM_NAMES}


def params_from_numpy(arrays, device="cpu"):
    """The parameter dict (``emb``, ``W_iou``, ``b_iou``, ``U_iou``,
    ``U_f``, ``b_f``, ``W_out``) from numpy arrays (or the JAX example's
    arrays), as float32 leaf tensors on ``device`` that take gradients."""
    return {k: torch.tensor(np.asarray(arrays[k], np.float32),
                            device=device, requires_grad=True)
            for k in PARAM_NAMES}


def run_tree(params, g, tokens, frontiers):
    """The hidden state of every node: a pull per topological frontier
    with the Child-Sum message and reduce of the JAX example."""
    from dgl_hack_tpu_torch.core.message import pull
    H = params["U_f"].shape[0]
    x = params["emb"][tokens]
    g.ndata["iou"] = x @ params["W_iou"] + params["b_iou"]
    g.ndata["h"] = x.new_zeros((g.num_nodes(), H))
    g.ndata["c"] = x.new_zeros((g.num_nodes(), H))

    def message(edges):
        return {"mh": edges.src["h"], "mc": edges.src["c"]}

    def reduce(nodes):
        mh, mc = nodes.mailbox["mh"], nodes.mailbox["mc"]
        mask = nodes.mask[:, :, None]
        h_tilde = (mh * mask).sum(1)
        f = torch.sigmoid(mh @ params["U_f"] + params["b_f"])
        c_acc = (f * mc * mask).sum(1)
        iou = nodes.data["iou"] + h_tilde @ params["U_iou"]
        i, o, _ = torch.split(torch.sigmoid(iou), H, dim=1)
        u = torch.tanh(iou[:, 2 * H:])
        c = i * u + c_acc
        return {"h": o * torch.tanh(c), "c": c}

    for f in frontiers:
        pull(g, f, message, reduce, max_degree=2)
    return g.ndata["h"]


def tree_loss(params, g, tokens, root, label, frontiers):
    h = run_tree(params, g, tokens, frontiers)
    logits = h[root] @ params["W_out"]
    return -torch.log_softmax(logits, -1)[label]


def train(trees, params, *, epochs=30, lr=1e-2, device="cuda",
          max_steps=None):
    """Adam over the first 80% of ``trees``, one tree a step, then the
    root accuracy on the rest.  ``params`` is a dict of numpy arrays.
    Returns the per-step losses, each epoch's summed loss, train_time_s,
    test_acc and the trained parameters (numpy)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu'")
    p = params_from_numpy(params, device)
    on_dev = [(g.to(device), torch.from_numpy(t).long().to(device), r, lab,
               fr) for g, t, r, lab, fr in trees]
    n_train = int(0.8 * len(trees))
    opt = torch.optim.Adam(p.values(), lr=lr, eps=1e-8)
    losses, epoch_losses, steps = [], [], 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        total = 0.0
        for g, tokens, root, label, frontiers in on_dev[:n_train]:
            opt.zero_grad(set_to_none=True)
            loss = tree_loss(p, g, tokens, root, label, frontiers)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            total += losses[-1]
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        epoch_losses.append(total)
        if max_steps is not None and steps >= max_steps:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.perf_counter() - t0
    correct = 0
    with torch.no_grad():
        for g, tokens, root, label, frontiers in on_dev[n_train:]:
            h = run_tree(p, g, tokens, frontiers)
            correct += int((h[root] @ p["W_out"]).argmax()) == label
    return {"losses": losses, "epoch_losses": epoch_losses, "steps": steps,
            "train_time_s": train_time,
            "test_acc": correct / max(1, len(trees) - n_train),
            "params": {k: v.detach().cpu().numpy() for k, v in p.items()}}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--n_trees", type=int, default=60)
    p.add_argument("--vocab", type=int, default=6)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    trees = make_trees(args.n_trees, args.vocab, args.classes)
    res = train(trees, init_params(args.vocab, args.hidden, args.classes),
                epochs=args.epochs, lr=args.lr, device=args.device)
    print(json.dumps({"model": "ChildSumTreeLSTM", "epochs": args.epochs,
                      "test_acc": round(res["test_acc"], 4),
                      "train_time_s": round(res["train_time_s"], 2)}))


if __name__ == "__main__":
    main()
