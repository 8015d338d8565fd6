"""DGMG generative-model training on the PyTorch port (twin of
train_dgmg.py; reference: examples/pytorch/dgmg and
model_zoo/chem/dgmg.py): the teacher-forced NLL of the same synthetic
molecules' action traces (the same numpy seed), a batch of traces a step,
Adam with optax's defaults; then graphs sampled from the model and the
share that is structurally valid.

Usage: python examples/train_dgmg_torch.py --epochs 15
Runs on the GPU; ``--device cpu`` runs on the CPU instead.  With no card
and no ``--device cpu`` it exits with an error.  The decision heads,
message passing (``ops.segment.segment_sum``) and GRUs are torch: no
hand-written kernel is on this path.  ``make_traces``, ``train`` and
``sample`` are the pieces, for callers that drive them themselves
(``chip_smoke.py``, the tests).
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def make_traces(n_graphs, max_nodes=10, max_edges=14, seed=0):
    """The JAX example's toy world, drawn as it draws it: path graphs with
    alternating node types, half of them closed into a ring.  Returns the
    action traces (step_types, labels), each (n_graphs, 2 * max_nodes +
    2 * max_edges + 2) int32."""
    from dgl_hack_tpu_torch.models.dgmg import build_action_trace
    rng = np.random.default_rng(seed)
    max_steps = 2 * max_nodes + 2 * max_edges + 2
    traces = []
    for _ in range(n_graphs):
        n = int(rng.integers(4, max_nodes - 1))
        nt = np.arange(n) % 2
        src = np.arange(n - 1)
        dst = np.arange(1, n)
        bonds = np.zeros(n - 1, np.int64)
        if rng.random() < 0.5 and n > 3:
            src = np.append(src, 0)
            dst = np.append(dst, n - 1)
            bonds = np.append(bonds, 1)
        traces.append(build_action_trace(nt, src, dst, bonds, max_steps))
    return (np.stack([t[0] for t in traces]),
            np.stack([t[1] for t in traces]))


def trim(sts, lbs):
    """The traces cut after the batch's last step that is not PAD (PAD
    steps change neither the NLL nor the state)."""
    from dgl_hack_tpu_torch.models.dgmg import PAD
    live = np.nonzero((sts != PAD).any(0))[0]
    n = int(live[-1]) + 1 if len(live) else 0
    return sts[:, :n], lbs[:, :n]


def make_model(hidden=32, max_nodes=10, max_edges=14, params=None,
               device="cuda", seed=0):
    """The example's DGMG (2 node and 2 bond types, 2 propagation rounds),
    drawn from ``torch.manual_seed(seed)`` or loaded from a state dict
    (``params``, e.g. ``interop.flax_to_state_dict`` of the JAX
    example's)."""
    from dgl_hack_tpu_torch.models.dgmg import DGMG
    torch.manual_seed(seed)
    model = DGMG(n_node_types=2, n_bond_types=2, node_hidden_size=hidden,
                 num_prop_rounds=2, max_nodes=max_nodes, max_edges=max_edges)
    if params is not None:
        model.load_state_dict(params)
    return model.to(device)


def train(model, sts, lbs, epochs=15, lr=3e-3, device="cuda",
          on_step=None):
    """Full-batch Adam steps on the mean NLL of the traces (numpy).
    ``on_step(step)`` runs after each step is queued.  Returns the
    per-step losses (read once, after the last step), each step's host ms
    (the first synchronised and the rest synchronised only with
    ``on_step``'s help) and train_time_s."""
    device = torch.device(device)
    st, lb = (torch.from_numpy(x).to(device) for x in trim(sts, lbs))
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for step in range(epochs):
        ts = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = model(st, lb).mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            on_step(step)
        step_ms.append((time.perf_counter() - ts) * 1e3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.perf_counter() - t0
    return {"losses": torch.stack(losses).tolist() if losses else [],
            "step_ms": step_ms, "train_time_s": train_time}


def sample(model, samples, seed=100):
    """``samples`` graphs from one ``generate`` call, and the share that
    is structurally valid (a node at least, every edge between live
    nodes), as the JAX example counts it."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {k: v.cpu().numpy() for k, v in
           model.generate(gen, num_samples=samples).items()}
    valid = 0
    for i in range(samples):
        n, e = int(out["num_nodes"][i]), int(out["num_edges"][i])
        src, dst = out["src"][i, :e], out["dst"][i, :e]
        valid += bool(n > 0 and (e == 0 or (src.max() < n
                                            and dst.max() < n)))
    return out, valid / samples


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--n_graphs", type=int, default=48)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    sts, lbs = make_traces(args.n_graphs)
    model = make_model(args.hidden, device=args.device)
    res = train(model, sts, lbs, args.epochs, args.lr, device=args.device)
    _, frac = sample(model, args.samples)
    print(json.dumps({"model": "DGMG", "epochs": args.epochs,
                      "nll_first": round(res["losses"][0], 3),
                      "nll_last": round(res["losses"][-1], 3),
                      "sample_valid_frac": frac,
                      "train_time_s": round(res["train_time_s"], 2)}))


if __name__ == "__main__":
    main()
