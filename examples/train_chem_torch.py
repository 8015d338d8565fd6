"""Molecular property prediction on the PyTorch port (twin of
train_chem.py; reference: the chem model zoo's classifiers on Tox21,
SchNet/MGCN/MPNN on Alchemy).

The synthetic molecules are the JAX example's, drawn from the same numpy
seed (``data/chem.py``; Alchemy's seed includes ``hash(mode)``, which
Python salts per process, so its molecules match the JAX example's only
within one process or under one ``PYTHONHASHSEED``).  The models are
``models/chem.py``'s, at the JAX example's narrow widths, or with
``--full-width`` at the JAX classes' defaults (DGL 0.4's model-zoo
widths: MPNN 64/128 with 6 + 6 steps, MGCN 128, AttentiveFP 200, ...).
On the card the message passing runs the hand-written kernels: K1 (u_mul_e
and copy_e sums, the readouts), K2/K3 (the GAT classifier) and K6 (Weave's
u_add_v, AttentiveFP's dst copies).

Usage:
  python examples/train_chem_torch.py --model gcn --epochs 30   # Tox21
  python examples/train_chem_torch.py --model schnet            # Alchemy
  python examples/train_chem_torch.py --model mpnn --full-width
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an error.
``load_data``, ``build_model``, ``model_inputs``, ``make_batches``,
``loss_of`` and ``train`` are the pieces, for callers that drive them
themselves (``chip_smoke.py``, the tests); ``train`` starts from
parameters given as arrays (``interop.flax_to_state_dict`` of the JAX
example's) or from the models' own initialisation under a seed.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MODELS = ("gcn", "gat", "attentivefp", "schnet", "mgcn", "mpnn", "weave",
          "wln")
REGRESSION = ("schnet", "mgcn", "mpnn")


def load_data(model, n_mols=128):
    """(graphs, labels, mask): Alchemy with its labels standardised for the
    regression models, Tox21 with its label mask for the others."""
    from dgl_hack_tpu_torch.data.chem import TencentAlchemyDataset, Tox21
    if model in REGRESSION:
        ds = TencentAlchemyDataset(n_mols=n_mols, seed=0)
        labels = (ds.labels - ds.mean) / ds.std
        return ds.graphs, labels, np.ones_like(labels)
    ds = Tox21(n_mols=n_mols, seed=0)
    return ds.graphs, ds.labels, ds.mask


# model -> (class, its output-width keyword, the JAX example's narrow widths)
ZOO = {
    "gcn": ("GCNClassifier", "n_tasks", {"gcn_hidden_feats": (32, 32)}),
    "gat": ("GATClassifier", "n_tasks", {"gat_hidden_feats": (16, 16),
                                         "num_heads": (4, 4)}),
    "attentivefp": ("AttentiveFP", "output_size", {
        "num_layers": 2, "num_timesteps": 2, "graph_feat_size": 32}),
    "schnet": ("SchNet", "output_dim", {"dim": 32, "n_conv": 2}),
    "mgcn": ("MGCN", "output_dim", {"dim": 32, "edge_dim": 32, "n_conv": 2}),
    "mpnn": ("MPNN", "output_dim", {
        "node_hidden_dim": 32, "edge_hidden_dim": 32,
        "num_step_message_passing": 3, "num_step_set2set": 3}),
    "weave": ("WeavePredictor", "n_tasks", {"num_layers": 2,
                                            "hidden_feats": 32}),
    "wln": ("WLNPredictor", "n_tasks", {"node_out_feats": 32,
                                        "n_layers": 2}),
}


def build_model(model, n_tasks, full_width=False):
    """The JAX example's model at its widths, or at the class defaults."""
    from dgl_hack_tpu_torch.models import chem
    cls, out_kw, narrow = ZOO[model]
    return getattr(chem, cls)(**{out_kw: n_tasks},
                              **({} if full_width else narrow))


def model_inputs(model, bg):
    """The model's inputs from a batched graph, as the JAX example takes
    them: Weave and WLN take user-order edge features, AttentiveFP and MPNN
    internal-order ones (MPNN's NNConv permutes them once more by
    int2user, as the JAX layer does)."""
    if model in ("schnet", "mgcn"):
        return (bg, bg.ndata["atomic_number"],
                bg.edata_internal["distance"])
    if model in ("weave", "wln"):
        return (bg, bg.ndata["h"], bg.edata["e"])
    if model in ("attentivefp", "mpnn"):
        return (bg, bg.ndata["h"], bg.edata_internal["e"])
    return (bg, bg.ndata["h"])


def make_batches(graphs, labels, mask, lo, hi, batch_size):
    """The JAX example's batches of [lo, hi): (batched graph, labels,
    mask), on the CPU."""
    import dgl_hack_tpu_torch as dt
    out = []
    for i in range(lo, max(lo + 1, hi - batch_size + 1), batch_size):
        j = min(i + batch_size, hi)
        out.append((dt.batch(graphs[i:j]), torch.from_numpy(labels[i:j]),
                    torch.from_numpy(mask[i:j])))
    return out


def loss_of(model, pred, y, w):
    """Squared error (regression) or sigmoid cross-entropy, masked and
    averaged over the labels present."""
    if model in REGRESSION:
        ls = (pred - y) ** 2
    else:
        ls = F.binary_cross_entropy_with_logits(pred, y, reduction="none")
    return (ls * w).sum() / w.sum().clamp(min=1.0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model_name, train_batches, *, epochs=30, lr=3e-3, params=None,
          full_width=False, seed=0, device="cuda"):
    """Adam over the batches, ``epochs`` times.  ``params``: a state dict
    (arrays) to start from, else the model's initialisation under
    ``seed``.  Each step moves its batch to the device (the host part,
    ``host_ms``) and then trains (``step_ms``, ended by a sync).  Returns
    the per-step losses and times and the model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device='cpu' to "
                           "train on the CPU")
    torch.manual_seed(seed)
    n_tasks = train_batches[0][1].shape[1]
    model = build_model(model_name, n_tasks, full_width)
    bg0 = train_batches[0][0].to(device)
    with torch.no_grad():
        model.to(device)(*model_inputs(model_name, bg0))    # materialise
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, host_ms, step_ms = [], [], []
    for _ in range(epochs):
        for bg, y, w in train_batches:
            t0 = time.perf_counter()
            bg, y, w = bg.to(device), y.to(device), w.to(device)
            t1 = time.perf_counter()
            loss = loss_of(model_name, model(*model_inputs(model_name, bg)),
                           y, w)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            _sync(device)
            host_ms.append(1e3 * (t1 - t0))
            step_ms.append(1e3 * (time.perf_counter() - t1))
    return {"losses": losses, "host_ms": host_ms, "step_ms": step_ms,
            "model": model}


@torch.no_grad()
def evaluate(model_name, model, test_batches, device):
    """Test MSE (regression) or masked accuracy, as the JAX example."""
    model.eval()
    device = torch.device(device)
    if model_name in REGRESSION:
        errs = [float(loss_of(model_name,
                              model(*model_inputs(model_name,
                                                  bg.to(device))),
                              y.to(device), w.to(device)))
                for bg, y, w in test_batches]
        return {"test_mse": round(float(np.mean(errs)), 4)}
    correct = tot = 0.0
    for bg, y, w in test_batches:
        pred = model(*model_inputs(model_name, bg.to(device))).cpu()
        hit = ((pred > 0) == (y > 0.5)).float() * w
        correct += float(hit.sum())
        tot += float(w.sum())
    return {"test_acc": round(correct / max(tot, 1.0), 4)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="gcn", choices=list(MODELS))
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--n_mols", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--full-width", action="store_true",
                   help="build the model at the JAX class defaults")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    graphs, labels, mask = load_data(args.model, args.n_mols)
    n_train = int(0.8 * len(graphs))
    train_b = make_batches(graphs, labels, mask, 0, n_train,
                           args.batch_size)
    test_b = make_batches(graphs, labels, mask, n_train, len(graphs),
                          args.batch_size)
    t0 = time.perf_counter()
    res = train(args.model, train_b, epochs=args.epochs, lr=args.lr,
                full_width=args.full_width, device=args.device)
    train_time = time.perf_counter() - t0
    metric = evaluate(args.model, res["model"], test_b, args.device)
    print(json.dumps({"dataset": "alchemy" if args.model in REGRESSION
                      else "tox21", "model": args.model,
                      "epochs": args.epochs, **metric,
                      "train_time_s": round(train_time, 2)}))


if __name__ == "__main__":
    main()
