"""APPNP node classification on the PyTorch port (twin of
train_appnp.py): an MLP followed by k steps of personalised-PageRank
propagation.

Usage: python examples/train_appnp_torch.py --dataset cora --epochs 200
Runs on the GPU (K1 for the propagation); ``--device cpu`` runs the
kernels' plain versions on the CPU instead.  With no card and no
``--device cpu`` it exits with an error.  Datasets come from
``data.CoraGraphDataset`` and the like, as in the JAX example (planetoid
files where present, else the synthetic stand-ins).
"""
import argparse
import json
import sys

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed", "synth"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch import data
    from dgl_hack_tpu_torch.models import APPNP
    from dgl_hack_tpu_torch.models.training import train_node_classifier

    torch.manual_seed(0)
    ds = {"cora": data.CoraGraphDataset,
          "citeseer": data.CiteseerGraphDataset,
          "pubmed": data.PubmedGraphDataset,
          "synth": data.synthetic_cora}[args.dataset]()
    g = dt.add_self_loop(dt.remove_self_loop(ds.graph))
    model = APPNP(hidden=args.hidden, out_feats=ds.num_classes, k=args.k,
                  alpha=args.alpha, dropout=args.dropout)
    res = train_node_classifier(
        model, g, ds.features, ds.labels, ds.train_mask, ds.val_mask,
        ds.test_mask, num_epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, log_every=50, device=args.device)
    print(json.dumps({"dataset": ds.name, "model": "APPNP",
                      "test_acc": res["test_acc"],
                      "train_time_s": res["train_time_s"]}))


if __name__ == "__main__":
    main()
