"""TAGCN node classification on the PyTorch port (twin of
train_tagcn.py): two TAGConv layers.

Usage: python examples/train_tagcn_torch.py --dataset synth --epochs 100
Runs on the GPU (K1 for the propagation); ``--device cpu`` runs the
kernels' plain versions on the CPU instead.  With no card and no
``--device cpu`` it exits with an error.  ``--dataset synth`` is the JAX
example's planted-partition stand-in (2,708 nodes, 256 features, 7
classes); the others come from ``data.CoraGraphDataset`` and the like
(planetoid files where present, else the synthetic stand-ins).  Prints one
JSON line: {"dataset", "test_acc", "train_time_s", "epochs"}.
"""
import argparse
import json
import sys

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synth",
                   choices=["synth", "cora", "citeseer", "pubmed"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    from dgl_hack_tpu_torch import data
    from dgl_hack_tpu_torch.models import TAGCN
    from dgl_hack_tpu_torch.models.training import train_node_classifier

    torch.manual_seed(args.seed)
    if args.dataset == "synth":
        ds = data.planted_partition(2708, 7, 256, avg_degree=4.0,
                                    homophily=0.81, feat_noise=2.0,
                                    seed=args.seed, train_per_class=20,
                                    num_val=500, num_test=1000)
    else:
        ds = {"cora": data.CoraGraphDataset,
              "citeseer": data.CiteseerGraphDataset,
              "pubmed": data.PubmedGraphDataset}[args.dataset]()
    model = TAGCN(args.hidden, ds.num_classes, k=args.k,
                  dropout=args.dropout)
    res = train_node_classifier(
        model, ds.graph, ds.features, ds.labels, ds.train_mask, ds.val_mask,
        ds.test_mask, num_epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, seed=args.seed, device=args.device)
    print(json.dumps({"dataset": ds.name, "test_acc": res["test_acc"],
                      "train_time_s": res["train_time_s"],
                      "epochs": args.epochs}))


if __name__ == "__main__":
    main()
