"""Full-graph GCN training on the PyTorch port (twin of train_gcn.py).

Usage: python examples/train_gcn_torch.py --dataset cora --epochs 200
Runs on the GPU (the CUDA kernels); ``--device cpu`` runs the kernels'
plain versions on the CPU instead.  With no card and no ``--device cpu``
it exits with an error.  Datasets come from ``data.CoraGraphDataset``
and the like, as in the JAX example: the planetoid files under
``$DGL_DOWNLOAD_DIR`` where present, else the synthetic stand-ins.
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
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--self-loop", action="store_true", default=True)
    p.add_argument("--pallas", action="store_true",
                   help="call prepare_spmm first (kept for parity with "
                        "train_gcn.py; the kernels need no plan)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch import data
    from dgl_hack_tpu_torch.models import GCN
    from dgl_hack_tpu_torch.models.training import train_node_classifier

    ds = {"cora": data.CoraGraphDataset,
          "citeseer": data.CiteseerGraphDataset,
          "pubmed": data.PubmedGraphDataset,
          "synth": data.synthetic_cora}[args.dataset]()
    device = torch.device(args.device)
    g = ds.graph.to(device)
    if args.pallas:
        g = dt.prepare_spmm(g)
    model = GCN(hidden_feats=args.hidden, out_feats=ds.num_classes,
                dropout=args.dropout)
    res = train_node_classifier(
        model, g, ds.features, ds.labels, ds.train_mask, ds.val_mask,
        ds.test_mask, num_epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, log_every=20, device=device)
    print(json.dumps({"dataset": ds.name, "test_acc": res["test_acc"],
                      "train_time_s": res["train_time_s"],
                      "epochs_per_s": res["epochs_per_s"]}))


if __name__ == "__main__":
    main()
