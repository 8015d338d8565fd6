"""Full-graph GAT training on the PyTorch port (twin of train_gat.py).

Runs on the GPU (the fused GAT kernels); ``--device cpu`` runs the
composed plain path on the CPU instead.  With no card and no ``--device
cpu`` it exits with an error.  Datasets come from
``data.CoraGraphDataset`` and the like, as in the JAX example: the
planetoid files under ``$DGL_DOWNLOAD_DIR`` where present, else the
synthetic stand-ins.
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
    p.add_argument("--num-hidden", type=int, default=8)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--num-out-heads", type=int, default=1)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--in-drop", type=float, default=0.6)
    p.add_argument("--attn-drop", type=float, default=0.6)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch import data
    from dgl_hack_tpu_torch.models import GAT
    from dgl_hack_tpu_torch.models.training import train_node_classifier

    ds = {"cora": data.CoraGraphDataset,
          "citeseer": data.CiteseerGraphDataset,
          "pubmed": data.PubmedGraphDataset,
          "synth": data.synthetic_cora}[args.dataset]()
    device = torch.device(args.device)
    g = dt.prepare_spmm(ds.graph, device=device)
    model = GAT(hidden_feats=args.num_hidden, out_feats=ds.num_classes,
                heads=(args.num_heads, args.num_out_heads),
                feat_drop=args.in_drop, attn_drop=args.attn_drop)
    res = train_node_classifier(
        model, g, ds.features, ds.labels, ds.train_mask, ds.val_mask,
        ds.test_mask, num_epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, log_every=20, device=device)
    print(json.dumps({"dataset": ds.name, "test_acc": res["test_acc"],
                      "train_time_s": res["train_time_s"]}))


if __name__ == "__main__":
    main()
