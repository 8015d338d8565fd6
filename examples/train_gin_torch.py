"""GIN graph classification on the PyTorch port (twin of train_gin.py).

Usage: python examples/train_gin_torch.py --dataset synth --epochs 40
Runs on the GPU (the CUDA kernels); ``--device cpu`` runs the kernels'
plain versions on the CPU instead.  With no card and no ``--device cpu``
it exits with an error.  The data is the JAX example's offline stand-in,
an SBM mixture whose label is the community count.
"""
import argparse
import json
import sys

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synth")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    from dgl_hack_tpu_torch.data import sbm_mixture
    from dgl_hack_tpu_torch.models import GIN
    from dgl_hack_tpu_torch.models.training import train_graph_classifier

    torch.manual_seed(0)
    ds = sbm_mixture(num_graphs=200, nodes_per_graph=24,
                     communities=(1, 4), p_in=0.6, p_out=0.05, seed=0)
    model = GIN(hidden_feats=args.hidden, out_feats=ds.num_classes,
                num_layers=args.num_layers)
    res = train_graph_classifier(model, ds, epochs=args.epochs,
                                 batch_size=args.batch_size, lr=args.lr,
                                 device=args.device)
    print(json.dumps({"dataset": "SBM-mixture", "model": "GIN",
                      "epochs": args.epochs, "test_acc": res["test_acc"],
                      "train_time_s": round(res["train_time_s"], 2)}))


if __name__ == "__main__":
    main()
