"""R-GCN entity classification on the PyTorch port (twin of
train_rgcn.py, on AIFB/MUTAG/BGS/AM).

Usage: python examples/train_rgcn_torch.py --dataset aifb-synth --epochs 50
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  With no card and no ``--device cpu`` it exits with an
error.  The datasets are the JAX package's synthetic relational
stand-ins (or ``$DGL_DOWNLOAD_DIR/<name>/<name>.npz`` where present).
Every layer takes the (dst, etype)-pair path (``prepare_rgcn``): its plan
is index arrays, on either device.
"""
import argparse
import json
import sys

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="aifb-synth")
    p.add_argument("--scale", type=float, default=0.1,
                   help="synthetic stand-in size fraction (AM at full "
                        "stats is 1.67M nodes)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--num-bases", type=int, default=-1)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--l2norm", type=float, default=5e-4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.data.rdf import load_rdf_dataset
    from dgl_hack_tpu_torch.models import RGCN
    from dgl_hack_tpu_torch.models.training import train_node_classifier

    device = torch.device(args.device)
    ds = load_rdf_dataset(args.dataset, scale=args.scale)
    g = ds.graph.to(device)
    plan = dt.prepare_rgcn(g, ds.etypes, ds.num_rels)
    model = RGCN(num_nodes=g.num_nodes(), hidden_feats=args.hidden,
                 out_feats=ds.num_classes, num_rels=ds.num_rels,
                 num_bases=args.num_bases)
    res = train_node_classifier(
        model, g, None, ds.labels, ds.train_mask, ds.test_mask,
        ds.test_mask, num_epochs=args.epochs, lr=args.lr,
        weight_decay=args.l2norm,
        model_args=(torch.from_numpy(ds.etypes).to(device),),
        model_kwargs={"plan": plan}, log_every=10, device=device)
    print(json.dumps({"dataset": ds.name, "test_acc": res["test_acc"],
                      "train_time_s": res["train_time_s"],
                      "epochs_per_s": res["epochs_per_s"]}))


if __name__ == "__main__":
    main()
