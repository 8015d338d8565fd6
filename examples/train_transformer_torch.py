"""Graph-transformer training on the PyTorch port (twin of
train_transformer.py): an encoder-decoder on the copy task, every
attention the u_dot_v gsddmm -> edge_softmax -> u_mul_e gspmm pipeline.

Usage: python examples/train_transformer_torch.py --epochs 200
Runs on the GPU (the gSDDMM and segment-sum kernels); ``--device cpu``
runs their plain versions on the CPU instead.  With no card and no
``--device cpu`` it exits with an error.  Parameters and sequences come
from one numpy generator seeded 0, in the JAX example's order.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--seq-len", type=int, default=10)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--vocab", type=int, default=16)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    import numpy as np
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    from dgl_hack_tpu_torch.models import (GraphTransformer, build_graphs,
                                           copy_task_loss)

    device = torch.device(args.device)
    B, L, V = args.batch, args.seq_len, args.vocab
    graphs = build_graphs(B, L, device=device)
    rng = np.random.default_rng(0)
    model = GraphTransformer(V, L, args.dim, args.heads, rng=rng).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)

    t0 = time.perf_counter()
    acc = 0.0
    for ep in range(args.epochs):
        seq = rng.integers(0, V, (B, L)).astype(np.int32)
        tgt = torch.from_numpy(seq).long().to(device)   # copy task
        loss, logits = copy_task_loss(model, graphs, tgt, tgt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        acc = float((logits.argmax(-1) == tgt).float().mean())
        if (ep + 1) % 50 == 0:
            print(f"epoch {ep+1:4d} loss {float(loss.detach()):.4f} "
                  f"tok_acc {acc:.3f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(json.dumps({"dataset": "copy", "model": "graph-transformer",
                      "token_acc": round(acc, 4),
                      "train_time_s": round(time.perf_counter() - t0, 2)}))


if __name__ == "__main__":
    main()
