"""PageRank by message passing on the PyTorch port (twin of pagerank.py):
one gspmm copy_lhs-sum a power iteration (the segment-sum kernel on the
GPU).

Usage: python examples/pagerank_torch.py --n 100 --iters 20
Runs on the GPU; ``--device cpu`` runs the kernel's plain version on the
CPU instead.  With no card and no ``--device cpu`` it exits with an
error.  ``pagerank`` is the loop, for callers that bring their own graph
(``chip_smoke.py``).
"""
import argparse
import json
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402


def pagerank(g, iters=20, damp=0.85):
    """(num_nodes,) PageRank of ``g`` after ``iters`` power iterations
    from the uniform vector, each one ``gspmm`` over all edges."""
    import dgl_hack_tpu_torch as dt
    n = g.num_nodes()
    deg = g.out_degrees().float().clamp(min=1.0)
    pv = torch.full((g.num_dst_nodes, 1), 1.0 / n, device=g.device)
    for _ in range(iters):
        agg = dt.gspmm(g, "copy_lhs", "sum", pv / deg[:, None])
        pv = (1 - damp) / n + damp * agg
    return pv[:, 0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--edges", type=int, default=600)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--damp", type=float, default=0.85)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to run on the CPU")
    import dgl_hack_tpu_torch as dt
    rng = np.random.default_rng(0)
    src = rng.integers(0, args.n, args.edges).astype(np.int32)
    dst = rng.integers(0, args.n, args.edges).astype(np.int32)
    g = dt.graph((src, dst), num_nodes=args.n, device=args.device)
    pv = pagerank(g, args.iters, args.damp).cpu().numpy()
    top = np.argsort(pv)[::-1][:5]
    print(json.dumps({"model": "pagerank", "iters": args.iters,
                      "sum": round(float(pv.sum()), 4),
                      "top5": top.tolist()}))


if __name__ == "__main__":
    main()
