"""Sweep the dense-hub hybrid's window selection (threshold, budget) on
bench.py's graph with the PyTorch port (twin of tools/tune_hybrid.py).

For each (threshold, budget) point the graph is prepared by
``prepare_spmm(..., dense_threshold=, dense_budget=)``: the windows of 128
dst rows that ``select_dense_windows`` picks go dense (a bf16 count matrix
C times x), K1 takes the remainder.  The loop ``h = gspmm(g, "copy_lhs",
"sum", h) * 1e-3`` is timed by ``utils.profiling.timed_loop`` (CUDA events
on the card, at two loop lengths whose difference cancels launch and
readback latency).  ``threshold`` None is the port's own breakeven
(``_dense_breakeven``); a budget admits no more windows than its GB of C
holds.  One JSON line a point:

  {"thr", "budget_gb", "wins", "wins_built", "dense_edges_M", "ms",
   "Medges_per_s", "dtype", "F", "prepare_s"}

``wins`` is what ``select_dense_windows`` picks, ``wins_built`` what the
graph carries after windows whose counts bf16 cannot hold are dropped.
``--dtype`` and ``--feats`` set the rows' type and width, so that one run
can ask whether the breakeven holds in bf16 and at narrow F.

Usage:
  python tools/tune_hybrid_torch.py                      # f32, F = 128
  python tools/tune_hybrid_torch.py --dtype bfloat16 --feats 16
  python tools/tune_hybrid_torch.py --device cpu --nodes 20000

Runs on the card (``--device cuda``, the default); without one it raises
unless given ``--device cpu``.  The graph is bench.py's:
random_power_law_graph(1,000,000, 16, alpha=2.1, seed=0), F = 128.
"""
import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, F, TE, TR = 1_000_000, 128, 256, 128
# (threshold, budget in GB): tools/tune_hybrid.py's grid
GRID = [(None, 3), (66_000, 3), (66_000, 6), (45_000, 6), (33_000, 8),
        (25_000, 10)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def window_counts(indptr: np.ndarray, num_dst: int, tr: int = TR):
    """Edges in each window of ``tr`` dst rows."""
    W = -(-num_dst // tr)
    bounds = np.minimum(np.arange(W + 1) * tr, num_dst)
    return (indptr[bounds[1:]] - indptr[bounds[:-1]]).astype(np.int64)


def sweep(g0, x, points=GRID, k_lo=2, k_hi=10, repeats=3):
    """One row a (threshold, budget) point of ``points`` for the graph
    ``g0`` (on x's device) and the rows ``x`` (their dtype and width)."""
    import time
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
    from dgl_hack_tpu_torch.utils.profiling import timed_loop
    E, n = g0.num_edges(), g0.num_src_nodes
    indptr = g0.host("csc_indptr")
    cnt = window_counts(indptr, g0.num_dst_nodes)
    rows = []
    for thr, budget_gb in points:
        wins = sk.select_dense_windows(indptr, n, g0.num_dst_nodes, TR,
                                       threshold=thr,
                                       budget_bytes=budget_gb << 30)
        dense_edges = int(cnt[wins].sum()) if len(wins) else 0
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        g = dt.prepare_spmm(g0, te=TE, weighted=False, dense_threshold=thr,
                            dense_budget=budget_gb << 30)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        prepare_s = time.perf_counter() - t0
        hyb = g.derived.get("hybrid")
        with torch.no_grad():
            dt_s = timed_loop(
                lambda h: dt.gspmm(g, "copy_lhs", "sum", h) * 1e-3, x,
                k_lo=k_lo, k_hi=k_hi, repeats=repeats)
        rows.append({
            "thr": thr, "budget_gb": budget_gb, "wins": len(wins),
            "wins_built": 0 if hyb is None else int(hyb.windows.numel()),
            "dense_edges_M": round(dense_edges / 1e6, 2),
            "ms": dt_s * 1e3, "Medges_per_s": E / dt_s / 1e6,
            "dtype": str(x.dtype).replace("torch.", ""),
            "F": int(x.shape[1]), "prepare_s": prepare_s})
        # free the plan and C before the next point
        del g, hyb
        gc.collect()
        if x.is_cuda:
            torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--feats", type=int, default=F)
    ap.add_argument("--nodes", type=int, default=N,
                    help="graph size (bench.py's: 1,000,000)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    from dgl_hack_tpu_torch.data import random_power_law_graph
    g0 = random_power_law_graph(args.nodes, avg_degree=16.0, alpha=2.1,
                                seed=0).to(args.device)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(args.nodes, args.feats)).astype(np.float32)).to(
        args.device).to(DTYPES[args.dtype])
    for row in sweep(g0, x, GRID):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
