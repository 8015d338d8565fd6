"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repository root; needs one card)

Phases, one JSON line each:
  1. build the kernels from dgl_hack_tpu_torch/csrc (nvcc, sm_90a);
  2. K1 (segment sum) against its plain version: forward and dx on a
     small graph (zero-in-degree rows, a hub of >= 10k in-edges, F in
     {7, 16, 41, 128}) and at bench.py's shape (power-law, N=1M, deg 16,
     F=128); gspmm with a dst-side operand, which reduces through K1;
  3. K2/K3 (fused GAT forward/backward) against the plain composed
     version and its autograd, in both softmax modes, plus a large-spread
     case in 'exact' mode;
  4. GCN training through train_node_classifier on synthetic Reddit at
     full size (232,965 nodes x 602 features, 41 classes);
  5. GAT training on the same graph (8 heads x 8 hidden, 1 output head);
  6. K4/K5 (segment max and its fused argmax backward) against their plain
     versions on phase 2's small graph (F in {7, 16, 41, 128}; weights
     none, (E,) and (E, F); one case of integer features, which tie), and
     on synthetic Reddit at both GraphSAGE layer widths (F = 602, 16), with
     K1 at F = 602 (the mean aggregator's layer 0);
  7. GraphSAGE-pool training (hidden 16, 2 layers) on synthetic Reddit,
     then 3 steps each of the mean and gcn aggregators;
  8. a twin of __graft_entry__.entry(): a GAT forward on a 512-node graph,
     held against the same model on the CPU.
Then the card's name and power limit, the per-kernel JSON line, and as
the last line {"ok": true, "device": {...}}.  Any failure exits non-zero.

Tolerances (max abs error / max |reference|): K1 and K5 <= 2e-5 against
their plain versions run in float64 (the kernels' f32 sums); K2, K3 <=
1e-4 against their f32 plain versions (the exp adds rounding); K4 equal
to its plain version (the max is exact).  Every kernel result must repeat
bitwise across two runs.

Each kernel's bound is the larger of its compulsory bytes (each input
read once, each output written once) at 3.35 TB/s and its operations at
the fp32 rate of 67 TFLOP/s (H100 SXM data sheet); its library time is
one PyTorch call computing the same function where there is one
(``torch.sparse.mm`` on a CSR matrix for K1), timed only.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
K1_TOL, GAT_TOL, K5_TOL = 2e-5, 1e-4, 2e-5
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(out, ref) -> float:
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((out - ref).abs().max()) if ref.numel() else 0.0
    return err / max(scale, 1e-30)


def abs_err(out, ref) -> float:
    return float((out - ref).abs().max()) if ref.numel() else 0.0


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of fn() from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(num_bytes: int, num_ops: float):
    """(ms, what sets it): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = num_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(ms, plain_ms, num_bytes, num_ops, shape, library_ms=None):
    b_ms, b_by = bound(num_bytes, num_ops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "shape": shape}


def k1_ref(sk, indptr, x, gidx=None, eid=None, w=None):
    """K1's plain version run in float64 on the same inputs, rounded to
    float32: the reference then carries no f32 summation error of its own
    (a hub row sums ~10^5 terms, and the f32 plain version's atomic adds
    err about as much as the kernel's fixed-order sum)."""
    return sk.segment_sum_plain(
        indptr, x.double(), gidx, eid,
        None if w is None else w.double()).float()


class Checks:
    """Largest error per kernel, and failures (raised at the end of a
    phase so each phase prints what it measured)."""

    def __init__(self):
        self.max_abs = {}
        self.failures = []

    def compare(self, kernel, what, out, ref, tol, again=None):
        out, ref = out.detach(), ref.detach()
        rel = rel_err(out, ref)
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0),
                                   abs_err(out, ref))
        ok = rel <= tol and bool(out.isfinite().all())
        if again is not None and not bool((out == again).all()):
            self.failures.append(f"{kernel} {what}: not bitwise repeatable")
        if not ok:
            self.failures.append(f"{kernel} {what}: rel err {rel:.3g} > {tol}")
        return rel

    def exact(self, kernel, what, out, ref, again):
        """The kernel's result must equal its plain version's exactly."""
        out, ref = out.detach(), ref.detach()
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0),
                                   abs_err(out, ref))
        if not bool((out == ref).all()):
            self.failures.append(f"{kernel} {what}: differs from plain, max "
                                 f"abs err {abs_err(out, ref):.3g}")
        if not bool((out == again).all()):
            self.failures.append(f"{kernel} {what}: not bitwise repeatable")

    def raise_if_failed(self, phase):
        if self.failures:
            raise SystemExit(f"{phase} failed: " + "; ".join(self.failures))


def phase_build(build):
    t0 = time.perf_counter()
    build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    ptxas = [ln.strip() for ln in str(build.BUILD_INFO.get("ptxas", ""))
             .splitlines() if "registers" in ln or "spill" in ln
             or "entry function" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card, "library": build.BUILD_INFO.get("path"),
          "ptxas": ptxas})
    return card


def _k1_cases(sk, g, F, checks, tag, rng, weights=True):
    """K1 forward (CSC) and dx (CSR) against the plain version."""
    dev = g.device
    x = torch.from_numpy(rng.normal(size=(g.num_src_nodes, F))
                         .astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.normal(size=(g.num_dst_nodes, F))
                            .astype(np.float32)).to(dev)
    E = g.num_edges()
    dst_csr = sk.rev_gidx(g)
    ws = [None]
    if weights:
        ws += [torch.from_numpy(rng.normal(size=(E,)).astype(np.float32))
               .to(dev),
               torch.from_numpy(rng.normal(size=(E, F)).astype(np.float32))
               .to(dev)]
    errs = {}
    for w in ws:
        kind = "none" if w is None else ("scalar" if w.dim() == 1 else "full")
        fwd = dict(indptr=g.csc_indptr, gidx=g.src, w=w)
        rev = dict(indptr=g.csr_indptr, gidx=dst_csr, eid=g.csr_eids, w=w)
        for d, args, inp in (("fwd", fwd, x), ("rev", rev, dout)):
            out = sk.segment_sum(x=inp, site=d, **args)
            again = sk.segment_sum(x=inp, site=d, **args)
            ref = k1_ref(sk, x=inp, **args)
            errs[f"{d}.{kind}"] = checks.compare(
                "segment_sum", f"{tag} F={F} {d} w={kind}", out, ref, K1_TOL,
                again)
    return errs


def _v_side_cases(dt, sk, g, src, dst, checks, rng, F=16):
    """gspmm with a dst-side operand on CUDA: it decomposes into one K1
    forward plus a per-node combine, launches nothing plain, and agrees
    with the same call on the CPU in float64."""
    gc = dt.graph((src, dst), num_nodes=g.num_src_nodes)
    x = rng.uniform(0.5, 1.5, size=(g.num_src_nodes, F))
    y = rng.uniform(0.5, 1.5, size=(g.num_dst_nodes, F))
    errs = {}
    for op, red in (("add", "sum"), ("sub", "mean"), ("dot", "sum")):
        name = f"u_{op}_v.{red}"
        sk.LAUNCHES.reset()
        out = dt.gspmm(g, op, red, torch.from_numpy(x).float().to(g.device),
                       torch.from_numpy(y).float().to(g.device), "u", "v")
        counts = dict(sk.LAUNCHES.counts)
        ref = dt.gspmm(gc, op, red, torch.from_numpy(x),
                       torch.from_numpy(y), "u", "v").float()
        errs[name] = checks.compare("segment_sum", name, out.cpu(), ref,
                                    K1_TOL)
        if counts != {"segment_sum.fwd": 1}:
            checks.failures.append(f"{name}: launches {counts}, expected "
                                   "one segment_sum.fwd and nothing plain")
    return errs


def csr_matrix(g):
    """The graph's CSC direction as a sparse CSR matrix (dst x src) of ones,
    for the library call ``torch.sparse.mm`` that K1's forward matches."""
    return torch.sparse_csr_tensor(
        g.csc_indptr.long(), g.src.long(),
        torch.ones(g.num_edges(), dtype=torch.float32, device=g.device),
        size=(g.num_dst_nodes, g.num_src_nodes))


def phase_k1(dt, sk, checks, dev):
    from dgl_hack_tpu_torch.data import random_power_law_graph
    rng = np.random.default_rng(0)
    # small graph: rows 4000.. have no in-edges, node 0 is a hub
    N = 5000
    src = rng.integers(0, N, 60_000)
    dst = rng.integers(0, 4000, 60_000)
    dst[:12_000] = 0
    g = dt.graph((src, dst), num_nodes=N, device=dev)
    small = {F: _k1_cases(sk, g, F, checks, "small", rng)
             for F in (7, 16, 41, 128)}
    v_side = _v_side_cases(dt, sk, g, src, dst, checks, rng)
    x = torch.from_numpy(rng.normal(size=(N, 128)).astype(np.float32)
                         ).to(dev)
    emit({"phase": "k1_small", "nodes": N, "edges": g.num_edges(),
          "hub_in_degree": int(g.in_degrees()[0]), "rel_err": small,
          "v_side_rel_err": v_side,
          "fwd_ms_F128": cuda_ms(
              lambda: sk.segment_sum(g.csc_indptr, x, g.src)),
          "fwd_plain_ms_F128": cuda_ms(
              lambda: sk.segment_sum_plain(g.csc_indptr, x, g.src))})
    checks.raise_if_failed("k1_small")

    t0 = time.perf_counter()
    gb = random_power_law_graph(1_000_000, 16.0, alpha=2.1, seed=0)
    build_s = time.perf_counter() - t0
    gb = dt.prepare_spmm(gb, device=dev)
    F = 128
    errs = _k1_cases(sk, gb, F, checks, "bench", rng, weights=False)
    x = torch.from_numpy(rng.normal(size=(gb.num_src_nodes, F))
                         .astype(np.float32)).to(dev)
    dst_csr = sk.rev_gidx(gb)
    times = {
        "fwd_ms": cuda_ms(lambda: sk.segment_sum(gb.csc_indptr, x, gb.src)),
        "fwd_plain_ms": cuda_ms(
            lambda: sk.segment_sum_plain(gb.csc_indptr, x, gb.src)),
        "rev_ms": cuda_ms(lambda: sk.segment_sum(
            gb.csr_indptr, x, dst_csr, gb.csr_eids, site="rev")),
        "rev_plain_ms": cuda_ms(lambda: sk.segment_sum_plain(
            gb.csr_indptr, x, dst_csr, gb.csr_eids)),
    }
    A = csr_matrix(gb)
    times["fwd_library_ms"] = cuda_ms(lambda: torch.sparse.mm(A, x))
    del A
    out = sk.segment_sum(gb.csc_indptr, x, gb.src)
    times["fwd_bound_ms"], _ = bound(
        nbytes(gb.csc_indptr, gb.src, x, out), gb.num_edges() * F)
    E = gb.num_edges()
    emit({"phase": "k1_bench_shape", "nodes": gb.num_src_nodes, "edges": E,
          "F": F, "graph_build_s": build_s, "rel_err": errs, **times,
          "fwd_edges_per_s": E / (times["fwd_ms"] * 1e-3),
          "max_in_degree": int(gb.in_degrees().max())})
    checks.raise_if_failed("k1_bench_shape")
    return g


def composed_gat(g, fsrc, el, er, w, slope):
    """Plain composed GAT edge phase in torch (gather, leaky, segment
    softmax, weighted segment sum); autograd gives its gradients."""
    from dgl_hack_tpu_torch.ops import segment
    src, dst = g.src.long(), g.dst.long()
    N = g.num_dst_nodes
    logit = torch.nn.functional.leaky_relu(el[src] + er[dst], slope)
    a = segment.segment_softmax(logit, dst, N)
    if w is not None:
        a = a * w
    return segment.segment_sum(a[:, :, None] * fsrc[src], dst, N)


def _gat_case(gk, g, H, D, mode, checks, rng, tag, scale=1.0):
    dev = g.device
    N, E = g.num_src_nodes, g.num_edges()

    def t(shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape))
                                .astype(np.float32)).to(dev)

    fsrc, el, er = t((N, H, D)), t((N, H), scale), t((N, H), scale)
    w = torch.from_numpy((rng.random((E, H)) > 0.3).astype(np.float32)
                         / 0.7).to(dev)
    dout = t((N, H, D))
    ins = [v.clone().requires_grad_(True) for v in (fsrc, el, er, w)]
    ref = composed_gat(g, *ins, 0.2)
    gref = torch.autograd.grad(ref, ins, dout)
    outs = []
    for _ in range(2):
        kin = [v.clone().requires_grad_(True) for v in (fsrc, el, er, w)]
        out = gk.gat_attention_fused(g, *kin[:3], 0.2, kin[3], softmax=mode)
        outs.append((out, torch.autograd.grad(out, kin, dout)))
    (out, gout), (out2, gout2) = outs
    errs = {"fwd": checks.compare("gat_fwd", f"{tag} H={H} D={D} {mode}",
                                  out, ref, GAT_TOL, out2)}
    for name, a, b, r in zip(("dfsrc", "del", "der", "dattn_w"), gout, gout2,
                             gref):
        errs[name] = checks.compare("gat_bwd", f"{tag} H={H} D={D} {mode} "
                                    f"{name}", a, r, GAT_TOL, b)
    return errs


def phase_gat(dt, gk, checks, dev):
    rng = np.random.default_rng(1)
    N = 20_000
    src = rng.integers(0, N, 400_000)
    dst = rng.integers(0, N - 1000, 400_000)      # 1000 isolated dst rows
    dst[:15_000] = 3                              # a hub
    g = dt.graph((src, dst), num_nodes=N, device=dev)
    res = {}
    for H, D in ((8, 8), (1, 7)):
        for mode in ("shift", "exact"):
            res[f"H{H}D{D}.{mode}"] = _gat_case(gk, g, H, D, mode,
                                                checks, rng, "small")
    # logit spread > 100: only 'exact' is held to it ('shift' underflows)
    res["H8D8.exact.spread"] = _gat_case(gk, g, 8, 8, "exact", checks,
                                         rng, "spread", scale=60.0)
    emit({"phase": "gat_vs_composed", "nodes": N, "edges": g.num_edges(),
          "rel_err": res})
    checks.raise_if_failed("gat_vs_composed")


def _reddit(dt, dev):
    from dgl_hack_tpu_torch.data import synthetic_reddit
    t0 = time.perf_counter()
    ds = synthetic_reddit()
    g = dt.prepare_spmm(ds.graph, device=dev)
    return ds, g, time.perf_counter() - t0


def _train(build, model, ds, g, epochs, lr, dev):
    from dgl_hack_tpu_torch.models.training import train_node_classifier
    build.LAUNCHES.reset()
    res = train_node_classifier(model, g, ds.features, ds.labels,
                                ds.train_mask, ds.val_mask, ds.test_mask,
                                num_epochs=epochs, lr=lr, weight_decay=5e-4,
                                device=dev)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES.counts)
    return res, counts


def _check_training(name, res, counts, need):
    losses = res["losses"]
    problems = []
    if not all(np.isfinite(losses)):
        problems.append(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses}")
    for k in need:
        if counts.get(k, 0) <= 0:
            problems.append(f"kernel {k} never launched")
    plain = {k: v for k, v in counts.items() if k.startswith("plain.")}
    if plain:
        problems.append(f"plain path ran on CUDA: {plain}")
    if problems:
        raise SystemExit(f"{name} failed: " + "; ".join(problems))


def phase_gcn(dt, build, sk, ds, g, checks, dev, timings):
    from dgl_hack_tpu_torch.models import GCN
    rng = np.random.default_rng(2)
    # K1 at the main path's shapes: GCN aggregates at the hidden width 16
    x = torch.from_numpy(rng.normal(size=(g.num_src_nodes, 16))
                         .astype(np.float32)).to(dev)
    dst_csr = sk.rev_gidx(g)
    out = sk.segment_sum(g.csc_indptr, x, g.src)
    ref = k1_ref(sk, g.csc_indptr, x, g.src)
    checks.compare("segment_sum", "reddit F=16 fwd", out, ref, K1_TOL,
                   sk.segment_sum(g.csc_indptr, x, g.src))
    rev = sk.segment_sum(g.csr_indptr, x, dst_csr, g.csr_eids, site="rev")
    checks.compare("segment_sum", "reddit F=16 rev", rev,
                   k1_ref(sk, g.csr_indptr, x, dst_csr,
                                        g.csr_eids), K1_TOL,
                   sk.segment_sum(g.csr_indptr, x, dst_csr, g.csr_eids,
                                  site="rev"))
    A = csr_matrix(g)
    out = sk.segment_sum(g.csc_indptr, x, g.src)
    timings["segment_sum"] = timing(
        cuda_ms(lambda: sk.segment_sum(g.csc_indptr, x, g.src)),
        cuda_ms(lambda: sk.segment_sum_plain(g.csc_indptr, x, g.src)),
        nbytes(g.csc_indptr, g.src, x, out), g.num_edges() * 16,
        "synthetic Reddit, F=16, forward",
        library_ms=cuda_ms(lambda: torch.sparse.mm(A, x)))
    timings["segment_sum"].update(
        rev_ms=cuda_ms(lambda: sk.segment_sum(
            g.csr_indptr, x, dst_csr, g.csr_eids, site="rev")),
        rev_plain_ms=cuda_ms(lambda: sk.segment_sum_plain(
            g.csr_indptr, x, dst_csr, g.csr_eids)))
    del A
    checks.raise_if_failed("gcn kernel check")

    torch.manual_seed(0)
    model = GCN(hidden_feats=16, out_feats=ds.num_classes, num_layers=2,
                dropout=0.5)
    res, counts = _train(build, model, ds, g, 5, 1e-2, dev)
    emit({"phase": "gcn_train", "nodes": g.num_src_nodes,
          "edges": g.num_edges(), "features": int(ds.features.shape[1]),
          "classes": ds.num_classes, "epochs": 5, "losses": res["losses"],
          "train_time_s": res["train_time_s"],
          "epoch_ms": 1e3 * res["train_time_s"] / 4,
          "test_acc": res["test_acc"], "launches": counts,
          "k1_reddit": timings["segment_sum"]})
    _check_training("gcn_train", res, counts,
                    ("segment_sum.fwd", "segment_sum.rev"))
    return counts


def _gat_kernels_at(gk, sk, g, H, D, checks, rng, timings=None):
    """K2, K3 and K1's edge-row (der) call on a graph at head shape (H, D),
    against their plain versions; timed when ``timings`` is given."""
    dev = g.device
    N, E = g.num_src_nodes, g.num_edges()

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    wh, el, er, dout = t((N, H * D)), t((N, H)), t((N, H)), t((N, H * D))
    w = torch.from_numpy((rng.random((E, H)) > 0.6).astype(np.float32)
                         / 0.4).to(dev)
    shift = gk.shift_bound(el, er, 0.2).contiguous()
    fwd_args = (g.csc_indptr, g.src, wh, el, er, w, shift, 0.2, False)
    rst, den, sh = gk.gat_fwd(*fwd_args)
    again = gk.gat_fwd(*fwd_args)
    ref = gk.gat_fwd_plain(*fwd_args)
    for i, name in enumerate(("rst", "den")):
        checks.compare("gat_fwd", f"reddit H={H} D={D} {name}",
                       (rst, den)[i], ref[i], GAT_TOL, again[i])
    del ref, again
    sds = (rst.view(N, H, D) * dout.view(N, H, D)).sum(-1).contiguous()
    bwd_args = (g.csr_indptr, g.csr_eids, sk.rev_gidx(g), wh, el, er, sh,
                den, sds, dout, w, 0.2)
    outs = gk.gat_bwd(*bwd_args)
    outs2 = gk.gat_bwd(*bwd_args)
    refs = gk.gat_bwd_plain(*bwd_args)
    for name, a, b, r in zip(("dwh", "del", "draw", "dw"), outs, outs2, refs):
        checks.compare("gat_bwd", f"reddit H={H} D={D} {name}", a, r,
                       GAT_TOL, b)
    del refs, outs2
    draw = outs[2]
    der = sk.segment_sum(g.csc_indptr, draw, site="edge")
    checks.compare("segment_sum", f"reddit der H={H}", der,
                   k1_ref(sk, g.csc_indptr, draw), K1_TOL,
                   sk.segment_sum(g.csc_indptr, draw, site="edge"))
    if timings is not None:
        shape = f"synthetic Reddit, H={H}, D={D}, attn_w"
        # per edge and head: logit, leaky, exp, weight, den (~8) and D
        # multiply-adds forward; about twice that backward
        timings["gat_fwd"] = timing(
            cuda_ms(lambda: gk.gat_fwd(*fwd_args)),
            cuda_ms(lambda: gk.gat_fwd_plain(*fwd_args), reps=3),
            nbytes(g.csc_indptr, g.src, wh, el, er, w, shift, rst, den),
            E * H * (8 + 2 * D), shape + ", shift mode")
        timings["gat_bwd"] = timing(
            cuda_ms(lambda: gk.gat_bwd(*bwd_args)),
            cuda_ms(lambda: gk.gat_bwd_plain(*bwd_args), reps=3),
            nbytes(*bwd_args[:11], *outs), E * H * (12 + 4 * D), shape)
    del outs, fwd_args, bwd_args
    torch.cuda.empty_cache()


def phase_gat_train(dt, build, gk, sk, ds, g, checks, dev, timings):
    from dgl_hack_tpu_torch.models import GAT
    rng = np.random.default_rng(3)
    N, E = g.num_src_nodes, g.num_edges()
    # the main path's shapes: hidden layer H=8, D=8; output layer H=1, D=41
    _gat_kernels_at(gk, sk, g, 8, 8, checks, rng, timings)
    _gat_kernels_at(gk, sk, g, 1, ds.num_classes, checks, rng)
    checks.raise_if_failed("gat kernel check")

    torch.manual_seed(0)
    model = GAT(hidden_feats=8, out_feats=ds.num_classes, heads=(8, 1),
                feat_drop=0.6, attn_drop=0.6)
    res, counts = _train(build, model, ds, g, 5, 5e-3, dev)
    emit({"phase": "gat_train", "nodes": N, "edges": E,
          "heads": [8, 1], "hidden": 8, "epochs": 5,
          "losses": res["losses"], "train_time_s": res["train_time_s"],
          "epoch_ms": 1e3 * res["train_time_s"] / 4,
          "test_acc": res["test_acc"], "launches": counts,
          "k2_reddit": timings["gat_fwd"], "k3_reddit": timings["gat_bwd"]})
    _check_training("gat_train", res, counts,
                    ("gat_fwd", "gat_bwd", "segment_sum.edge"))
    return counts


def _k4k5_case(sm, sk, g, x, w, gout, checks, what):
    """K4 against its plain version (exactly) and K5 against its plain
    version run in float64 (K5_TOL), each repeated bitwise."""
    raw = sm.segment_max(g.csc_indptr, x, g.src, w)
    checks.exact("segment_max", what, raw,
                 sm.segment_max_plain(g.csc_indptr, x, g.src, w),
                 sm.segment_max(g.csc_indptr, x, g.src, w))
    args = (g.csr_indptr, sk.rev_gidx(g), g.csr_eids, x, w, raw, gout)
    out, again = sm.segment_max_bwd(*args), sm.segment_max_bwd(*args)
    ref = sm.segment_max_bwd_plain(*args, acc_dtype=torch.float64)
    errs = {}
    for name, a, b, r in zip(("dx", "dw"), out, again, ref):
        if r is not None:
            errs[name] = checks.compare("segment_max_bwd", f"{what} {name}",
                                        a, r.float(), K5_TOL, b)
    return raw, errs


def phase_k4k5_small(sm, sk, g, checks):
    """K4/K5 on phase 2's small graph (zero-in-degree rows, a hub of
    12,010 in-edges) at F in {7, 16, 41, 128}, weights none, (E,), (E, F),
    plus integer features, whose messages tie."""
    rng = np.random.default_rng(4)
    dev = g.device
    E = g.num_edges()

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    res = {}
    for F in (7, 16, 41, 128):
        x = t(rng.normal(size=(g.num_src_nodes, F)))
        gout = t(rng.normal(size=(g.num_dst_nodes, F)))
        for kind, w in (("none", None), ("scalar", t(rng.normal(size=E))),
                        ("full", t(rng.normal(size=(E, F))))):
            _, res[f"F{F}.{kind}"] = _k4k5_case(
                sm, sk, g, x, w, gout, checks, f"small F={F} w={kind}")
    x = t(rng.integers(0, 3, size=(g.num_src_nodes, 16)))
    gout = t(rng.normal(size=(g.num_dst_nodes, 16)))
    _, res["ties.F16"] = _k4k5_case(sm, sk, g, x, None, gout, checks,
                                    "small ties F=16")
    emit({"phase": "k4k5_small", "nodes": g.num_src_nodes, "edges": E,
          "rel_err": res})
    checks.raise_if_failed("k4k5_small")


def phase_sage_kernels(sm, sk, g, checks, dev, timings):
    """K4/K5 at the GraphSAGE-pool main path's shapes on synthetic Reddit:
    layer 0 reduces relu(fc_pool(x)) at F = 602, layer 1 at F = 16 (relu
    zeros tie, as on the main path); K1 at F = 602, the mean aggregator's
    layer 0.  Timed with CUDA events against the plain versions."""
    rng = np.random.default_rng(5)
    N, E = g.num_src_nodes, g.num_edges()
    dst_csr = sk.rev_gidx(g)
    res = {}
    for F in (602, 16):
        x = torch.relu(torch.from_numpy(
            rng.normal(size=(N, F)).astype(np.float32)).to(dev))
        gout = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)
                                ).to(dev)
        raw, res[f"F{F}"] = _k4k5_case(sm, sk, g, x, None, gout, checks,
                                       f"reddit F={F}")
        if F == 602:
            shape = "synthetic Reddit, F=602, relu features, no weight"
            timings["segment_max"] = timing(
                cuda_ms(lambda: sm.segment_max(g.csc_indptr, x, g.src)),
                cuda_ms(lambda: sm.segment_max_plain(g.csc_indptr, x, g.src),
                        reps=3),
                nbytes(g.csc_indptr, g.src, x, raw), E * F, shape)
            args = (g.csr_indptr, dst_csr, g.csr_eids, x, None, raw, gout)
            dx, _ = sm.segment_max_bwd(*args)
            timings["segment_max_bwd"] = timing(
                cuda_ms(lambda: sm.segment_max_bwd(*args)),
                cuda_ms(lambda: sm.segment_max_bwd_plain(*args), reps=3),
                nbytes(g.csr_indptr, dst_csr, g.csr_eids, x, raw, gout, dx),
                2 * E * F, shape)
            out = sk.segment_sum(g.csc_indptr, x, g.src)
            res["k1.F602"] = checks.compare(
                "segment_sum", "reddit F=602 fwd", out,
                k1_ref(sk, g.csc_indptr, x, g.src), K1_TOL,
                sk.segment_sum(g.csc_indptr, x, g.src))
            A = csr_matrix(g)
            k1_602 = timing(
                cuda_ms(lambda: sk.segment_sum(g.csc_indptr, x, g.src)),
                cuda_ms(lambda: sk.segment_sum_plain(g.csc_indptr, x, g.src),
                        reps=3),
                nbytes(g.csc_indptr, g.src, x, out), E * F,
                "synthetic Reddit, F=602, forward",
                library_ms=cuda_ms(lambda: torch.sparse.mm(A, x), reps=3))
            del dx, out, args, A
        del x, gout, raw
        torch.cuda.empty_cache()
    emit({"phase": "sage_kernels", "nodes": N, "edges": E, "rel_err": res,
          "k4_reddit": timings["segment_max"],
          "k5_reddit": timings["segment_max_bwd"], "k1_reddit_F602": k1_602})
    checks.raise_if_failed("sage_kernels")


def phase_sage_train(build, ds, g, dev):
    """GraphSAGE-pool on full synthetic Reddit through train_node_classifier
    (5 steps), then the mean and gcn aggregators (3 steps each), at the
    learning rate of examples/train_sage_sampling.py."""
    from dgl_hack_tpu_torch.models import GraphSAGE
    counts = {}
    for agg, epochs, need in (
            ("pool", 5, ("segment_max.fwd", "segment_max.bwd")),
            ("mean", 3, ("segment_sum.fwd", "segment_sum.rev")),
            ("gcn", 3, ("segment_sum.fwd", "segment_sum.rev"))):
        torch.manual_seed(0)
        model = GraphSAGE(hidden_feats=16, out_feats=ds.num_classes,
                          num_layers=2, aggregator_type=agg, dropout=0.5)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, c = _train(build, model, ds, g, epochs, 3e-3, dev)
        emit({"phase": f"sage_{agg}_train", "nodes": g.num_src_nodes,
              "edges": g.num_edges(), "features": int(ds.features.shape[1]),
              "hidden": 16, "epochs": epochs, "losses": res["losses"],
              "train_time_s": res["train_time_s"],
              "epoch_ms": 1e3 * res["train_time_s"] / (epochs - 1),
              "test_acc": res["test_acc"], "launches": c,
              "peak_memory_bytes": torch.cuda.max_memory_allocated()})
        _check_training(f"sage_{agg}_train", res, c, need)
        del model, res
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts


def phase_entry(dt, dev):
    """Twin of __graft_entry__.entry(): GAT forward on a 512-node graph,
    held against the same model on the CPU (plain path)."""
    from dgl_hack_tpu_torch.data import planted_partition
    from dgl_hack_tpu_torch.models import GAT
    ds = planted_partition(512, 5, 64, avg_degree=8.0, seed=0,
                           train_per_class=20, num_val=64, num_test=128)
    torch.manual_seed(0)
    model = GAT(hidden_feats=16, out_feats=ds.num_classes, heads=(4, 1),
                feat_drop=0.0, attn_drop=0.0).eval()
    x = torch.from_numpy(ds.features)
    with torch.no_grad():
        ref = model(ds.graph, x)                 # CPU: materialises params
        out = model.to(dev)(ds.graph.to(dev), x.to(dev))
    rel = rel_err(out.cpu(), ref)
    emit({"phase": "entry_forward", "shape": list(out.shape),
          "rel_err_vs_cpu": rel})
    if tuple(out.shape) != (512, ds.num_classes) or not rel <= GAT_TOL \
            or not torch.isfinite(out).all():
        raise SystemExit(f"entry_forward failed: shape {tuple(out.shape)}, "
                         f"rel err {rel}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
    from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as sm
    from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    card = phase_build(build)
    checks = Checks()
    g_small = phase_k1(dt, sk, checks, dev)
    phase_k4k5_small(sm, sk, g_small, checks)
    del g_small
    phase_gat(dt, gk, checks, dev)
    ds, g, data_s = _reddit(dt, dev)
    emit({"phase": "reddit_data", "nodes": g.num_src_nodes,
          "edges": g.num_edges(), "seconds": data_s})
    timings = {}
    c_gcn = phase_gcn(dt, build, sk, ds, g, checks, dev, timings)
    c_gat = phase_gat_train(dt, build, gk, sk, ds, g, checks, dev,
                            timings)
    phase_sage_kernels(sm, sk, g, checks, dev, timings)
    c_sage = phase_sage_train(build, ds, g, dev)
    del ds, g
    torch.cuda.empty_cache()
    phase_entry(dt, dev)

    runs = (c_gcn, c_gat, c_sage)
    launches = {
        "segment_sum": sum(v for c in runs for k, v in c.items()
                           if k.startswith("segment_sum.")),
        "gat_fwd": c_gat.get("gat_fwd", 0),
        "gat_bwd": c_gat.get("gat_bwd", 0),
        "segment_max": c_sage.get("segment_max.fwd", 0),
        "segment_max_bwd": c_sage.get("segment_max.bwd", 0)}
    tpu = "dgl_hack_tpu/ops/pallas/"
    meta = {
        "segment_sum": ("dgl_hack_tpu_torch/csrc/segment_sum.cu",
                        tpu + "spmm_kernel.py:541"),
        "gat_fwd": ("dgl_hack_tpu_torch/csrc/gat_fwd.cu",
                    tpu + "gat_kernel.py:222"),
        "gat_bwd": ("dgl_hack_tpu_torch/csrc/gat_bwd.cu",
                    tpu + "gat_kernel.py:446"),
        "segment_max": ("dgl_hack_tpu_torch/csrc/segment_max.cu",
                        tpu + "spmm_kernel.py:675"),
        "segment_max_bwd": ("dgl_hack_tpu_torch/csrc/segment_max.cu",
                            tpu + "spmm_kernel.py:1109")}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": n, "route": "cuda", "source": s, "replaces": r,
                "launches": launches[n], "max_abs_err": checks.max_abs[n],
                **{k: timings[n][k] for k in keys}}
               for n, (s, r) in meta.items()]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
