"""Time K1 (``csrc/segment_sum.cu``) built from several source directories,
in turns, in one process on the card.

Each ``--src NAME=DIR`` names a directory that holds a ``segment_sum.cu``
and the headers it includes: a checkout's ``dgl_hack_tpu_torch/csrc``, such
as a parent commit's unpacked with ``git archive``, or a copy with one
change.  ``tree`` (always first) is this checkout's.  Each is compiled
alone with nvcc (sm_90a, ``-Xptxas -v``) into ``build/k1_builds/`` and
bound with the C signatures of ``ops/cuda/build.py``; the port's K1 wrapper
(``segment_sum_launcher``) then runs over each library in turn, A, B, ...,
B, A at every point, so that two builds compare within one process on one
card.  The sources must keep this checkout's C interface.

Points (``--shapes``): bench.py's graph (power-law, 1,000,000 nodes,
in-degree 16) at F = 128, the sampled GraphSAGE's masked layer-0 block
through its real-edge view at F = 602, synthetic Reddit at 602 padded to
640 as gspmm runs it, and (``mixed``, not by default) ``chip_smoke.py``'s
graph of short rows around hubs at F = 10 and 16; the forward (CSC) and
dx (CSR) of each, over bf16 rows and float32 rows, at each load width of
``--vecs`` (bf16; float32 at its rule's width), at the rule's feature slice and each of ``--slices``
under F, on the rule's route and, with ``--routes both``, the other one
where half the rows or more are short (what ``K1_PACK_SHARE`` rests on).
bench.py's forward also runs with an (E,) and an (E, F) float32 weight.
Every result is held to K1's plain version in float64 (bf16: one bf16 ulp
plus K1_TOL of max|ref|, float32: K1_TOL of max|ref|, as ``chip_smoke.py``
holds K1) and must repeat bitwise.  Times are ``chip_smoke.cuda_ms``'s
(CUDA events, median of ``--reps``), each the mean of a build's two turns.

Prints one JSON line a build (ptxas's registers and spills of each K1
kernel, ``chip_smoke.k1_ptxas``) and one a point, and the card's name and
power limit.  Needs one card; exits 1 where a result fails its check.

Usage (from the repository root, on the card):
  git archive HEAD dgl_hack_tpu_torch/csrc | tar -x -C build/parent
  python3 tools/k1_builds_torch.py \
      --src parent=build/parent/dgl_hack_tpu_torch/csrc
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT_DIR = REPO / "build" / "k1_builds"
SHAPES = ("bench", "masked", "reddit")


def compile_k1(name: str, src: Path, build) -> dict:
    """Start nvcc on ``src/segment_sum.cu`` into a library keyed by the
    sources' hash; returns the build's record with its process."""
    digest = hashlib.sha256()
    for p in sorted(src.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = OUT_DIR / f"k1_{name}_{digest.hexdigest()[:12]}.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so),
         str(src / "segment_sum.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"name": name, "src": str(src), "so": so, "proc": proc}


def load_k1(rec: dict, build) -> ctypes.CDLL:
    out, err = rec.pop("proc").communicate()
    if not Path(rec["so"]).exists():
        raise SystemExit(f"nvcc failed on {rec['src']}:\n{out}\n{err}")
    rec["log"] = err
    lib = ctypes.CDLL(str(rec["so"]))
    for fn in ("segment_sum_f32", "segment_sum_bf16"):
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def graphs(shapes, dt, cs, dev):
    """{shape: (graph, F the function's columns, F as run)}."""
    out = {}
    if "mixed" in shapes:
        g = cs._mixed_short_graph(dt, dev, np.random.default_rng(33))
        for F in (10, 16):
            out[f"mixed F={F}"] = (g, F, F)
    if "bench" in shapes:
        from dgl_hack_tpu_torch.data import random_power_law_graph
        gb = random_power_law_graph(1_000_000, 16.0, alpha=2.1, seed=0)
        out["bench"] = (dt.prepare_spmm(gb, dense_hub=False, device=dev),
                        128, 128)
    if "masked" in shapes:
        from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
        mb = cs._masked_block(dt, dev, np.random.default_rng(22))
        out["masked"] = (sk.real_edges(mb).graph, 602, 602)
    if "reddit" in shapes:
        from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
        _, g, _ = cs._reddit(dt, dev)
        out["reddit"] = (g, 602, sk.padded_width(g.num_src_nodes, 602, None,
                                                 2))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=DIR of another segment_sum.cu's sources")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--vecs", default="4,8")
    ap.add_argument("--slices", default="64,128")
    ap.add_argument("--routes", choices=("rule", "both"), default="both")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_builds_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.ops.cuda import build
    from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
    dev = torch.device("cuda", 0)
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [("tree", build.CSRC)] + [
        (s.split("=", 1)[0], Path(s.split("=", 1)[1])) for s in args.src]
    t0 = time.perf_counter()
    recs = [compile_k1(n, Path(p), build) for n, p in srcs]
    libs = {}
    for rec in recs:
        libs[rec["name"]] = load_k1(rec, build)
        emit({"build": rec["name"], "src": rec["src"],
              "k1_ptxas": cs.k1_ptxas(rec["log"])})
    emit({"builds_s": time.perf_counter() - t0})
    names = list(libs)
    turns = names + names[::-1]
    failures = []
    vecs = [int(v) for v in args.vecs.split(",")]
    slices = [int(c) for c in args.slices.split(",") if c]
    rng = np.random.default_rng(0)
    for shape, (g, F, Fp) in graphs(args.shapes.split(","), dt, cs,
                                    dev).items():
        t_shape = time.perf_counter()
        E = g.num_edges()
        dirs = {"fwd": (g.csc_indptr, g.src, None, g.num_src_nodes,
                        sk.graph_row_plan(g, "csc")),
                "dx": (g.csr_indptr, sk.rev_gidx(g), g.csr_eids,
                       g.num_dst_nodes, sk.graph_row_plan(g, "csr"))}
        res = {}
        for d, (indptr, gidx, eid, rows, plan) in dirs.items():
            x32 = torch.from_numpy(rng.normal(size=(rows, F)).astype(
                np.float32)).to(dev)
            weights = [("none", None)]
            if shape == "bench" and d == "fwd":
                weights += [
                    ("E", torch.from_numpy(rng.normal(size=(E,)).astype(
                        np.float32)).to(dev)),
                    ("EF", torch.from_numpy(rng.normal(size=(E, Fp)).astype(
                        np.float32)).to(dev))]
            for dtype in (torch.bfloat16, torch.float32):
                x = sk.pad_columns(x32.to(dtype), Fp)
                for wname, w in weights:
                    launch = sk.segment_sum_launcher(indptr, x, gidx, eid, w,
                                                     plan=plan)
                    ref = sk.segment_sum_plain(
                        indptr, x.double(), gidx, eid,
                        None if w is None else w.double())
                    rule_slice, rule_vec, rule_route = launch.widths()
                    points = [(rule_slice, rule_vec)]
                    if dtype == torch.bfloat16:
                        points += [(rule_slice, v) for v in vecs]
                        points += [(c, v) for c in slices if c < Fp
                                   for v in vecs]
                    seen = set()
                    for c, v in points:
                        if Fp % v or c % v:
                            continue
                        routes = [rule_route if (c, v) == (
                            rule_slice, rule_vec) else launch.route(c, v)]
                        # the other route, where half the rows are short
                        num_rows = indptr.numel() - 1
                        if args.routes == "both" and 2 * plan.short_rows(
                                num_rows) >= num_rows:
                            routes += [r for r in ("rows", "packed")
                                       if r not in routes]
                        tag = "f32" if dtype == torch.float32 else "bf16"
                        for route in routes:
                            key = (f"{d} {tag} w={wname} slice={min(c, Fp)}"
                                   f" vec={v} {route}")
                            if key in seen:
                                continue
                            seen.add(key)

                            def call(c=c, v=v, route=route):
                                return launch(c, v, route)
                            row = {}
                            for name in names:
                                build._LIB = libs[name]
                                out = call()
                                again = call()
                                if dtype == torch.float32:
                                    err = cs.rel_err(out.double(), ref)
                                    bad = err > cs.K1_TOL
                                else:
                                    err = cs.bf16_err(out, ref)
                                    bad = err > cs.BF16_ULPS
                                if bad or not torch.equal(out, again):
                                    failures.append(f"{name} {shape} {key}:"
                                                    f" err {err:.3g}")
                                row[f"{name}_err"] = err
                                del out, again
                            ms = {n: [] for n in names}
                            for name in turns:
                                build._LIB = libs[name]
                                ms[name].append(cs.cuda_ms(call,
                                                           reps=args.reps))
                            row.update({f"{n}_ms": float(np.mean(ms[n]))
                                        for n in names})
                            row["rule"] = (c, v, route) == (
                                rule_slice, rule_vec, rule_route)
                            res[key] = row
                    del ref
                del x
            del x32
        emit({"shape": shape, "edges": E, "F": F, "F_run": Fp,
              "seconds": time.perf_counter() - t_shape, "points": res})
        del g
        torch.cuda.empty_cache()
    build._LIB = None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"card": smi.stdout.strip(), "failures": failures})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
