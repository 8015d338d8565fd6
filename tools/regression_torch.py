"""Regression harness of the PyTorch port (twin of tools/regression.py):
run the example twins at pinned configs and collect their JSON result
lines into one report.

The matrix is tools/regression.py's, row for row, pointed at the
``examples/*_torch.py`` twins with the same arguments, plus ``--device``.
Every twin prints one JSON line; this tool runs the matrix, collects the
lines, records the device, and (optionally) diffs against a previous
report to flag rows that got slower than ``--time-tolerance`` times the
baseline's ``train_time_s`` or lost more than 0.05 of ``test_acc`` or
``mrr``.

Usage:
  python tools/regression_torch.py --out regression_report_torch.json
  python tools/regression_torch.py --out new.json \\
      --baseline regression_baseline_torch.json --time-tolerance 1.3
  python tools/regression_torch.py --only pagerank --device cpu

The twins run on the card (``--device cuda``, the default); without one
the tool raises unless given ``--device cpu``.  A row whose twin exits
non-zero is ``ok: false``, and the run then exits 1; with ``--baseline``
it also exits 1 when a row is flagged.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pinned matrix: (twin, args), tools/regression.py's rows
MATRIX = [
    ("train_gcn_torch.py", ["--dataset", "synth", "--epochs", "60"]),
    ("train_gat_torch.py", ["--dataset", "synth", "--epochs", "60"]),
    ("train_gin_torch.py", ["--dataset", "synth", "--epochs", "20"]),
    ("train_sgc_torch.py", ["--dataset", "synth", "--epochs", "40"]),
    ("train_appnp_torch.py", ["--dataset", "synth", "--epochs", "40"]),
    ("train_sage_sampling_torch.py", ["--num-epochs", "3"]),
    ("train_rgcn_torch.py", ["--epochs", "30"]),
    # AM-like row: ~90 relations, larger and sparser label set than AIFB
    ("train_rgcn_torch.py", ["--dataset", "am", "--epochs", "12",
                             "--scale", "0.01"]),
    ("train_tagcn_torch.py", ["--dataset", "synth", "--epochs", "60"]),
    ("train_ggnn_torch.py", ["--epochs", "20", "--graphs", "40",
                             "--nodes", "20"]),
    ("train_rgcn_hetero_torch.py", ["--epochs", "40", "--papers", "300"]),
    ("train_sage_cv_torch.py", ["--epochs", "10", "--nodes", "1500",
                                "--batch-size", "128"]),
    ("train_kg_torch.py", ["--max_step", "300"]),
    ("train_kg_dist_torch.py", ["--steps", "80", "--scale", "0.02",
                                "--batch", "256", "--neg", "32",
                                "--chunk", "32", "--eval_triples", "100"]),
    ("train_chem_torch.py", ["--model", "gcn", "--epochs", "15"]),
    ("train_chem_torch.py", ["--model", "schnet", "--epochs", "10"]),
    ("train_chem_torch.py", ["--model", "weave", "--epochs", "12"]),
    ("train_chem_torch.py", ["--model", "wln", "--epochs", "12"]),
    ("train_han_torch.py", ["--epochs", "30", "--papers", "200"]),
    ("train_cluster_gcn_torch.py", ["--epochs", "10", "--parts", "4"]),
    ("train_dgi_torch.py", ["--epochs", "30"]),
    ("train_gcmc_torch.py", ["--epochs", "50"]),
    ("train_dgmg_torch.py", ["--epochs", "8", "--n_graphs", "16"]),
    ("train_metapath2vec_torch.py", ["--epochs", "3"]),
    ("train_pinsage_rec_torch.py", ["--epochs", "40"]),
    ("train_transformer_torch.py", ["--epochs", "150"]),
    ("train_rrn_torch.py", ["--epochs", "200", "--batch", "48"]),
    ("train_adaptive_sampling_torch.py", ["--epochs", "120"]),
    ("train_capsule_torch.py", ["--epochs", "60"]),
    ("train_graphwriter_torch.py", ["--epochs", "400"]),
    ("train_tree_lstm_torch.py", ["--epochs", "8", "--n_trees", "24"]),
    ("pagerank_torch.py", ["--n", "80", "--iters", "15"]),
]


def device_record(device):
    """The card's name (torch) and nvidia-smi's name and power limit, or
    "cpu"."""
    if device == "cpu":
        return "cpu"
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}"}


def check_device(device):
    """Raise unless the device asked for is there."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run "
                               "the twins on the CPU")


def run_one(script, args, device="cuda"):
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "") + os.pathsep + REPO
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", script)] + args
            + ["--device", device],
            capture_output=True, text=True, timeout=1200, env=env, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"script": script, "args": args, "ok": False,
                "wall_s": round(time.perf_counter() - t0, 2),
                "result": None, "stderr_tail": "TIMEOUT"}
    wall = time.perf_counter() - t0
    last = None
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            last = json.loads(line)
            break
        except json.JSONDecodeError:
            continue
    return {"script": script, "args": args, "ok": proc.returncode == 0,
            "wall_s": round(wall, 2), "result": last,
            "stderr_tail": proc.stderr.strip().splitlines()[-1]
            if proc.returncode != 0 and proc.stderr.strip() else None}


def compare(new, baseline, time_tol):
    """Flag runs that got slower than tol x baseline or lost accuracy."""
    base = {(r["script"], tuple(r["args"])): r for r in baseline["runs"]}
    flags = []
    for r in new["runs"]:
        b = base.get((r["script"], tuple(r["args"])))
        if b is None or not (r["ok"] and b["ok"]):
            continue
        nr, br = r["result"] or {}, b["result"] or {}
        t_new = nr.get("train_time_s")
        t_old = br.get("train_time_s")
        if t_new and t_old and t_new > time_tol * t_old:
            flags.append(f"{r['script']} {r['args']}: time "
                         f"{t_old} -> {t_new}")
        for key in ("test_acc", "mrr"):
            if key in nr and key in br and nr[key] < br[key] - 0.05:
                flags.append(f"{r['script']} {r['args']}: {key} "
                             f"{br[key]} -> {nr[key]}")
    return flags


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="regression_report_torch.json")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--time-tolerance", type=float, default=1.3)
    ap.add_argument("--only", default=None,
                    help="substring filter on script names")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="passed to every twin")
    args = ap.parse_args()
    check_device(args.device)

    runs = []
    t0 = time.perf_counter()
    for script, sargs in MATRIX:
        if args.only and args.only not in script:
            continue
        r = run_one(script, sargs, args.device)
        print(json.dumps(r), flush=True)
        runs.append(r)
    report = {"runs": runs, "ts": time.time(),
              "wall_s": round(time.perf_counter() - t0, 2),
              "device": device_record(args.device),
              "n_ok": sum(r["ok"] for r in runs), "n": len(runs)}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)

    failed = report["n_ok"] != report["n"]
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)
        flags = compare(report, baseline, args.time_tolerance)
        for fl in flags:
            print("REGRESSION:", fl)
        sys.exit(1 if flags or failed else 0)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
