"""Real-dataset accuracy runbook of the PyTorch port (twin of
tools/validate_real.py, targets from BASELINE.md).

The raw datasets are not in the repository and this tool downloads
nothing, so the real runs wait for the data: every loader of the port
falls back to a synthetic stand-in when its files are missing.  Place
the raw files under ``$DGL_DOWNLOAD_DIR`` (default ``~/.dgl_tpu``), in the
layout tools/validate_real.py gives (formats checked by
tests/test_torch_datasets.py over tests/fixtures/data), and this tool runs
each config whose probe file is there through its ``examples/*_torch.py``
twin and compares the metric with the reference's published number.

Usage:
    python tools/validate_real_torch.py            # run what data is present
    python tools/validate_real_torch.py --only gcn_cora gat_cora
    python tools/validate_real_torch.py --dry-run  # what would run

Statuses: ``skipped`` (probe file missing), ``would_run`` (``--dry-run``),
``ok``, ``BELOW`` (under target - tol) and ``error`` (the twin failed or
printed no metric).  Exit code 1 if any config is BELOW or error.  The
twins run on the card (``--device cuda``, the default); without one the
tool raises unless given ``--device cpu``.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.environ.get("DGL_DOWNLOAD_DIR", os.path.expanduser("~/.dgl_tpu"))

# name -> (presence-check path, argv, metric key, target, tolerance)
CONFIGS = {
    "gcn_cora": ("cora/ind.cora.graph",
                 ["examples/train_gcn_torch.py", "--dataset", "cora",
                  "--epochs", "200"],
                 "test_acc", 0.813, 0.015),
    "gat_cora": ("cora/ind.cora.graph",
                 ["examples/train_gat_torch.py", "--dataset", "cora",
                  "--epochs", "200"],
                 "test_acc", 0.840, 0.015),
    "gat_citeseer": ("citeseer/ind.citeseer.graph",
                     ["examples/train_gat_torch.py", "--dataset",
                      "citeseer", "--epochs", "200"],
                     "test_acc", 0.709, 0.015),
    "sage_reddit": ("reddit/reddit_data.npz",
                    ["examples/train_sage_sampling_torch.py", "--dataset",
                     "reddit", "--num-epochs", "10"],
                    "test_acc", 0.950, 0.01),
    "rgcn_aifb": ("aifb/aifb.npz",
                  ["examples/train_rgcn_torch.py", "--dataset", "aifb",
                   "--epochs", "50"],
                  "test_acc", 0.972, 0.03),
    "rgcn_am": ("am/am.npz",
                ["examples/train_rgcn_torch.py", "--dataset", "am",
                 "--epochs", "50", "--num-bases", "40"],
                "test_acc", 0.874, 0.03),
    "transe_fb15k": ("FB15k/train.txt",
                     ["examples/train_kg_torch.py", "--dataset", "FB15k",
                      "--model", "TransE_l2", "--max_step", "32000",
                      "--batch_size", "1024", "--neg_sample_size", "256",
                      "--hidden_dim", "400", "--lr", "0.25",
                      "--gamma", "19.9"],
                     "MRR", 0.665, 0.02),
    "distmult_fb15k": ("FB15k/train.txt",
                       ["examples/train_kg_torch.py", "--dataset", "FB15k",
                        "--model", "DistMult", "--max_step", "32000",
                        "--batch_size", "1024", "--neg_sample_size", "256",
                        "--hidden_dim", "400", "--lr", "0.08"],
                       "MRR", 0.725, 0.02),
}


def _metric(stdout: str, key: str):
    """The metric from the twin's last JSON line, or None."""
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        res = json.loads(lines[-1])
    except json.JSONDecodeError:
        return None
    val = res.get(key) if isinstance(res, dict) else None
    return float(val) if isinstance(val, (int, float)) else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of config names")
    ap.add_argument("--dry-run", action="store_true",
                    help="print what would run, without running")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="passed to every twin")
    args = ap.parse_args()
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu to run "
                               "the twins on the CPU")

    results = {}
    for name, (probe, argv, key, target, tol) in CONFIGS.items():
        if args.only and name not in args.only:
            continue
        present = os.path.exists(os.path.join(DATA, probe))
        if not present:
            results[name] = {"status": "skipped",
                             "reason": f"missing {probe} under {DATA}"}
            continue
        argv = argv + ["--device", args.device]
        if args.dry_run:
            results[name] = {"status": "would_run", "argv": argv}
            continue
        out = subprocess.run([sys.executable] + argv, cwd=REPO,
                             capture_output=True, text=True, timeout=7200)
        val = _metric(out.stdout, key) if out.returncode == 0 else None
        if val is None:
            results[name] = {"status": "error",
                             "stderr": out.stderr[-500:]}
            continue
        results[name] = {"status": "ok" if val >= target - tol else "BELOW",
                         key: val, "target": target, "tol": tol}
    print(json.dumps(results, indent=2))
    bad = [n for n, r in results.items() if r["status"] in ("BELOW", "error")]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
