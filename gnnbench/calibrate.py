"""Read the two ends of each limit of a cell (how ``correct`` is decided):
the program against the reference on many seeds (the lower reading),
and, on a few seeds, the control (the reference in TF32 in the
program's place) and the faults a training cell can have, planted in the
reference in the program's place (the upper reading).

    python3 gnnbench/calibrate.py --workload gat.reddit \
        --seeds 11,12,13 --control-seeds 11,12,13 \
        --out build/gnnbench/calibrate.jsonl

One process runs every seed: set-up and the program's first steps as a
run makes them (no timed window), then the reference and its variants.
Each reading is one JSON line, on standard output and in ``--out``.  A
step that returns its state unchanged reads 1 by ``change`` and needs no
run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

VARIANTS = (("control", "tf32", None), ("half_batch", "float32", "half_batch"),
            ("answer", "float32", "answer"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from gnnbench import compare, harness, plugins
    cell = plugins.cell(args.workload)
    dev = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in sorted(set(seeds) | set(control)):
        t0 = time.perf_counter()
        p = harness.prepare(cell, seed, dev, t0)
        harness.free_program(p)
        t = time.perf_counter()
        ref = harness.reference_run(p)
        ref_s = time.perf_counter() - t
        if seed in seeds:
            emit({"workload": cell.name, "seed": seed, "kind": "program",
                  "setup_s": p.setup["setup_s"], "reference_s": ref_s,
                  "losses": p.prog.losses, "ref_losses": ref.losses,
                  **compare.readings(p.prog, ref, p.params0),
                  "leaves": compare.leaf_gaps(p.prog, ref, p.params0)})
        if seed in control:
            for kind, precision, fault in VARIANTS:
                t = time.perf_counter()
                run = harness.reference_run(p, precision, fault)
                emit({"workload": cell.name, "seed": seed, "kind": kind,
                      "seconds": time.perf_counter() - t,
                      **compare.readings(run, ref, p.params0)})
        del p, ref
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
