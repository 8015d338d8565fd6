"""The port's tools (``tools/*_torch.py``) against the JAX package's
(``tools/*.py``).

* ``partition_torch.py`` on the cora stand-in writes the arrays
  ``partition.py`` writes (both run in-process, as tests/test_examples.py
  runs the JAX tool);
* ``regression_torch.py --only pagerank --device cpu`` writes a report
  whose row is ``ok``; its ``compare`` flags what the JAX ``compare``
  flags on hand-made reports;
* ``validate_real_torch.py --dry-run`` over tests/fixtures/data gives each
  config the JAX tool's status;
* ``scaling_torch.py``'s accounting (``_exchange_bytes``, the stats keys,
  per-layer bytes, the link projection) equals tools/scaling.py's on one
  plan at P = 2 and 4 of a 2,000-node graph (the JAX tool imported by path
  here only), and one ``run_spatial`` row at P = 2 over spawned gloo ranks
  on the CPU gives the single-process gspmm's rows within 1e-6 of their
  largest.
"""
import copy
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dgl_hack_tpu as jdgl
from dgl_hack_tpu.parallel import build_spatial_plan as jax_plan

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.parallel import build_spatial_plan as port_plan

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "data")


def _tool(name):
    """tools/<name>.py, imported by path."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_in_process(path, argv, capsys):
    """A CLI run as ``__main__`` in this process (test_examples.py)."""
    old = sys.argv
    sys.argv = ["x"] + argv
    full = os.path.join(REPO, path)
    try:
        exec(compile(open(full).read(), full, "exec"),
             {"__name__": "__main__", "__file__": full})
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_partition_tool_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path / "nodata"))
    outs = {}
    for name in ("partition", "partition_torch"):
        outs[name] = _run_in_process(
            f"tools/{name}.py",
            ["--dataset", "cora", "--num-parts", "3", "--num-hops", "1",
             "--output", str(tmp_path / name / "cora")], capsys)
    lines = {k: [ln for ln in v.splitlines() if ln.startswith("part ")]
             for k, v in outs.items()}
    assert len(lines["partition"]) == 3
    assert lines["partition_torch"] == lines["partition"]
    for i in range(3):
        with np.load(tmp_path / "partition" / f"cora.part{i}.npz") as a, \
                np.load(tmp_path / "partition_torch" /
                        f"cora.part{i}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_regression_tool_runs_pagerank_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "regression_torch.py"),
         "--only", "pagerank", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["n"] == 1
    row = report["runs"][0]
    assert row["ok"] and row["script"] == "pagerank_torch.py"
    assert row["args"] == ["--n", "80", "--iters", "15"]
    assert row["result"]["model"] == "pagerank"


def test_regression_matrix_mirrors_jax():
    jax_tool, port_tool = _tool("regression"), _tool("regression_torch")
    assert [(s.replace(".py", "_torch.py"), a) for s, a in jax_tool.MATRIX] \
        == port_tool.MATRIX


def _report(rows):
    return {"runs": [{"script": s, "args": a, "ok": ok, "result": res}
                     for s, a, ok, res in rows]}


def test_regression_compare_flags_what_jax_flags():
    jax_tool, port_tool = _tool("regression"), _tool("regression_torch")
    base = _report([
        ("a.py", ["--x"], True, {"train_time_s": 1.0, "test_acc": 0.9}),
        ("b.py", [], True, {"train_time_s": 2.0, "mrr": 0.5}),
        ("c.py", [], True, {"train_time_s": 1.0}),
        ("d.py", [], False, None),
        ("e.py", ["--y", "1"], True, {"test_acc": 0.8}),
        ("f.py", [], True, {"train_time_s": 1.0, "test_acc": 0.7}),
    ])
    new = _report([
        ("a.py", ["--x"], True, {"train_time_s": 1.31, "test_acc": 0.84}),
        ("b.py", [], True, {"train_time_s": 2.5, "mrr": 0.46}),
        ("c.py", [], False, None),                      # failed: skipped
        ("d.py", [], True, {"train_time_s": 9.0}),      # no good baseline
        ("e.py", ["--y", "1"], True, {"test_acc": 0.70}),
        ("e.py", ["--y", "2"], True, {"test_acc": 0.10}),   # new row
        ("f.py", [], True, {"train_time_s": 1.3, "test_acc": 0.65}),
    ])
    for tol in (1.3, 1.2):
        flags = port_tool.compare(copy.deepcopy(new), copy.deepcopy(base),
                                  tol)
        assert flags == jax_tool.compare(new, base, tol)
        assert flags
    assert port_tool.compare(base, base, 1.3) == []


def _dry_run(tool, *extra):
    env = dict(os.environ, DGL_DOWNLOAD_DIR=FIXTURES)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", tool), "--dry-run",
         *extra], capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


def test_validate_real_dry_run_matches_jax():
    port = _dry_run("validate_real_torch.py", "--device", "cpu")
    jax_res = _dry_run("validate_real.py")
    configs = _tool("validate_real_torch").CONFIGS
    assert set(port) == set(jax_res) == set(configs)
    for name, (probe, argv, *_) in configs.items():
        present = os.path.exists(os.path.join(FIXTURES, probe))
        want = "would_run" if present else "skipped"
        assert port[name]["status"] == jax_res[name]["status"] == want, name
        if present:
            assert port[name]["argv"] == argv + ["--device", "cpu"]
            assert jax_res[name]["argv"][1:] == argv[1:]
            assert argv[0] == jax_res[name]["argv"][0].replace(
                ".py", "_torch.py")
    assert {n for n, r in port.items() if r["status"] == "skipped"}


def _graphs(n=2000):
    return (jdgl.data.random_power_law_graph(n, avg_degree=16.0, alpha=2.1,
                                             seed=0),
            dt.data.random_power_law_graph(n, avg_degree=16.0, alpha=2.1,
                                           seed=0))


@pytest.mark.parametrize("P,hub_k", [(2, 0), (4, 0), (4, 16)])
def test_scaling_accounting_matches_jax(P, hub_k):
    jax_tool, port_tool = _tool("scaling"), _tool("scaling_torch")
    gj, gt = _graphs()
    jp = jax_plan(gj, P, method="fennel", seed=0, hub_k=hub_k)
    tp = port_plan(gt, P, method="fennel", seed=0, hub_k=hub_k)
    jst, tst = jp.stats(), port_tool.plan_stats(tp)
    for k, v in tst.items():
        assert v == jst[k], k
    F, hidden = 128, 32
    for width in (1, 16, F):
        assert port_tool._exchange_bytes(tp, width) == \
            jax_tool._exchange_bytes(jp, width)
    for wire, nbytes in (("f32", 4), ("bf16", 2)):
        assert port_tool.copy_bytes(tp, F, wire) == \
            jax_tool._exchange_bytes(jp, F) * nbytes // 4
        # tools/scaling.py's run_spatial_model: layer widths gat [F, 4h],
        # rgcn [F, h]; a step ships each layer forward and back
        for model, widths in (("gat", [F, hidden * 4]),
                              ("rgcn", [F, hidden])):
            assert port_tool.layer_widths(model, F, hidden) == widths
            per_layer, step = port_tool.model_bytes(
                tp, port_tool.layer_widths(model, F, hidden), wire)
            ref = [jax_tool._exchange_bytes(jp, w) * nbytes // 4
                   for w in widths]
            assert per_layer == ref and step == 2 * sum(ref)
        # the projection: tools/scaling.py's formula (which rounds) with
        # the rate and link throughput given, not a TPU's
        for width in (F, 4 * F):
            got = port_tool.project_link(tst, width, 3.0, 50.0, nbytes)
            ref = jax_tool.project_ici(jst, width, 3.0, 50.0, nbytes)
            for k, v in ref.items():
                assert got[k] == pytest.approx(v, abs=1e-4), k


def test_scaling_run_spatial_on_gloo_ranks():
    port_tool = _tool("scaling_torch")
    from dgl_hack_tpu_torch.parallel.launch import RankPool
    _, g = _graphs()
    x = np.random.default_rng(0).normal(size=(2000, 16)).astype(np.float32)
    with RankPool(2, "gloo", "cpu", timeout=120) as pool:
        row, out, st = port_tool.run_spatial(
            g, x, 2, "fennel", pool, device="cpu", backend="gloo",
            reps=1, k_lo=1, k_hi=2, wire="f32")
    ref = dt.gspmm(g, "copy_lhs", "sum", torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    assert row["ok"] and row["rel_err_vs_single"] <= 1e-6
    assert row["P"] == 2 and row["backend"] == "gloo"
    assert row["ranks_share_card"] is False
    assert row["a2a_bytes_per_step"] == port_tool.copy_bytes(
        port_plan(g, 2, method="fennel", seed=0), 16)
    assert st["num_parts"] == 2 and len(row["step_ms_per_rank"]) == 2
    assert row["step_ms"] == max(row["step_ms_per_rank"]) > 0
