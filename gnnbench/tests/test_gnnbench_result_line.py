"""The shape of a run's last line, and the refusal without a card."""
import json
import subprocess
import sys

import pytest
import torch

from gnnbench import harness, plugins
from conftest import ROOT, tiny_cell

RUN = ROOT / "gnnbench" / "run.py"


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    cell = tiny_cell("graphsage-mean.reddit")
    res, lines = harness.run_cell(cell, 4, 0.2, trace, "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(res["metrics"]) <= names
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    else:
        assert names == set(res["metrics"])
    assert [ln.split()[1] for ln in lines] == list(res["checks"])
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(res, allow_nan=False))


def test_finite_makes_strict_json():
    sys.path.insert(0, str(RUN.parent))
    import run
    obj = {"a": [float("inf"), 1.5], "b": float("nan")}
    line = json.dumps(run.finite(obj), allow_nan=False)
    assert json.loads(line) == {"a": ["inf", 1.5], "b": "nan"}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, str(RUN), "--workload",
                          "gat.reddit", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


@pytest.mark.card
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    res = subprocess.run([sys.executable, str(RUN), "--workload",
                          "graphsage-mean.reddit", "--seed", "3",
                          "--seconds", "2"], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in plugins.cell(
        "graphsage-mean.reddit").end_to_end}
