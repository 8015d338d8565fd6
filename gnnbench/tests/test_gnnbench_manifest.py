"""BENCHMARK.json against the contract's shape: names, units and keys,
and every part it names found by name."""
import json
import re

import pytest

from gnnbench import plugins

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
MAN = plugins.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "gnnbench/run.py"]
    assert MAN["paths"] == ["gnnbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(plugins.MANIFEST.read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) \
        == len(MAN["workloads"])


def test_metrics_entries():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:       # one layer, one name
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_follow_their_files():
    for c in MAN["configs"]:
        assert c["file"] == f"gnnbench/configs/{c['name']}.json"
        data = json.loads((plugins.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_part_is_found_by_name(cell):
    c = plugins.cell(cell)
    plugins.load_module("graphs", c.traffic["generator"])
    plugins.load_module("configs", c.config_name)
    plugins.load_module("models", c.config_name)
    plugins.load_module("counts", c.config_name)
    for m in c.end_to_end + c.per_layer:
        assert callable(plugins.load_module("metrics", m["name"]).read)
    assert set(c.limits) == {"logits", "loss", "grad", "change"}
    # every cell reports setup_s, another end-to-end and a per-layer metric
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_each_per_layer_metric_moves_one_its_cells_report():
    cells = [w["name"] for w in MAN["workloads"]]
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            if "workloads" in m:
                assert plugins.applies(moved, cell), (m["name"], cell)
        # in every cell that reads it, the metric it moves is reported
        for cell in cells:
            c = plugins.cell(cell)
            if m in c.per_layer:
                assert moved in c.end_to_end, (m["name"], cell)
            elif "workloads" not in m:
                assert moved not in c.end_to_end, (m["name"], cell)
