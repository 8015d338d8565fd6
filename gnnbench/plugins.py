"""Find the benchmark's parts by name.

``BENCHMARK.json`` names the cells, configurations, traffic mixes and
metrics; each part lives in a file of its own under this folder, found by
that name:

* ``configs/<config>.json`` the configuration as it is run, and
  ``configs/<config>.py`` its plain reference (plain PyTorch);
* ``models/<config>.py`` builds the configuration in the port;
* ``traffic/<mix>.json`` a traffic mix: the graph generator that
  ``graphs/<generator>.py`` holds and its parameters;
* ``metrics/<metric>.py`` the reader of one per-layer metric;
* ``counts/<config>.py`` the operations and bytes of one training step;
* ``limits/<cell>.json`` the limits of the numbers that decide ``correct``.

Python parts are loaded from their paths, so a name may hold ``-`` and
``.``.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """The module ``<kind>/<name>.py``, imported once per process under a
    name of its own (``gnnbench_<kind>_<name>`` with ``-`` and ``.`` as
    ``_``)."""
    mod_name = "gnnbench_" + re.sub(r"[^0-9A-Za-z_]", "_", f"{kind}_{name}")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def applies(metric: dict, cell: str, end_to_end: List[dict] = None) -> bool:
    """Whether a metric entry of the manifest is reported in ``cell``: the
    cells its ``workloads`` lists, or without that key every cell, and
    for a per-layer metric (given the cell's ``end_to_end`` entries)
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or any(m["name"] == metric["moves"]
                                     for m in end_to_end)


@dataclass
class Cell:
    """One entry of the manifest's ``workloads`` with what it names."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    limits: Dict[str, float] = field(default_factory=dict)


def cell(name: str, man: dict = None) -> Cell:
    """The cell ``name`` of the manifest, with its configuration, traffic
    mix, metrics and limits loaded."""
    man = manifest() if man is None else man
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    e2e = [m for m in man["end_to_end"] if applies(m, name)]
    return Cell(name=name, config_name=entry["config"],
                traffic_name=entry["traffic"], chips=int(entry["chips"]),
                config=load_json("configs", entry["config"]),
                traffic=load_json("traffic", entry["traffic"]),
                end_to_end=e2e,
                per_layer=[m for m in man["per_layer"]
                           if applies(m, name, e2e)],
                limits=load_json("limits", name))
