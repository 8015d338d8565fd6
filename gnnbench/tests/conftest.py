"""Tests of the benchmark's own files, on the CPU at tiny sizes.  A test
that needs the card is marked ``card`` and decides inside the test
whether one is there.

    python -m pytest gnnbench/tests -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gnnbench import plugins  # noqa: E402

# a tiny graph of each traffic mix, the widths of the configurations kept
TINY = {"reddit": dict(num_nodes=300, feat_dim=24, train_per_class=3),
        "powerlaw": dict(num_nodes=2000, feat_dim=16)}
CELLS = tuple(w["name"] for w in plugins.manifest()["workloads"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips inside the test "
        "without one")


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(name):
    """The cell ``name`` of the manifest on a tiny graph of its mix."""
    cell = plugins.cell(name)
    cell.traffic.update(TINY[cell.traffic_name])
    return cell
