"""The port's example CLIs run end to end on the CPU when asked
(``--device cpu``) and print their one JSON line; without a card and
without ``--device cpu`` they refuse to run; their stand-in datasets are
the JAX package's."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgl_hack_tpu.data import CoraGraphDataset

from dgl_hack_tpu_torch.data import synthetic_citation

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run_example(script, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("script,args", [
    ("train_gcn_torch.py", ["--epochs", "3"]),
    ("train_gat_torch.py", ["--epochs", "3", "--dataset", "synth"]),
])
def test_example_cli(script, args):
    res = _run_example(script, [*args, "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["dataset"] == "cora-synth"
    assert 0.0 <= out["test_acc"] <= 1.0 and out["train_time_s"] > 0


@pytest.mark.parametrize("script", ["train_gcn_torch.py",
                                    "train_gat_torch.py"])
def test_example_cli_refuses_without_card(script):
    """--device defaults to cuda; with no card the CLI exits with an error
    naming --device cpu instead of running on the CPU."""
    res = _run_example(script, ["--epochs", "1"])
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert not res.stdout.strip()


def test_citation_standin_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("DGL_TPU_DOWNLOAD_DIR", str(tmp_path))
    with pytest.warns(UserWarning):
        dj = CoraGraphDataset()
    dtt = synthetic_citation("cora")
    assert dj.name == dtt.name
    for name in ("features", "labels", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(dj, name), getattr(dtt, name))
    np.testing.assert_array_equal(np.asarray(dj.graph.src),
                                  dtt.graph.src.numpy())
