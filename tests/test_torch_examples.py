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


CLI_CASES = [
    ("train_gcn_torch.py", ["--epochs", "3"]),
    ("train_gat_torch.py", ["--epochs", "3", "--dataset", "synth"]),
    ("train_transformer_torch.py", ["--epochs", "3", "--batch", "4",
                                    "--seq-len", "6"]),
    ("train_gin_torch.py", ["--epochs", "1"]),
    ("train_sgc_torch.py", ["--epochs", "3"]),
    ("train_appnp_torch.py", ["--epochs", "3"]),
    ("train_tagcn_torch.py", ["--epochs", "3"]),
    ("train_rgcn_torch.py", ["--epochs", "3"]),
    ("train_rgcn_hetero_torch.py", ["--epochs", "3"]),
]
# the dataset name each CLI prints (the JAX twin's)
DATASETS = {"train_gin_torch.py": "SBM-mixture",
            "train_tagcn_torch.py": "synthetic",
            "train_rgcn_torch.py": "aifb",
            "train_rgcn_hetero_torch.py": "academic-synth"}
SCRIPTS = [script for script, _ in CLI_CASES]


def _start_example(script, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script),
                             *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def runs():
    """Every CLI run of this file, started together so that their start-up
    overlaps; ``runs(key)`` waits for one and gives (returncode, stdout,
    stderr)."""
    procs = {("cpu", script): _start_example(script, [*args, "--device",
                                                      "cpu"])
             for script, args in CLI_CASES}
    procs.update({("refuse", script): _start_example(script, ["--epochs",
                                                              "1"])
                  for script in SCRIPTS})
    done = {}

    def result(key):
        if key not in done:
            out, err = procs[key].communicate(timeout=120)
            done[key] = (procs[key].returncode, out, err)
        return done[key]
    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("script,args", CLI_CASES)
def test_example_cli(runs, script, args):
    rc, stdout, stderr = runs(("cpu", script))
    assert rc == 0, stderr
    out = json.loads(stdout.strip().splitlines()[-1])
    if script == "train_transformer_torch.py":
        assert (out["dataset"], out["model"]) == ("copy", "graph-transformer")
        assert 0.0 <= out["token_acc"] <= 1.0 and out["train_time_s"] >= 0
        return
    assert out["dataset"] == DATASETS.get(script, "cora-synth")
    assert 0.0 <= out["test_acc"] <= 1.0 and out["train_time_s"] > 0


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_cli_refuses_without_card(runs, script):
    """--device defaults to cuda; with no card the CLI exits with an error
    naming --device cpu instead of running on the CPU."""
    rc, stdout, stderr = runs(("refuse", script))
    assert rc != 0
    assert "--device cpu" in stderr
    assert not stdout.strip()


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
