"""The port's ``utils/checkpoint.py`` and ``utils/profiling.py`` against
the JAX package's, on the CPU.

Checkpoints: the JAX and the port's files of the same nested parameters
hold the same ``leaf_i`` arrays (JAX's flatten order: dict keys sorted),
the same ``__step__`` and the same form of ``LATEST``; a port file loads
back to the same structure (a model's and an Adam state's ``state_dict``
too, bf16 included) and the same training continues; a JAX-written file
is refused with an error that says why.  Profiling: ``Timer`` counts and
sums, ``timed_loop`` gives a positive time per iteration and runs the
chain it describes, ``trace`` writes a Chrome trace."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_hack_tpu.utils import checkpoint as jck
from dgl_hack_tpu.utils import profiling as jprof

from dgl_hack_tpu_torch.utils import (Timer, load_checkpoint,
                                      save_checkpoint, timed_loop, trace)

torch.set_num_threads(2)


def _params(rng):
    """Nested parameters as the JAX package's models carry them (flax's
    dicts, with keys out of order, a list and a tuple), in the dtypes
    JAX keeps (float32, int32)."""
    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"params": {"layer1": {"kernel": f32(4, 3), "bias": f32(3)},
                       "layer0": {"kernel": f32(5, 4), "bias": f32(4)}},
            "stats": [f32(2), (np.arange(3, dtype=np.int32), f32(1, 1))]}


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(f, v) for v in tree)
    return f(tree)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_checkpoint_files_match_jax(tmp_path):
    params = _params(np.random.default_rng(0))
    fj = jck.save_checkpoint(str(tmp_path / "jax" / "ck"),
                             _map(jnp.asarray, params), step=7)
    ft = save_checkpoint(str(tmp_path / "torch" / "ck"),
                         _map(torch.from_numpy, params), step=7)
    assert os.path.basename(fj) == os.path.basename(ft) == "ck.step7.npz"
    with open(tmp_path / "jax" / "LATEST") as f:
        assert f.read() == fj
    with open(tmp_path / "torch" / "LATEST") as f:
        assert f.read() == ft
    with np.load(fj, allow_pickle=False) as zj, \
            np.load(ft, allow_pickle=False) as zt:
        leaves = sorted(k for k in zj.files if k.startswith("leaf_"))
        assert leaves == sorted(k for k in zt.files
                                if k.startswith("leaf_"))
        assert len(leaves) == 7
        for k in leaves + ["__step__"]:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zj[k], zt[k], k)
        assert "__treedef__" in zj.files and "__treedef__" not in zt.files
        structure = json.loads(bytes(zt["__structure__"]).decode())
    assert [k for k, _ in structure["dict"]] == ["params", "stats"]


def test_checkpoint_round_trip(tmp_path):
    params = _params(np.random.default_rng(1))
    state = {"model": _map(torch.from_numpy, params),
             "host": params["stats"],
             "opt": {"state": {1: {"step": torch.tensor(3.0)},
                               0: {"half": torch.arange(6.0).to(
                                   torch.bfloat16)}},
                     "param_groups": [{"lr": 0.01, "betas": (0.9, 0.999),
                                       "amsgrad": False, "foreach": None,
                                       "name": "adam", "params": [0, 1]}]}}
    save_checkpoint(str(tmp_path / "ck"), state, step=1)
    f2 = save_checkpoint(str(tmp_path / "ck"), state, step=2)
    out = load_checkpoint(str(tmp_path))
    assert out["step"] == 2
    _same(state, out["state"])
    assert load_checkpoint(f2)["step"] == 2
    assert load_checkpoint(str(tmp_path / "empty")) is None
    os.makedirs(tmp_path / "empty")
    assert load_checkpoint(str(tmp_path / "empty")) is None


def test_checkpoint_resumes_training(tmp_path):
    """Three Adam steps, a checkpoint of the model and optimizer, a fresh
    model and optimizer loaded from it and two more steps: the losses of
    five uninterrupted steps, bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 64))

    def fresh():
        torch.manual_seed(0)
        model = torch.nn.Linear(8, 3)
        return model, torch.optim.Adam(model.parameters(), lr=1e-2)

    def steps(model, opt, n):
        out = []
        for _ in range(n):
            loss = torch.nn.functional.cross_entropy(model(x), y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            out.append(float(loss.detach()))
        return out
    ref = steps(*fresh(), 5)
    model, opt = fresh()
    first = steps(model, opt, 3)
    save_checkpoint(str(tmp_path / "ck"),
                    {"model": model.state_dict(), "opt": opt.state_dict()},
                    step=3)
    ck = load_checkpoint(str(tmp_path))
    model, opt = fresh()
    model.load_state_dict(ck["state"]["model"])
    opt.load_state_dict(ck["state"]["opt"])
    assert first + steps(model, opt, 2) == ref


def test_jax_checkpoint_refused(tmp_path):
    params = _map(jnp.asarray, _params(np.random.default_rng(3)))
    f = jck.save_checkpoint(str(tmp_path / "ck"), params, step=4)
    with pytest.raises(ValueError, match="written by the JAX package"):
        load_checkpoint(f)
    with pytest.raises(ValueError, match="pickled JAX treedef"):
        load_checkpoint(str(tmp_path))


def test_timer():
    t, tj = Timer(), jprof.Timer()
    assert t.mean == tj.mean == 0.0
    for _ in range(3):
        with t.time(torch.ones(4)):
            torch.ones(100).sum()
    with t.time([{"a": torch.zeros(2)}, None]):
        pass
    assert t.count == 4 and t.total > 0 and t.mean == t.total / 4


def test_timed_loop_runs_the_chain():
    calls = []

    def fn(h):
        calls.append(float(h[0]))
        return h + 1.0
    per_iter = timed_loop(fn, torch.zeros(1000), k_lo=1, k_hi=3, repeats=2)
    assert np.isfinite(per_iter)
    # warm-up and two repeats at each length; h = (h + 1) * 0.9999
    assert len(calls) == 3 * 3 + 3 * 1
    np.testing.assert_allclose(calls[:3], [0.0, 0.9999, 1.99970001],
                               rtol=1e-6)
    big = torch.ones(400, 400)
    assert timed_loop(lambda h: h @ big / 400.0, torch.ones(400, 400),
                      k_lo=1, k_hi=4) > 0


def test_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "tr")
    with trace(d) as prof:
        torch.ones(50, 50) @ torch.ones(50, 50)
    assert prof.key_averages()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
