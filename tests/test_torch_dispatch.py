"""The dispatch log (``DGL_TPU_DEBUG_DISPATCH``): the port against the JAX
package's.

With the variable set to "1", gspmm, gsddmm and gat_attention print the
route a call took, ``[dgl-tpu dispatch] {op}: {path} ({detail})``.  The
JAX package prints once per trace; the port once per distinct line per
process.  On the CPU the port reaches ``v-rewrite``, ``hybrid``, ``rows``,
``kernel`` (max/min through K4/K5's plain versions, gsddmm through K6's)
and ``plain``; each case below is built for one of them.  Unset, nothing
is printed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.utils import env

torch.set_num_threads(2)

PREFIX = "[dgl-tpu dispatch] "


@pytest.fixture
def fresh_log(monkeypatch):
    """The log switched on, with no line printed yet in this process."""
    monkeypatch.setenv("DGL_TPU_DEBUG_DISPATCH", "1")
    monkeypatch.setattr(env, "_PRINTED", set())


def _lines(out):
    return [ln for ln in out.splitlines() if ln.startswith(PREFIX)]


def _graph(rng, n=200, e=1500):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return src, dst, dt.graph((src, dst), num_nodes=n)


def test_dispatch_debug_line(capsys, fresh_log,
                             rng=np.random.default_rng(50)):
    """The twin of tests/test_pallas_spmm.py's test_dispatch_debug_line:
    a bare graph's copy_u sum prints its route in both packages; the
    port's CPU route is ``plain``."""
    n, e = 200, 1500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    dgl.gspmm(dgl.graph((src, dst), num_nodes=n), "copy_lhs", "sum",
              jnp.asarray(x))
    jax_out = capsys.readouterr().out
    assert "[dgl-tpu dispatch] gspmm: composed" in jax_out
    g = dt.graph((src, dst), num_nodes=n)
    dt.gspmm(g, "copy_lhs", "sum", torch.from_numpy(x))
    out = capsys.readouterr().out
    assert _lines(out) == ["[dgl-tpu dispatch] gspmm: plain (copy_lhs.sum)"]
    assert "[dgl-tpu dispatch] gspmm:" in out


def test_one_line_per_decision(capsys, fresh_log, rng):
    """Repeated calls print a decision once; a new decision prints its
    own line."""
    _, _, g = _graph(rng)
    x = torch.from_numpy(rng.normal(size=(200, 4)).astype(np.float32))
    for _ in range(3):
        dt.gspmm(g, "copy_lhs", "sum", x)
        dt.gspmm(g, "copy_lhs", "max", x)
    lines = _lines(capsys.readouterr().out)
    assert lines == [
        "[dgl-tpu dispatch] gspmm: plain (copy_lhs.sum)",
        "[dgl-tpu dispatch] gspmm: kernel (copy_lhs.max, K4/K5, cpu, "
        "plain version)"]
    dt.gspmm(g, "copy_lhs", "mean", x)
    dt.gspmm(g, "copy_lhs", "sum", x)
    assert _lines(capsys.readouterr().out) == [
        "[dgl-tpu dispatch] gspmm: plain (copy_lhs.mean)"]


def test_nothing_printed_when_unset(capsys, monkeypatch, rng):
    monkeypatch.delenv("DGL_TPU_DEBUG_DISPATCH", raising=False)
    monkeypatch.setattr(env, "_PRINTED", set())
    _, _, g = _graph(rng)
    x = torch.from_numpy(rng.normal(size=(200, 4)).astype(np.float32))
    dt.gspmm(g, "copy_lhs", "sum", x)
    dt.gspmm(g, "copy_lhs", "max", x)
    dt.gsddmm(g, "add", x, x)
    el = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
    dt.gat_attention(g, x.reshape(200, 2, 2), el, el)
    monkeypatch.setenv("DGL_TPU_DEBUG_DISPATCH", "0")
    dt.gspmm(g, "copy_lhs", "sum", x)
    assert capsys.readouterr().out == ""
    assert env._PRINTED == set()
    assert not env.get_config().debug_dispatch


def _hub_graph(rng, n=500, e=4000):
    """A few dst nodes take most edges (tests/test_torch_hybrid.py)."""
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.8, rng.integers(0, 40, e),
                   rng.integers(0, n, e))
    return dt.graph((src, dst), num_nodes=n)


def _case(name, rng):
    """(calls, the line each call must print) of one CPU route."""
    _, _, g = _graph(rng)
    x = torch.from_numpy(rng.normal(size=(200, 4)).astype(np.float32))
    if name == "v-rewrite":
        return (lambda: dt.gspmm(g, "add", "sum", x, x, "u", "v"),
                "gspmm: v-rewrite (add.sum)")
    if name == "hybrid":
        gp = dt.prepare_spmm(_hub_graph(rng), dense_threshold=200)
        assert "hybrid" in gp.derived
        xh = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
        return (lambda: dt.gspmm(gp, "copy_lhs", "sum", xh),
                "gspmm: hybrid (copy_lhs.sum, cpu, plain version)")
    if name == "rows":
        ed = torch.from_numpy(rng.normal(size=(g.num_edges(), 3)).astype(
            np.float32))
        return (lambda: dt.gspmm(g, "copy_rhs", "sum", None, ed, "u", "e"),
                "gspmm: rows (copy_rhs.sum, K1 over segments, cpu, "
                "plain version)")
    if name == "kernel-max":
        return (lambda: dt.gspmm(g, "copy_lhs", "min", x),
                "gspmm: kernel (copy_lhs.min, K4/K5, cpu, plain version)")
    if name == "kernel-max-masked":
        src, dst = rng.integers(0, 64, 300), np.sort(rng.integers(0, 32, 300))
        gm = dt.block((src, dst), 64, 32, edge_mask=rng.random(300) < 0.7)
        xm = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
        return (lambda: dt.gspmm(gm, "copy_lhs", "max", xm),
                "gspmm: kernel (copy_lhs.max, K4/K5, real-edge-view, cpu, "
                "plain version)")
    if name == "plain":
        w = torch.from_numpy(rng.normal(size=(g.num_edges(), 1)).astype(
            np.float32))
        return (lambda: dt.gspmm(g, "mul", "sum", x, w, "u", "e"),
                "gspmm: plain (mul.sum)")
    if name == "gsddmm-kernel":
        return (lambda: dt.gsddmm(g, "dot", x, x),
                "gsddmm: kernel (dot u-op-v, K6, cpu, plain version)")
    if name == "gsddmm-composed":
        return (lambda: dt.gsddmm(g, "add", x, x, "v", "v"),
                "gsddmm: composed (add v-op-v, cpu)")
    if name == "gat-plain":
        el = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
        return (lambda: dt.gat_attention(g, x.reshape(200, 2, 2), el, el),
                "gat: plain (H=2 D=2 softmax=shift packed=False)")
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "v-rewrite", "hybrid", "rows", "kernel-max", "kernel-max-masked",
    "plain", "gsddmm-kernel", "gsddmm-composed", "gat-plain"])
def test_route_names_on_cpu(capsys, fresh_log, rng, name):
    call, line = _case(name, rng)
    capsys.readouterr()
    call()
    first = _lines(capsys.readouterr().out)
    assert PREFIX + line in first, first
    call()
    assert _lines(capsys.readouterr().out) == []
