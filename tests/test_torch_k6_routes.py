"""K6's routes: the route rule, and gsddmm's CPU path against the JAX
package at the widths the rule splits on.

On the card K6 (``csrc/sddmm.cu``) loads up to 16 bytes a lane for the
elementwise ops in lane groups of ``k6_lanes`` (a row's F columns at
``ELEM_LANE_VECTORS`` loads a lane); the dot takes ``dot4`` (heads of at
most 32 at 4 values a load) or the same vector route (a head's D at
``DOT_LANE_VECTORS`` loads a lane).  Here, on the CPU:

* ``k6_lanes`` and ``k6_route`` as pure functions of the widths, the load
  width, the op and the edges, and ``gsddmm_route`` (what the dispatch log
  prints) from the operands as they reach K6 (meta tensors: bench.py's
  lhs without its 512 MB), mixed float32/bf16 and non-contiguous operands
  included;
* the port's ``gsddmm`` against the JAX package's at F in {3, 64, 130}
  for sub, add, mul, div and copy_rhs with a 'u' and an 'e' lhs, and the
  dot at H x D in {1 x 64, 2 x 64, 1 x 130, 3 x 33}: forward against the
  JAX function's plain reference (the bare graph, which composes), within
  ELEM_TOL (1e-6 of max|ref|) and DOT_TOL (1e-5); forward and both
  gradients of one case a width against the JAX sddmm kernel (Pallas in
  interpret mode, as ``tests/test_torch_sddmm.py`` runs it).  On the CPU
  the port's side is K6's plain version (``sddmm_plain``): these cases
  hold the plain version to JAX at the widths where the card's routes
  differ, and ``chip_smoke.py`` holds each route to the plain version.

Inputs are made from a seed with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import sddmm_kernel as k6
from test_torch_sddmm import (DOT_TOL, ELEM_TOL, _graphs,  # noqa: F401
                              _jax_sddmm_kernel, _operand, _run_both,
                              assert_close)

torch.set_num_threads(2)

BENCH_ROWS = 1_000_000


# -- the rule ---------------------------------------------------------------

E_BENCH = 16_000_000


@pytest.mark.parametrize("op,F,D,vec,lanes", [
    ("sub", 64, 0, 4, 16), ("sub", 128, 0, 4, 32),
    ("add", 602, 0, 2, 32), ("mul", 130, 0, 2, 32),
    ("copy_rhs", 128, 0, 8, 16), ("div", 32, 0, 8, 4),
    ("sub", 41, 0, 1, 32), ("add", 16, 0, 4, 4), ("mul", 24, 0, 4, 8),
    ("sub", 16, 0, 8, 2), ("sub", 8, 0, 8, 1),
    ("add", 14, 0, 2, 8), ("sub", 12, 0, 4, 4), ("mul", 2, 0, 2, 1),
    ("sub", 3, 0, 1, 4), ("sub", 7, 0, 1, 8), ("div", 24, 0, 1, 32),
    ("copy_rhs", 1, 0, 1, 1),
    ("dot", 128, 128, 4, 16), ("dot", 128, 64, 4, 8),
    ("dot", 128, 128, 8, 8), ("dot", 128, 64, 8, 4),
    ("dot", 602, 602, 2, 32), ("dot", 99, 33, 1, 32),
    ("dot", 64, 16, 4, 0), ("dot", 32, 32, 4, 0), ("dot", 64, 16, 8, 0),
    ("dot", 14, 7, 1, 4), ("dot", 3, 3, 1, 2), ("dot", 30, 30, 2, 8),
    ("dot", 16, 16, 1, 8), ("dot", 36, 36, 4, 8),
])
def test_lanes(op, F, D, vec, lanes):
    """The vector routes take ELEM_LANE_VECTORS loads a lane over a row, a
    dot's head DOT_LANE_VECTORS loads a lane (at most 32 lanes either
    way); 0 lanes is dot4 (heads of at most 32 at 4 values a load)."""
    assert k6.k6_lanes(op, F, D, vec, 1000) == lanes
    if lanes:
        width = D if op == "dot" else F
        per = k6.DOT_LANE_VECTORS if op == "dot" else k6.ELEM_LANE_VECTORS
        assert lanes == 32 or \
            lanes * per * vec >= width > lanes // 2 * per * vec


def test_dot4_items_limit():
    """dot4 indexes its (edge, head) items in 32 bits: past 2^32 - 1 items
    the dot takes the vector route."""
    assert k6.k6_lanes("dot", 64, 16, 4, 2**30 - 1) == 0
    assert k6.k6_lanes("dot", 64, 16, 4, 2**30) == \
        k6.edge_lanes(16, k6.DOT_LANE_VECTORS * 4)


@pytest.mark.parametrize("op,vec,lanes,name", [
    ("add", 4, 4, "vector, 4 a load, 4 lanes"),
    ("mul", 2, 32, "vector, 2 a load, 32 lanes"),
    ("copy_rhs", 8, 16, "vector, 8 a load, 16 lanes"),
    ("dot", 4, 0, "dot4"),
    ("dot", 8, 0, "dot4"),
    ("dot", 1, 4, "dot vector, 1 a load, 4 lanes"),
    ("dot", 4, 8, "dot vector, 4 a load, 8 lanes"),
    ("dot", 2, 32, "dot vector, 2 a load, 32 lanes"),
])
def test_route_names(op, vec, lanes, name):
    assert k6.k6_route(op, vec, lanes) == name


@pytest.mark.parametrize("op,dtype,feat,name", [
    ("sub", torch.float32, (128,), "vector, 4 a load, 32 lanes"),
    ("sub", torch.bfloat16, (128,), "vector, 8 a load, 16 lanes"),
    ("add", torch.float32, (50,), "vector, 2 a load, 32 lanes"),
    ("sub", torch.float32, (3,), "vector, 1 a load, 4 lanes"),
    ("sub", torch.float32, (16,), "vector, 4 a load, 4 lanes"),
    ("sub", torch.bfloat16, (8,), "vector, 8 a load, 1 lanes"),
    ("sub", torch.bfloat16, (12,), "vector, 4 a load, 4 lanes"),
    ("sub", torch.float32, (14,), "vector, 2 a load, 8 lanes"),
    ("dot", torch.float32, (128,), "dot vector, 4 a load, 16 lanes"),
    ("dot", torch.bfloat16, (128,), "dot vector, 8 a load, 8 lanes"),
    ("dot", torch.float32, (2, 64), "dot vector, 4 a load, 8 lanes"),
    ("dot", torch.float32, (8, 16), "dot4"),
    ("dot", torch.float32, (2, 7), "dot vector, 1 a load, 4 lanes"),
    ("copy_rhs", torch.bfloat16, (128,), "vector, 8 a load, 16 lanes"),
])
def test_gsddmm_route(op, dtype, feat, name):
    """The route the dispatch log prints, from the operands' shapes (meta
    tensors at bench.py's 1M rows and 16M edges)."""
    lhs = None if op == "copy_rhs" else torch.empty(
        (BENCH_ROWS,) + feat, dtype=dtype, device="meta")
    rhs = torch.empty((BENCH_ROWS,) + feat, dtype=dtype, device="meta")
    assert k6.gsddmm_route(op, lhs, rhs, E_BENCH) == name


def test_gsddmm_route_mixed_and_misaligned():
    """The route of the operands that reach K6: a float32/bf16 mix runs
    the float32 kernel on a fresh float32 copy of the bf16 operand (16-byte
    loads, unless the float32 one is off its alignment); an lhs one value
    off its alignment takes single-value loads; a non-contiguous operand
    reaches K6 as a fresh contiguous copy."""
    lhs = torch.empty((1000, 128), dtype=torch.bfloat16, device="meta")
    rhs = torch.empty((1000, 128), device="meta")
    assert k6.gsddmm_route("add", lhs, rhs, 5000) == \
        "vector, 4 a load, 32 lanes"
    flat = torch.zeros(1000 * 64 + 1)
    skewed, rhs = flat[1:].view(1000, 64), torch.zeros(1000, 64)
    assert k6.gsddmm_route("sub", skewed, rhs, 5000) == \
        "vector, 1 a load, 32 lanes"
    assert k6.gsddmm_route("dot", skewed, rhs, 5000) == \
        "dot vector, 1 a load, 32 lanes"
    assert k6.gsddmm_route("mul", rhs.bfloat16(), skewed, 5000) == \
        "vector, 1 a load, 32 lanes"
    strided = torch.zeros(64, 1001)[:, 1:].t()
    assert not strided.is_contiguous()
    assert k6.gsddmm_route("sub", strided, rhs, 5000) == \
        "vector, 4 a load, 16 lanes"
    small = torch.zeros(1000 * 16 + 1)[1:].view(1000, 16)
    assert k6.gsddmm_route("sub", small, torch.zeros(1000, 16), 5000) == \
        "vector, 1 a load, 16 lanes"


# -- gsddmm against the JAX package ----------------------------------------

ELEM_OPS = ("sub", "add", "mul", "div", "copy_rhs")


def _forward_both(op, feat, lt, seed):
    """The port's gsddmm and the JAX package's on the bare graph (its
    plain reference, which composes) on the same inputs."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 40, 300)
    dst = rng.integers(0, 35, 300)            # 5 dst rows without edges
    gj = dgl.graph((src, dst), num_nodes=40)
    gt = dt.graph((src, dst), num_nodes=40)
    x = None if op == "copy_rhs" else _operand(rng, gt, lt, feat)
    y = _operand(rng, gt, "v", feat)
    out_j = dgl.gsddmm(gj, op, None if x is None else jnp.asarray(x),
                       jnp.asarray(y), lt, "v")
    out_t = dt.gsddmm(gt, op, None if x is None else torch.from_numpy(x),
                      torch.from_numpy(y), lt, "v")
    return out_t, np.asarray(out_j)


@pytest.mark.parametrize("F", [3, 64, 130])
@pytest.mark.parametrize("op,lt", [(op, lt) for op in ELEM_OPS
                                   for lt in ("u", "e")
                                   if op != "copy_rhs" or lt == "u"])
def test_elementwise_against_jax(op, lt, F):
    out_t, out_j = _forward_both(op, (F,), lt, F * 10 + len(op))
    assert out_t.shape == (out_j.shape[0], F)
    assert_close(out_t.numpy(), out_j, ELEM_TOL, f"{op} {lt} F={F}")


@pytest.mark.parametrize("H,D,lt", [(1, 64, "u"), (2, 64, "e"),
                                    (1, 130, "u"), (3, 33, "e")])
def test_wide_dot_against_jax(H, D, lt):
    out_t, out_j = _forward_both("dot", (H, D), lt, H * D)
    assert out_t.shape == (out_j.shape[0], H, 1)
    assert_close(out_t.numpy(), out_j, DOT_TOL, f"dot H={H} D={D} {lt}")


@pytest.mark.parametrize("op,feat,lt", [("sub", (64,), "u"),
                                        ("div", (130,), "e"),
                                        ("dot", (2, 64), "u")])
def test_gradients_against_jax_kernel(op, feat, lt):
    """Forward and both gradients against the JAX sddmm kernel (Pallas in
    interpret mode, test_torch_sddmm.py's ``_run_both``)."""
    rng = np.random.default_rng(len(op) + feat[-1])
    gp, gt = _graphs(rng)
    x = _operand(rng, gt, lt, feat)
    y = _operand(rng, gt, "v", feat)
    _run_both(gp, gt, op, x, y, lt, "v", DOT_TOL if op == "dot" else ELEM_TOL)
