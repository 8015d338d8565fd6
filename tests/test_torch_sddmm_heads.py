"""gSDDMM parity between the PyTorch port and the JAX package, continued
from test_torch_sddmm.py (same graphs, inputs and tolerances): the
dst-side swap (v op u), multi-head dot on (N, H, D) operands with a node
or an edge lhs, a block, and ``out_order='eid'``.
"""
import numpy as np
import pytest
import torch

from test_torch_sddmm import (DOT_TOL, ELEM_TOL, N, _graphs,  # noqa: F401
                              _jax_sddmm_kernel, _operand, _run_both)

torch.set_num_threads(2)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "dot", "copy_lhs"])
def test_v_side_swap(op):
    """v op u normalises onto K6 (sub through its sign flip; copy_lhs of
    'v' as copy_rhs)."""
    rng = np.random.default_rng(3)
    gp, gt = _graphs(rng)
    y = _operand(rng, gt, "v", (5,))
    x = None if op == "copy_lhs" else _operand(rng, gt, "u", (5,))
    _run_both(gp, gt, op, y, x, "v", "u",
              DOT_TOL if op == "dot" else ELEM_TOL)


@pytest.mark.parametrize("H,D,lt", [(1, 7, "u"), (1, 16, "e"),
                                    (4, 7, "e"), (4, 16, "u")])
def test_multihead_dot(H, D, lt):
    """(N, H, D) u_dot_v / e_dot_v contract each head: (E, H, 1)."""
    rng = np.random.default_rng(H * 100 + D)
    gp, gt = _graphs(rng)
    out = _run_both(gp, gt, "dot", _operand(rng, gt, lt, (H, D)),
                    _operand(rng, gt, "v", (H, D)), lt, "v", DOT_TOL)
    assert out.shape == (gt.num_edges(), H, 1)


def test_block_multihead_dot():
    """A block (num_src != num_dst): lhs has num_src rows, rhs num_dst."""
    rng = np.random.default_rng(4)
    gp, gt = _graphs(rng, block=True)
    assert gt.num_src_nodes == N + 7 and gt.num_dst_nodes == N
    _run_both(gp, gt, "dot", _operand(rng, gt, "u", (2, 4)),
              _operand(rng, gt, "v", (2, 4)), "u", "v", DOT_TOL)


def test_eid_order():
    rng = np.random.default_rng(5)
    gp, gt = _graphs(rng)
    assert gt.int2user is not None
    _run_both(gp, gt, "sub", _operand(rng, gt, "u", (3,)),
              _operand(rng, gt, "v", (3,)), "u", "v", ELEM_TOL,
              out_order="eid")
