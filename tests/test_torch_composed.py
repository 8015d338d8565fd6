"""Composed (plain torch) GAT edge phase, edge_softmax and gsddmm of the
PyTorch port against the JAX package's composed ops on the bare graph
(exact f32; only the summation order differs): max abs error <= 1e-5 *
max|ref|, forward and grads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from test_torch_gat import BARE_TOL, _compare, _graphs, _inputs, _jax_run, \
    _port_run, assert_close

torch.set_num_threads(2)


@pytest.mark.parametrize("H,D", [(4, 8), (1, 7)])
def test_composed_vs_jax_bare(H, D):
    rng = np.random.default_rng(20 + H)
    gj, gt = _graphs(rng, isolated=20)
    ins = _inputs(rng, 200, gt.num_edges(), H, D)
    rj = _jax_run(gj, *ins)
    rt = _port_run(lambda f, a, b, w: dt.gat_attention(gt, f, a, b, 0.2, w),
                   *ins)
    _compare(rj, rt, BARE_TOL)



def test_edge_softmax_and_sddmm_eid_order():
    rng = np.random.default_rng(31)
    gj, gt = _graphs(rng, num_nodes=60, num_edges=300)
    logits = rng.normal(size=(300, 2)).astype(np.float32)
    for order in ("internal", "eid"):
        aj = dgl.edge_softmax(gj, jnp.asarray(logits), order=order)
        at = dt.edge_softmax(gt, torch.from_numpy(logits), order=order)
        assert_close(at.numpy(), aj, BARE_TOL, order)
    x = rng.normal(size=(60, 3)).astype(np.float32)
    y = rng.normal(size=(60, 3)).astype(np.float32)
    for op in ("add", "sub", "mul", "dot"):
        sj = dgl.gsddmm(gj, op, jnp.asarray(x), jnp.asarray(y), "u", "v",
                        out_order="eid")
        st = dt.gsddmm(gt, op, torch.from_numpy(x), torch.from_numpy(y),
                       "u", "v", out_order="eid")
        assert_close(st.numpy(), sj, BARE_TOL, op)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reducer", ["max", "min"])
def test_segment_reduce_int32_vs_jax(reducer, masked):
    """max/min over int32 data, masked or not: empty segments (segment 1,
    and under the mask segment 3, all of whose entries are masked) give
    the dtype's limit in both packages, bitwise."""
    from dgl_hack_tpu.ops.segment import segment_reduce as jax_reduce
    from dgl_hack_tpu_torch.ops.segment import segment_reduce
    rng = np.random.default_rng(40)
    data = rng.integers(-50, 50, size=(12, 2)).astype(np.int32)
    ids = np.array([0, 0, 2, 2, 2, 3, 3, 4, 4, 4, 0, 2], np.int32)
    mask = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0], bool) \
        if masked else None
    ref = jax_reduce(reducer, jnp.asarray(data), jnp.asarray(ids), 5,
                     mask=None if mask is None else jnp.asarray(mask))
    out = segment_reduce(reducer, torch.from_numpy(data),
                         torch.from_numpy(ids).long(), 5,
                         mask=None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    limit = np.iinfo(np.int32).min if reducer == "max" \
        else np.iinfo(np.int32).max
    assert (out[1] == limit).all()
    assert bool((out[3] == limit).all()) == masked


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reducer", ["sum", "mean", "max"])
def test_segment_reduce_indices_are_sorted(reducer, masked):
    """segment_reduce takes the JAX package's ``indices_are_sorted`` in its
    position, before ``mask`` (as RelGraphConv and multi_update_all call
    it), positionally and by keyword; the hint changes no result, and both
    packages agree to 1e-6 of max|ref|."""
    from dgl_hack_tpu.ops.segment import segment_reduce as jax_reduce
    from dgl_hack_tpu_torch.ops.segment import segment_reduce
    rng = np.random.default_rng(41)
    data = rng.normal(size=(12, 3)).astype(np.float32)
    ids = np.array([0, 0, 0, 2, 2, 3, 3, 3, 3, 4, 4, 4], np.int32)
    mask = (np.arange(12) % 3 != 1) if masked else None
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    ref = np.asarray(jax_reduce(reducer, jnp.asarray(data), jnp.asarray(ids),
                                5, True, mask=mj))
    np.testing.assert_array_equal(
        ref, np.asarray(jax_reduce(reducer, jnp.asarray(data),
                                   jnp.asarray(ids), 5,
                                   indices_are_sorted=True, mask=mj)))
    d, i = torch.from_numpy(data), torch.from_numpy(ids)
    outs = [segment_reduce(reducer, d, i, 5, True, mt),
            segment_reduce(reducer, d, i, 5, True, mask=mt),
            segment_reduce(reducer, d, i, 5, indices_are_sorted=True,
                           mask=mt)]
    unsorted = segment_reduce(reducer, d, i, 5, mask=mt)
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), unsorted.numpy())
        assert_close(out.numpy(), ref, 1e-6, reducer)
