"""Segment ids outside ``[0, n)``: the port's plain segment reductions drop
them, as ``jax.ops.segment_*`` (and so the JAX package's ``ops/segment``)
do, for every reducer, ``bincount`` and the gradients.  Exact in float32
(each kept segment sums the same one or two values); bf16 to one bf16
ulp of the result."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_hack_tpu.ops import segment as jseg
from dgl_hack_tpu_torch.ops import segment as tseg

torch.set_num_threads(2)

REDUCERS = ("sum", "mean", "max", "min", "prod")


def _jax(reducer, data, ids, n):
    return np.asarray(jseg.segment_reduce(reducer, jnp.asarray(data),
                                          jnp.asarray(ids), n),
                      dtype=np.float32)


def _port(reducer, data, ids, n, dtype=torch.float32):
    out = tseg.segment_reduce(reducer, torch.from_numpy(data).to(dtype),
                              torch.from_numpy(ids), n)
    return out.float().numpy()


def test_reanchor_probe():
    """ids [0, 2, 3, -1] into 3 segments, data [1, 2, 3, 4]: the JAX
    package gives sum [1, 0, 2], max [1, 0, 2], prod [1, 1, 2] and
    bincount [1, 0, 1]; the port gives the same."""
    data = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ids = np.array([0, 2, 3, -1], np.int32)
    want = {"sum": [1, 0, 2], "max": [1, 0, 2], "prod": [1, 1, 2]}
    for reducer, w in want.items():
        np.testing.assert_array_equal(_jax(reducer, data, ids, 3), w)
        np.testing.assert_array_equal(_port(reducer, data, ids, 3), w)
    jb = np.asarray(jseg.bincount(jnp.asarray(ids), None, 3))
    tb = tseg.bincount(torch.from_numpy(ids), None, 3).numpy()
    np.testing.assert_array_equal(jb, [1, 0, 1])
    np.testing.assert_array_equal(tb, jb)


def _case(F):
    rng = np.random.default_rng(F)
    n = 5
    ids = rng.integers(0, n, 24).astype(np.int32)
    ids[[1, 7, 12]] = -1
    ids[[3, 9, 20]] = n
    ids[15] = n + 4
    ids[ids == 2] = -1                       # segment 2 empty of real ids
    shape = (24,) if F is None else (24, F)
    data = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return data, ids, n


@pytest.mark.parametrize("F", [None, 3])
@pytest.mark.parametrize("reducer", REDUCERS)
def test_out_of_range_ids_dropped_f32(reducer, F):
    data, ids, n = _case(F)
    np.testing.assert_array_equal(_port(reducer, data, ids, n),
                                  _jax(reducer, data, ids, n))


@pytest.mark.parametrize("reducer", REDUCERS)
def test_out_of_range_ids_dropped_bf16(reducer):
    """bf16 data: each kept segment within one bf16 ulp of the JAX
    package's bf16 result."""
    data, ids, n = _case(3)
    data = np.array(jnp.asarray(data, jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jseg.segment_reduce(
        reducer, jnp.asarray(data, jnp.bfloat16), jnp.asarray(ids), n)
        .astype(jnp.float32))
    out = _port(reducer, data, ids, n, torch.bfloat16)
    ulp = np.abs(ref) * 2.0 ** -7
    assert np.all(np.abs(out - ref) <= ulp + 1e-30), (out, ref)


@pytest.mark.parametrize("reducer", ["sum", "mean", "max"])
def test_dropped_ids_get_no_gradient(reducer):
    """A dropped entry's gradient is 0, as under JAX's autodiff."""
    import jax
    data, ids, n = _case(3)
    w = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    gj = np.asarray(jax.grad(lambda d: (jseg.segment_reduce(
        reducer, d, jnp.asarray(ids), n) * w).sum())(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_(True)
    (tseg.segment_reduce(reducer, x, torch.from_numpy(ids), n)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), gj, rtol=1e-6, atol=1e-7)
    assert not x.grad.numpy()[(ids < 0) | (ids >= n)].any()


def test_bincount_weights_out_of_range():
    ids = np.array([0, 4, 1, -2, 4, 7, 0], np.int32)
    w = np.arange(1, 8, dtype=np.float32)
    jb = np.asarray(jseg.bincount(jnp.asarray(ids), jnp.asarray(w), 5))
    tb = tseg.bincount(torch.from_numpy(ids), torch.from_numpy(w), 5)
    np.testing.assert_array_equal(tb.numpy(), jb)


def test_integer_max_min_keep_limits():
    """Integer data: an empty segment still gives the dtype's limits, a
    dropped id changes nothing."""
    ids = np.array([0, 0, 3, -1], np.int32)
    data = np.array([4, 9, 5, 100], np.int32)
    for reducer in ("max", "min"):
        ref = np.asarray(jseg.segment_reduce(reducer, jnp.asarray(data),
                                             jnp.asarray(ids), 3))
        out = tseg.segment_reduce(reducer, torch.from_numpy(data),
                                  torch.from_numpy(ids), 3)
        np.testing.assert_array_equal(out.numpy(), ref)
