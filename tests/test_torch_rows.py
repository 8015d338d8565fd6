"""K1's sorted-rows route (``SegmentSumRows``) on the CPU, where it runs
K1's plain version.

* Forward against ``torch.segment_reduce(..., "sum", lengths=...)`` in
  float64: within 1e-12 of max|ref| (both sum the same float64 rows);
  float32 within 1e-6 of max|ref|.
* Backward: the cotangent gathered back to every row (exact).
* gspmm copy_e sum/mean (and update_all with an edge UDF) against the
  JAX package's on bare graphs: within 1e-5 of max|ref|, gradients too;
  an unmasked graph goes through the rows route, a masked one composes on
  the CPU as the JAX package does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk

torch.set_num_threads(2)

TOL = 1e-5


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# (segment lengths): empty segments at both ends and inside, one segment
# longer than K1_PIECE (the row plan cuts it), a run of single rows
LENGTHS = [
    [0, 3, 0, 5, 1, 1, 0],
    [sk.K1_PIECE * 3 + 7, 2, 0, sk.K1_PIECE + 1],
    [24] * 40,
    [700],
]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("lengths", LENGTHS)
def test_rows_against_segment_reduce(lengths, dtype, tol):
    rng = np.random.default_rng(len(lengths))
    seg = sk.segments(lengths, "cpu")
    x = torch.from_numpy(rng.normal(size=(sum(lengths), 5))).to(dtype)
    out = sk.segment_sum_rows(x, seg)
    ref = torch.segment_reduce(x, "sum",
                               lengths=torch.tensor(lengths), axis=0)
    assert_close(out.numpy(), ref.numpy(), tol)
    mean = sk.segment_mean_rows(x, seg)
    cnt = torch.tensor(lengths, dtype=dtype).clamp(min=1)[:, None]
    assert_close(mean.numpy(), (ref / cnt).numpy(), tol)


@pytest.mark.parametrize("lengths", LENGTHS)
def test_rows_backward_gathers(lengths):
    rng = np.random.default_rng(1)
    seg = sk.segments(lengths, "cpu")
    x = torch.from_numpy(rng.normal(size=(sum(lengths), 2, 3))
                         .astype(np.float32)).requires_grad_()
    out = sk.segment_sum_rows(x, seg)
    assert out.shape == (len(lengths), 2, 3)
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    (out * cot).sum().backward()
    ids = np.repeat(np.arange(len(lengths)), lengths)
    np.testing.assert_array_equal(x.grad.numpy(), cot.numpy()[ids])


def test_segments_cached_and_plan_cuts_long_rows():
    src = np.arange(600) % 7
    dst = np.zeros(600, np.int64)
    g = dt.graph((src, dst), num_nodes=7)
    seg = sk.graph_segments(g, "nodes")
    assert seg is sk.graph_segments(g, "nodes")
    assert seg.indptr.tolist() == [0, 7]
    e = sk.graph_segments(g, "edges")
    assert e.indptr.tolist() == [0, 600]
    assert e.plan.long_rows.tolist() == [0]
    assert e.plan.pieces.shape[0] == -(-600 // sk.K1_PIECE)
    csc = sk.graph_segments(g, "csc")
    assert csc.indptr is g.csc_indptr and csc.ids is g.dst
    moved = g.to("cpu")
    assert moved.derived["rows_nodes"].indptr.tolist() == [0, 7]


def _graphs(masked):
    rng = np.random.default_rng(5)
    n, e = 60, 500
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 4, e)
    dst[:300] = 3                          # a hub over K1_PIECE in-edges
    mask = rng.random(e) > 0.2 if masked else None
    return (dgl.graph((src, dst), num_nodes=n, edge_mask=mask),
            dt.graph((src, dst), num_nodes=n, edge_mask=mask))


@pytest.fixture
def rows_calls(monkeypatch):
    """The number of SegmentSumRows applications, counted from here on."""
    calls = []
    apply = sk.SegmentSumRows.apply

    def counted(*args):
        calls.append(1)
        return apply(*args)
    monkeypatch.setattr(sk.SegmentSumRows, "apply", counted)
    return calls


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reducer", ["sum", "mean"])
@pytest.mark.parametrize("op", ["copy_lhs", "copy_rhs"])
def test_gspmm_copy_e_matches_jax(op, reducer, masked, rows_calls):
    jg, tg = _graphs(masked)
    rng = np.random.default_rng(2)
    e = rng.normal(size=(tg.num_edges(), 2, 3)).astype(np.float32)

    def jfun(v):
        a = (v, None) if op == "copy_lhs" else (None, v)
        return dgl.gspmm(jg, op, reducer, *a, "e", "e")
    jout = np.asarray(jfun(jnp.asarray(e)))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda v: (jfun(v) * cot).sum())(
        jnp.asarray(e)))
    te = torch.from_numpy(e).requires_grad_()
    ta = (te, None) if op == "copy_lhs" else (None, te)
    tout = dt.gspmm(tg, op, reducer, *ta, "e", "e")
    (tout * torch.from_numpy(cot)).sum().backward()
    assert_close(tout.detach().numpy(), jout, TOL, "forward")
    assert_close(te.grad.numpy(), jgrad, TOL, "gradient")
    assert len(rows_calls) == (0 if masked else 1)


def test_update_all_edge_udf_sums_through_rows(rows_calls):
    jg, tg = _graphs(False)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(tg.num_nodes(), 4)).astype(np.float32)
    jg.ndata["x"], tg.ndata["x"] = jnp.asarray(x), torch.from_numpy(x)

    def msg(edges):                         # an edge UDF of either package
        return {"m": edges.src["x"] * 2.0}
    for red in ("sum", "mean"):
        dgl.update_all(jg, msg, getattr(dgl.function, red)("m", "y"))
        dt.update_all(tg, msg, getattr(dt.function, red)("m", "y"))
        assert_close(tg.ndata["y"].numpy(), np.asarray(jg.ndata["y"]), TOL,
                     red)
    assert len(rows_calls) == 2
