"""K1's row plan: rows of more than ``K1_PIECE`` edges cut into pieces.

The CUDA kernel sums each piece of a long row in its own warp, writes the
partial row to scratch and then adds a long row's partials in piece
order.  Here, on the CPU:

* ``row_plan`` covers every edge of every long row exactly once, in
  pieces of at most T edges, in edge order, and lists exactly the rows
  longer than T;
* a plain version that follows the plan (each piece's sum, then the
  fixed-order sum of the pieces) agrees with ``segment_sum_plain`` run in
  float64 within ``K1_TOL`` (2e-5 of max|ref|, the tolerance
  ``chip_smoke.py`` holds the kernel to), in all three modes (forward over
  CSC, dx over CSR, edge rows) and for the three weight kinds;
* the same plain version, with pieces of 16 edges, agrees with the JAX
  package's gspmm on a ``prepare_spmm``'d graph (Pallas in interpret
  mode, f32x2 split: 1e-4 of max|ref|), forward and dx;
* the plan is cached in ``g.derived`` per direction and reused, moves
  with ``Graph.to``, and the load-width and slice-width rules pick what
  the kernel's notes say.

Inputs are made from a seed with numpy.  The test graph has empty rows
first, last and between long rows, a hub over more than 100 pieces, and
rows of exactly T and T + 1 edges.
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

K1_TOL = 2e-5
PALLAS_TOL = 1e-4
T = sk.K1_PIECE


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _degrees(piece, hub_pieces=101, num_nodes=64, seed=0):
    """In-degree of each of ``num_nodes`` rows: row 0 and the last empty,
    row 1 a hub over ``hub_pieces`` pieces, rows 2 and 5 empty between
    long rows, rows 3, 4 of exactly ``piece`` and ``piece + 1`` edges, row
    6 of 3 * piece + 5, the rest short (0 to piece / 2 edges)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, piece // 2 + 1, num_nodes)
    deg[[0, 2, 5, num_nodes - 1]] = 0
    deg[1] = piece * (hub_pieces - 1) + 3
    deg[3], deg[4], deg[6] = piece, piece + 1, 3 * piece + 5
    return deg


def _graph_pair(deg, seed=1):
    """The JAX and the port graph of the edges that ``deg`` gives each dst
    row, from random src nodes."""
    rng = np.random.default_rng(seed)
    n = deg.shape[0]
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    perm = rng.permutation(dst.shape[0])
    src, dst = src[perm], dst[perm]
    return dgl.graph((src, dst), num_nodes=n), dt.graph((src, dst),
                                                        num_nodes=n)


def planned_plain(indptr, x, gidx=None, eid=None, w=None, plan=None):
    """K1's arithmetic as the kernel orders it: rows of at most T edges as
    one sum, and each long row as the sum of its pieces' partial rows in
    piece order."""
    out = sk.segment_sum_plain(indptr, x, gidx, eid, w)
    if plan.pieces.shape[0] == 0:
        return out
    beg, end = plan.pieces[:, 0].long(), plan.pieces[:, 1].long()
    lens = end - beg
    piece_ip = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    j = torch.repeat_interleave(beg, lens) + torch.arange(int(lens.sum())) \
        - torch.repeat_interleave(piece_ip[:-1], lens)
    rows = gidx[j] if gidx is not None else j
    ws = (eid[j] if eid is not None else j) if w is not None else None
    partial = sk.segment_sum_plain(piece_ip.int(), x, rows, ws, w)
    ptr = plan.piece_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    acc = partial.new_zeros((counts.numel(), x.shape[1]))
    for k in range(int(counts.max())):
        have = counts > k
        acc[have] += partial[ptr[:-1][have] + k]
    out[plan.long_rows.long()] = acc
    return out


@pytest.mark.parametrize("piece", [T, 16, 1])
def test_row_plan_covers_each_edge_once(piece):
    deg = _degrees(piece, hub_pieces=101 if piece > 1 else 40)
    _, g = _graph_pair(deg)
    plan = sk.row_plan(g.csc_indptr, piece)
    ip = g.csc_indptr.long()
    long_rows = plan.long_rows.long()
    assert torch.equal(long_rows,
                       torch.nonzero(torch.from_numpy(deg) > piece)[:, 0])
    assert plan.piece_ptr[0] == 0
    pieces = plan.pieces.long()
    assert pieces.shape == (int(plan.piece_ptr[-1]), 2)
    for l, r in enumerate(long_rows.tolist()):
        p0, p1 = int(plan.piece_ptr[l]), int(plan.piece_ptr[l + 1])
        ps = pieces[p0:p1]
        assert ps[0, 0] == ip[r] and ps[-1, 1] == ip[r + 1]
        assert torch.equal(ps[1:, 0], ps[:-1, 1])         # in edge order
        lens = ps[:, 1] - ps[:, 0]
        assert bool((lens > 0).all()) and bool((lens <= piece).all())
    hub = int(plan.piece_ptr[1] - plan.piece_ptr[0])
    assert hub >= (101 if piece > 1 else 40)
    for t in plan:
        assert t.dtype == torch.int32 and t.is_contiguous()


def test_row_plan_without_long_rows_and_edges():
    for deg in (np.zeros(9, np.int64), np.array([0, 3, T, 0, 1])):
        ip = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])).int()
        plan = sk.row_plan(ip)
        assert plan.long_rows.numel() == 0 and plan.pieces.shape == (0, 2)
        assert plan.piece_ptr.tolist() == [0]


def _mode_args(g, mode, F, wkind, rng):
    E = g.num_edges()
    if mode == "fwd":
        args = dict(indptr=g.csc_indptr, gidx=g.src)
        rows, plan = g.num_src_nodes, sk.graph_row_plan(g, "csc")
    elif mode == "rev":
        args = dict(indptr=g.csr_indptr, gidx=sk.rev_gidx(g),
                    eid=g.csr_eids)
        rows, plan = g.num_dst_nodes, sk.graph_row_plan(g, "csr")
    else:
        args = dict(indptr=g.csc_indptr)
        rows, plan = E, sk.graph_row_plan(g, "csc")
    args["x"] = torch.from_numpy(rng.normal(size=(rows, F))
                                 .astype(np.float32))
    args["w"] = {"none": None,
                 "scalar": torch.from_numpy(rng.normal(size=E)
                                            .astype(np.float32)),
                 "full": torch.from_numpy(rng.normal(size=(E, F))
                                          .astype(np.float32))}[wkind]
    return args, plan


def _f64(args):
    return {k: (v.double() if v is not None and v.is_floating_point()
                else v) for k, v in args.items()}


@pytest.mark.parametrize("wkind", ["none", "scalar", "full"])
@pytest.mark.parametrize("mode", ["fwd", "rev", "edge"])
@pytest.mark.parametrize("F", [1, 7, 16, 41, 602])
def test_planned_plain_matches_plain(F, mode, wkind):
    """The plan's pieces and fixed-order sum against segment_sum_plain in
    float64.  In the CSC direction the hub spans 101 pieces; in the CSR
    direction (out-degrees) a long row appears only where src repeats."""
    deg = _degrees(T, hub_pieces=101 if F <= 41 else 12)
    _, g = _graph_pair(deg, seed=F)
    rng = np.random.default_rng(F)
    args, plan = _mode_args(g, mode, F, wkind, rng)
    if mode != "rev":
        assert plan.long_rows.tolist() == [1, 4, 6]   # row 3 has T edges
    out = planned_plain(plan=plan, **args)
    ref = sk.segment_sum_plain(**_f64(args)).float()
    assert_close(out.numpy(), ref.numpy(), K1_TOL, f"{mode} {wkind}")
    empty = torch.from_numpy(np.flatnonzero(
        np.diff(args["indptr"].numpy()) == 0))
    assert not bool(out[empty].any())
    assert torch.equal(out, planned_plain(plan=plan, **args))   # repeats


def test_planned_plain_no_edges():
    g = dt.graph((np.zeros(0, np.int64), np.zeros(0, np.int64)),
                 num_nodes=6)
    x = torch.ones(6, 5)
    plan = sk.graph_row_plan(g, "csc")
    out = planned_plain(g.csc_indptr, x, g.src, plan=plan)
    assert out.shape == (6, 5) and float(out.abs().max()) == 0.0
    assert torch.equal(sk.segment_sum(g.csc_indptr, x, g.src, plan=plan),
                       out)


@pytest.mark.parametrize("wkind", ["none", "scalar", "full"])
def test_planned_plain_vs_jax_prepared(wkind):
    """Pieces of 16 edges (a hub over 101 of them) against the JAX Pallas
    gspmm through prepare_spmm: u_mul_e / copy_u forward, and dx (the CSR
    direction with csr_eids) against jax.grad."""
    deg = _degrees(16, num_nodes=48, seed=3)
    gj, g = _graph_pair(deg, seed=4)
    gp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2, flat=False)
    rng = np.random.default_rng(5)
    E, F = g.num_edges(), 16
    x = rng.normal(size=(48, F)).astype(np.float32)
    t = rng.normal(size=(48, F)).astype(np.float32)
    w = {"none": None,
         "scalar": rng.normal(size=(E,)).astype(np.float32),
         "full": rng.normal(size=(E, F)).astype(np.float32)}[wkind]
    op = "copy_lhs" if w is None else "mul"
    # the port's internal edge order is the JAX package's: w in that order
    wj = None if w is None else jnp.asarray(w)

    def fwd(xx):
        return dgl.gspmm(gp, op, "sum", xx, wj, "u", "e")
    out_j = fwd(jnp.asarray(x))
    dx_j = jax.grad(lambda xx: (fwd(xx) * t).sum())(jnp.asarray(x))

    wt = None if w is None else torch.from_numpy(w)
    out = planned_plain(g.csc_indptr, torch.from_numpy(x), g.src, w=wt,
                        plan=sk.row_plan(g.csc_indptr, 16))
    dx = planned_plain(g.csr_indptr, torch.from_numpy(t), sk.rev_gidx(g),
                       g.csr_eids, wt, plan=sk.row_plan(g.csr_indptr, 16))
    assert_close(out.numpy(), out_j, PALLAS_TOL, "forward")
    assert_close(dx.numpy(), dx_j, PALLAS_TOL, "dx")


def test_plan_cached_per_graph_and_reused(monkeypatch):
    deg = _degrees(T)
    _, g = _graph_pair(deg)
    built = []
    real = sk.row_plan

    def counting(indptr, piece=T):
        built.append(indptr.numel())
        return real(indptr, piece)
    monkeypatch.setattr(sk, "row_plan", counting)
    g = sk.prepare_spmm(g)
    assert len(built) == 2                               # csc and csr
    plans = (g.derived["k1_plan_csc"], g.derived["k1_plan_csr"])
    assert isinstance(plans[0], sk.RowPlan)
    assert sk.graph_row_plan(g, "csc") is plans[0]
    assert sk.graph_row_plan(g, "csr") is plans[1]
    x = torch.randn(g.num_src_nodes, 4, requires_grad=True)
    sk.gspmm_sum(g, x).sum().backward()
    assert len(built) == 2                               # reused
    moved = g.to("cpu")
    assert isinstance(moved.derived["k1_plan_csc"], sk.RowPlan)
    assert torch.equal(moved.derived["k1_plan_csc"].pieces, plans[0].pieces)
    fresh = dt.graph((g.src.numpy(), g.dst.numpy()),
                     num_nodes=g.num_src_nodes)
    sk.gspmm_sum(fresh, x)                               # first use builds
    assert "k1_plan_csc" in fresh.derived and len(built) == 3


def test_vector_width_rule():
    buf = torch.zeros(4 * 602 + 8)
    x = buf[:4 * 602].view(4, 602)
    assert sk.vector_width(602, x) == 2                  # 2408 B rows
    assert sk.vector_width(128, buf[:512].view(4, 128)) == 4
    assert sk.vector_width(128, buf[1:513].view(4, 128)) == 1
    assert sk.vector_width(128, buf[2:514].view(4, 128)) == 2
    assert sk.vector_width(16, buf[:64].view(4, 16),
                           buf[2:66].view(4, 16)) == 2    # w at 8 B
    assert sk.vector_width(7, buf[:28].view(4, 7)) == 1
    assert sk.vector_width(16, buf[:64].view(4, 16), None) == 4


def test_slice_width_rule():
    assert sk.slice_width(232_965, 602, False) == 32     # 29.8 MB slices
    assert sk.slice_width(232_965, 16, False) == 16      # x fits whole
    assert sk.slice_width(1_000_000, 128, False) == 128  # no slice fits
    assert sk.slice_width(16_384, 64, False) == 64
    assert sk.slice_width(23_526_213, 8, True) == 8      # edge rows
    assert sk.slice_width(100_000, 602, False) == 64
