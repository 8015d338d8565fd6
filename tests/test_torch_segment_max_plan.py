"""K4 and K5 through the row plan: long rows cut into pieces, columns
taken slice by slice.

The CUDA kernels take the max (K4) or the partial dx (K5) of each piece
of a long row in its own warp, write it to scratch, and then take the max
over a long row's partials, or add them in piece order; wide feature
rows go one slice of columns per pass, and dw for an (E,) weight is added
up over the column passes in order.  Here, on the CPU, a plain version
that follows the plan the same way

* equals ``segment_max_plain`` exactly (a max is exact in any order) and
  agrees with ``segment_max_bwd_plain`` run in float64 within ``K5_TOL``
  (2e-5 of max|ref|, the tolerance ``chip_smoke.py`` holds K5 to), for
  the three weight kinds at F in {7, 16, 41, 128}, with the hub as a dst
  row (K4's pieces) and as a src row (K5's), with tied integer features
  and with a NaN;
* through ``gspmm`` max and min and their gradients, with pieces of 16
  edges and slices of 8 columns, agrees with the JAX package on a
  ``prepare_spmm``'d graph (its Pallas max kernel in interpret mode):
  copy_u forward bitwise, weighted forward 1e-6, gradients 1e-5 (the sums
  run in another order), as ``test_torch_segment_max.py`` holds the
  unplanned plain versions;
* ``GspmmMax`` hands the kernels the graph's cached plans, and the slice
  and load-width rules pick what the kernels' notes say;
* a wide x that the kernels will slice is padded to whole 128-byte L2
  lines (``padded_width``) on the card and not on the CPU
  (``PAD_DEVICES``): with the CPU listed there, gspmm max, min and sum at
  the padded width give the unpadded results and gradients (max and min
  exactly, sum within 1e-6), agree with the JAX package (copy_u max and
  min forward bitwise, weighted 1e-6, gradients 1e-5; sum 1e-4, the
  tolerance ``test_torch_spmm.py`` holds K1 to against the Pallas sum
  kernel, whose MXU split rounds differently), save the caller's x and
  no padded copy, and an (E, F) weight turns the padding off.

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
from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as smk
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk

torch.set_num_threads(2)

K5_TOL = 2e-5
FWD_TOL = 1e-6
GRAD_TOL = 1e-5
PALLAS_SUM_TOL = 1e-4
T = sk.K1_PIECE


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _degrees(piece, hub_pieces=101, num_nodes=64, seed=0):
    """Degree of each of ``num_nodes`` rows: row 0 and the last empty, row
    1 a hub over ``hub_pieces`` pieces, rows 2 and 5 empty between long
    rows, rows 3, 4 of exactly ``piece`` and ``piece + 1`` edges, row 6 of
    3 * piece + 5, the rest short (0 to piece / 2 edges)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, piece // 2 + 1, num_nodes)
    deg[[0, 2, 5, num_nodes - 1]] = 0
    deg[1] = piece * (hub_pieces - 1) + 3
    deg[3], deg[4], deg[6] = piece, piece + 1, 3 * piece + 5
    return deg


def _edges(deg, hub, seed=1):
    """Edges whose dst rows (``hub="dst"``) or src rows (``"src"``) have
    the degrees ``deg``, the other end random, in random order."""
    rng = np.random.default_rng(seed)
    n = deg.shape[0]
    a = np.repeat(np.arange(n), deg)
    b = rng.integers(0, n, a.shape[0])
    perm = rng.permutation(a.shape[0])
    a, b = a[perm], b[perm]
    return (b, a, n) if hub == "dst" else (a, b, n)


def _piece_edges(plan):
    """The pieces as rows of an indptr of their own: (piece_ip, j) with j
    the edge positions of all pieces, in order."""
    beg, end = plan.pieces[:, 0].long(), plan.pieces[:, 1].long()
    lens = end - beg
    piece_ip = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    j = torch.repeat_interleave(beg, lens) + torch.arange(int(lens.sum())) \
        - torch.repeat_interleave(piece_ip[:-1], lens)
    return piece_ip.int(), j


def _combine_pieces(plan, partial, op, init):
    """Each long row's partial rows combined in piece order."""
    ptr = plan.piece_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    acc = partial.new_full((counts.numel(), partial.shape[1]), init)
    for k in range(int(counts.max())):
        have = counts > k
        acc[have] = op(acc[have], partial[ptr[:-1][have] + k])
    return acc


def _cols(w, sl):
    return w[:, sl].contiguous() if w is not None and w.dim() == 2 else w


def planned_max(indptr, x, gidx, w, plan, cols):
    """K4's arithmetic as the kernel orders it: ``cols`` columns a pass;
    rows of at most T edges as one max, each long row as the max over its
    pieces' partial rows."""
    F = x.shape[1]
    out = x.new_empty((indptr.numel() - 1, F))
    P = plan.pieces.shape[0]
    if P:
        piece_ip, j = _piece_edges(plan)
    for c in range(0, F, cols):
        sl = slice(c, min(c + cols, F))
        xs, ws = x[:, sl].contiguous(), _cols(w, sl)
        o = smk.segment_max_plain(indptr, xs, gidx, ws)
        if P:
            partial = smk.segment_max_plain(
                piece_ip, xs, gidx[j], None if ws is None else ws[j])
            o[plan.long_rows.long()] = _combine_pieces(
                plan, partial, torch.maximum, smk.MINMAX_NEG)
        out[:, sl] = o
    return out


def planned_max_bwd(csr_indptr, dst_csr, csr_eids, x, w, raw, g, plan, cols,
                    want_dw=True):
    """K5's arithmetic as the kernel orders it: ``cols`` columns a pass;
    each piece's partial dx from its row's x, a long row's dx their sum in
    piece order; dw of an (E,) weight added up over the passes in order."""
    F = x.shape[1]
    dx = x.new_empty(x.shape)
    dw = None
    if w is not None and want_dw:
        dw = torch.zeros_like(w)
    P = plan.pieces.shape[0]
    if P:
        piece_ip, j = _piece_edges(plan)
        piece_row = plan.piece_row.long()
    for c in range(0, F, cols):
        sl = slice(c, min(c + cols, F))
        xs, ws = x[:, sl].contiguous(), _cols(w, sl)
        rs, gs = raw[:, sl].contiguous(), g[:, sl].contiguous()
        d, dwb = smk.segment_max_bwd_plain(csr_indptr, dst_csr, csr_eids,
                                           xs, ws, rs, gs, want_dw)
        if P:
            partial, _ = smk.segment_max_bwd_plain(
                piece_ip, dst_csr[j], csr_eids[j], xs[piece_row], ws, rs,
                gs, False)
            d[plan.long_rows.long()] = _combine_pieces(
                plan, partial, torch.add, 0.0)
        dx[:, sl] = d
        if dw is not None and w.dim() == 1:
            dw += dwb
        elif dw is not None:
            dw[:, sl] = dwb
    return dx, dw


def _inputs(g, F, wkind, rng, integers=False):
    E = g.num_edges()

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    x = t(rng.integers(0, 3, size=(g.num_src_nodes, F))) if integers \
        else t(rng.normal(size=(g.num_src_nodes, F)))
    w = {"none": None, "scalar": t(rng.normal(size=E)),
         "full": t(rng.normal(size=(E, F)))}[wkind]
    return x, w, t(rng.normal(size=(g.num_dst_nodes, F)))


def _check_planned(g, x, w, gout, cols, what):
    """The planned versions against the plain ones on g; returns raw."""
    p_fwd, p_rev = sk.graph_row_plan(g, "csc"), sk.graph_row_plan(g, "csr")
    raw = planned_max(g.csc_indptr, x, g.src, w, p_fwd, cols)
    ref = smk.segment_max_plain(g.csc_indptr, x, g.src, w)
    np.testing.assert_array_equal(raw.numpy(), ref.numpy(), err_msg=what)
    args = (g.csr_indptr, sk.rev_gidx(g), g.csr_eids, x, w, ref, gout)
    out = planned_max_bwd(*args, p_rev, cols)
    ref64 = smk.segment_max_bwd_plain(*args, acc_dtype=torch.float64)
    for name, a, r in zip(("dx", "dw"), out, ref64):
        if r is not None:
            assert_close(a.numpy(), r.float().numpy(), K5_TOL,
                         f"{what} {name}")
    again = planned_max_bwd(*args, p_rev, cols)
    assert all(a is None or torch.equal(a, b) for a, b in zip(out, again))
    return raw


@pytest.mark.parametrize("hub", ["dst", "src"])
@pytest.mark.parametrize("wkind", ["none", "scalar", "full"])
@pytest.mark.parametrize("F", [7, 16, 41, 128])
def test_planned_matches_plain(F, wkind, hub):
    """Pieces, the max over pieces (K4; hub a dst row) and the sum of the
    pieces' partial dx in piece order (K5; hub a src row), 32 columns a
    pass, against the plain versions."""
    g = dt.graph(*_split(_edges(_degrees(T), hub, seed=F)))
    long_plan = sk.graph_row_plan(g, "csc" if hub == "dst" else "csr")
    assert long_plan.long_rows.tolist() == [1, 4, 6]    # row 3 has T edges
    assert int(long_plan.piece_ptr[1] - long_plan.piece_ptr[0]) == 101
    assert long_plan.piece_row.tolist() == [1] * 101 + [4] * 2 + [6] * 4
    rng = np.random.default_rng(F)
    x, w, gout = _inputs(g, F, wkind, rng)
    raw = _check_planned(g, x, w, gout, 32, f"F={F} {wkind} hub {hub}")
    empty = torch.from_numpy(np.flatnonzero(np.diff(g.host("csc_indptr"))
                                            == 0))
    assert bool((raw[empty] == smk.MINMAX_NEG).all())


def _split(edges):
    src, dst, n = edges
    return (src, dst), n


@pytest.mark.parametrize("hub", ["dst", "src"])
def test_planned_ties_get_full_cotangent(hub):
    """Integer features tie: every tied edge of a long row gets the full
    cotangent whichever piece it lies in."""
    g = dt.graph(*_split(_edges(_degrees(T, hub_pieces=12), hub, seed=2)))
    rng = np.random.default_rng(2)
    x, _, _ = _inputs(g, 16, "none", rng, integers=True)
    gout = torch.ones(g.num_dst_nodes, 16)
    _check_planned(g, x, None, gout, 8, f"ties hub {hub}")
    raw = smk.segment_max_plain(g.csc_indptr, x, g.src)
    dx, _ = planned_max_bwd(g.csr_indptr, sk.rev_gidx(g), g.csr_eids, x,
                            None, raw, gout,
                            sk.graph_row_plan(g, "csr"), 8)
    covered = int((raw > smk.MINMAX_NEG / 2).sum())
    assert float(dx.sum()) > covered + 100              # ties counted fully
    assert torch.equal(dx, dx.round())


@pytest.mark.parametrize("hub", ["dst", "src"])
def test_planned_nan_kept(hub):
    """A NaN feature makes the raw max of every row it reaches NaN,
    through pieces too, and passes no gradient."""
    g = dt.graph(*_split(_edges(_degrees(T, hub_pieces=12), hub, seed=3)))
    rng = np.random.default_rng(3)
    x, _, gout = _inputs(g, 16, "none", rng)
    u = int(g.src[int(g.csc_indptr[1]) + 5])     # a src of row 1's edges
    x[u, 3] = float("nan")
    raw = planned_max(g.csc_indptr, x, g.src, None,
                      sk.graph_row_plan(g, "csc"), 8)
    ref = smk.segment_max_plain(g.csc_indptr, x, g.src)
    assert bool(raw[1, 3].isnan()) and not bool(raw[:, :3].isnan().any())
    assert torch.equal(raw.isnan(), ref.isnan())
    assert torch.equal(raw.nan_to_num(7.0), ref.nan_to_num(7.0))
    dx, _ = planned_max_bwd(g.csr_indptr, sk.rev_gidx(g), g.csr_eids, x,
                            None, raw, gout, sk.graph_row_plan(g, "csr"), 8)
    assert bool(dx.isfinite().all())
    assert float(dx[u, 3]) == 0.0


def _through_planned(monkeypatch, piece, cols):
    """Route GspmmMax through the planned versions, with pieces of
    ``piece`` edges and ``cols`` columns a pass."""
    def fwd(indptr, x, gidx, w=None, *, plan=None):
        assert isinstance(plan, sk.RowPlan)         # the cached plan
        return planned_max(indptr, x, gidx, w, sk.row_plan(indptr, piece),
                           cols)

    def bwd(csr_indptr, dst_csr, csr_eids, x, w, raw, g, want_dw=True, *,
            plan=None):
        assert isinstance(plan, sk.RowPlan)
        return planned_max_bwd(csr_indptr, dst_csr, csr_eids, x, w, raw, g,
                               sk.row_plan(csr_indptr, piece), cols, want_dw)
    monkeypatch.setattr(smk, "segment_max", fwd)
    monkeypatch.setattr(smk, "segment_max_bwd", bwd)


@pytest.mark.parametrize("wkind", ["none", "scalar", "full"])
@pytest.mark.parametrize("reducer", ["max", "min"])
def test_planned_gspmm_vs_jax_prepared(monkeypatch, reducer, wkind):
    """gspmm max/min and its gradients through the planned versions
    (pieces of 16 edges, a hub over 101 of them in either direction;
    slices of 8 columns) against the JAX Pallas max kernel."""
    _through_planned(monkeypatch, 16, 8)
    deg = _degrees(16, num_nodes=48, seed=3)
    src, dst, n = _edges(deg, "dst", seed=4)
    src2, dst2, _ = _edges(deg, "src", seed=5)
    src, dst = np.concatenate([src, src2]), np.concatenate([dst, dst2])
    gj = dgl.prepare_spmm(dgl.graph((src, dst), num_nodes=n), te=256, bc=8,
                          wc=2)
    g = dt.graph((src, dst), num_nodes=n)
    for d in ("csc", "csr"):
        assert sk.row_plan(getattr(g, f"{d}_indptr"), 16).pieces.shape[0] \
            > 100
    rng = np.random.default_rng(6)
    E, F = g.num_edges(), 20
    x = rng.normal(size=(n, F)).astype(np.float32)
    t = rng.normal(size=(n, F)).astype(np.float32)
    w = {"none": None, "scalar": rng.normal(size=(E,)).astype(np.float32),
         "full": rng.normal(size=(E, F)).astype(np.float32)}[wkind]
    args = [x] if w is None else [x, w]
    op = "copy_lhs" if w is None else "mul"

    def fwd_j(*a):
        return dgl.gspmm(gj, op, reducer, *a, "u", "e") if len(a) == 2 \
            else dgl.gspmm(gj, op, reducer, a[0])
    out_j = fwd_j(*map(jnp.asarray, args))
    grads_j = jax.grad(lambda *a: (fwd_j(*a) * t).sum(),
                       argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    out = dt.gspmm(g, op, reducer, *ins, "u", "e") if len(ins) == 2 \
        else dt.gspmm(g, op, reducer, ins[0])
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), ins)
    if w is None:
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(out_j))
    else:
        assert_close(out.detach().numpy(), out_j, FWD_TOL, "forward")
    for name, a, b in zip(("dx", "dw"), grads, grads_j):
        assert_close(a.numpy(), b, GRAD_TOL, name)


def test_gspmm_max_passes_cached_plans(monkeypatch):
    """GspmmMax hands K4 the CSC plan and K5 the CSR plan cached on the
    graph, and the wrappers take ``plan=`` on the CPU too."""
    g = sk.prepare_spmm(dt.graph(*_split(_edges(_degrees(T, 3), "dst"))))
    seen = {}
    real_fwd, real_bwd = smk.segment_max, smk.segment_max_bwd

    def fwd(*a, plan=None):
        seen["fwd"] = plan
        return real_fwd(*a, plan=plan)

    def bwd(*a, plan=None):
        seen["bwd"] = plan
        return real_bwd(*a, plan=plan)
    monkeypatch.setattr(smk, "segment_max", fwd)
    monkeypatch.setattr(smk, "segment_max_bwd", bwd)
    x = torch.randn(g.num_src_nodes, 5, requires_grad=True)
    smk.gspmm_max(g, x).sum().backward()
    assert seen["fwd"] is g.derived["k1_plan_csc"]
    assert seen["bwd"] is g.derived["k1_plan_csr"]
    assert x.grad.shape == x.shape


def test_slice_width_rules():
    F = 602
    assert smk.max_bwd_slice_width(232_965, F, 0, False) == 32   # 29.8 MB
    assert smk.max_bwd_slice_width(232_965, 16, 0, False) == 16  # fits whole
    assert smk.max_bwd_slice_width(1_000_000, 128, 0, False) == 128  # none
    assert smk.max_bwd_slice_width(232_965, F, 2, True) == 32
    assert smk.max_bwd_slice_width(232_965, F, 1, False) == 32
    # dw of an (E,) weight sums over all columns: one slice, one owner
    assert smk.max_bwd_slice_width(232_965, F, 1, True) == F


def test_load_width_over_every_tensor():
    """``vector_width`` is the narrowest load that any of its tensors
    allows (K1 and K4 over x and an (E, F) weight; K5 over raw, g and the
    weight, and over x)."""
    buf = torch.zeros(4 * 602 + 8)
    al = buf[:4 * 602].view(4, 602)
    assert sk.vector_width(602, al, al, al, None) == 2     # 2408 B rows
    assert sk.vector_width(602, al, buf[1:4 * 602 + 1].view(4, 602), al) == 1
    a16 = buf[:64].view(4, 16)
    assert sk.vector_width(16, a16, a16, a16, a16) == 4
    assert sk.vector_width(16, a16, a16, buf[2:66].view(4, 16), a16) == 2
    assert sk.vector_width(16, a16, a16, a16, buf[1:65].view(4, 16)) == 1
    assert sk.vector_width(7, buf[:28].view(4, 7)) == 1


def test_k5_takes_x_at_its_own_width():
    """K5's x may lack raw's last columns (gspmm pads what K5 gathers, raw
    and the cotangent, and not what it streams): the plain version gives
    what it gives for x with zero columns added, cut to x's columns; and x
    and dx get a load width of their own, at most raw's and g's."""
    g = dt.graph(*_split(_edges(_degrees(T, 3), "src", seed=11)))
    rng = np.random.default_rng(11)
    F, Fp = 41, 64
    x, w, gout = _inputs(g, F, "scalar", rng)
    xp, gp = sk.pad_columns(x, Fp), sk.pad_columns(gout, Fp)
    raw = smk.segment_max_plain(g.csc_indptr, xp, g.src, w)
    args = (g.csr_indptr, sk.rev_gidx(g), g.csr_eids)
    dx, dw = smk.segment_max_bwd(*args, x, w, raw, gp)
    dxp, dwp = smk.segment_max_bwd(*args, xp, w, raw, gp)
    assert dx.shape == x.shape and dxp.shape == xp.shape
    assert torch.equal(dx, dxp[:, :F]) and torch.equal(dw, dwp)
    assert not bool(dxp[:, F:].any())
    buf = torch.zeros(4 * 608 + 8)
    r608, x602 = buf[:4 * 608].view(4, 608), buf[:4 * 602].view(4, 602)
    assert smk.max_bwd_load_widths(608, x602, None, r608, r608) == (4, 2)
    assert smk.max_bwd_load_widths(608, r608, None, r608, r608) == (4, 4)
    assert smk.max_bwd_load_widths(
        608, buf[1:4 * 602 + 1].view(4, 602), None, r608, r608) == (4, 1)
    assert smk.max_bwd_load_widths(
        608, r608, None, r608, buf[2:4 * 608 + 2].view(4, 608)) == (2, 2)
    assert smk.max_bwd_load_widths(602, x602, x602, x602, x602) == (2, 2)


def test_padded_width_rule():
    E = 1000
    assert sk.padded_width(232_965, 602, None) == 608     # sliced: 19 lines
    assert sk.padded_width(232_965, 602, torch.zeros(E)) == 608
    assert sk.padded_width(232_965, 602, torch.zeros(E, 602)) == 602
    assert sk.padded_width(232_965, 608, None) == 608
    assert sk.padded_width(100_000, 602, None) == 608     # 64-column slices
    assert sk.padded_width(232_965, 16, None) == 16       # x fits whole
    assert sk.padded_width(1_000_000, 100, None) == 100   # no slice fits
    assert sk.slice_width(232_965, 608, False) == 32


@pytest.mark.parametrize("wkind", ["none", "scalar", "full"])
@pytest.mark.parametrize("reducer", ["max", "min", "sum"])
def test_gspmm_padded_equals_unpadded(monkeypatch, reducer, wkind):
    """With an L2 budget small enough that F = 41 is sliced, gspmm runs its
    kernels at 64 columns (41 under an (E, F) weight) and returns what it
    returns unpadded."""
    g = dt.graph(*_split(_edges(_degrees(T, 3), "dst", seed=7)))
    n, F = g.num_src_nodes, 41
    rng = np.random.default_rng(7)
    x, w, gout = _inputs(g, F, wkind, rng)
    fn = sk.gspmm_sum if reducer == "sum" else \
        (lambda *a: smk.gspmm_max(*a, reduce_op=reducer))

    def run():
        ins = [t.clone().requires_grad_() for t in (x, w) if t is not None]
        out = fn(g, *ins)
        return out.detach(), torch.autograd.grad((out * gout).sum(), ins)
    ref, ref_grads = run()
    widths = []
    real_max, real_sum = smk.segment_max, sk.segment_sum
    monkeypatch.setattr(smk, "segment_max", lambda i, xx, *a, **k: (
        widths.append(xx.shape[1]), real_max(i, xx, *a, **k))[1])
    monkeypatch.setattr(sk, "segment_sum", lambda i, xx, *a, **k: (
        widths.append(xx.shape[1]), real_sum(i, xx, *a, **k))[1])
    monkeypatch.setattr(sk, "SLICE_BUDGET", n * 16 * 4)
    monkeypatch.setattr(sk, "SLICE_MIN_REUSE", 0)    # slice a small graph
    assert sk.padded_width(n, F, None) == 64
    run()
    assert widths and set(widths) == {F}        # a CPU tensor is not padded
    del widths[:]
    monkeypatch.setattr(sk, "PAD_DEVICES", ("cuda", "cpu"))
    out, grads = run()
    assert widths and set(widths) == {F if wkind == "full" else 64}
    assert out.shape == ref.shape
    tol = 1e-6 if reducer == "sum" else 0.0
    assert_close(out.numpy(), ref.numpy(), tol, "forward")
    for a, b in zip(grads, ref_grads):
        assert a.shape == b.shape
        assert_close(a.numpy(), b.numpy(), 1e-6, "gradient")


@pytest.mark.parametrize("wkind", ["none", "scalar"])
@pytest.mark.parametrize("reducer", ["max", "min", "sum"])
def test_padded_gspmm_vs_jax_prepared(monkeypatch, reducer, wkind):
    """gspmm max, min and sum and their gradients, run at the padded width
    (F = 41 as 64 columns), against the JAX Pallas kernels; what autograd
    saves is the caller's x, at 41 columns."""
    src, dst, n = _edges(_degrees(16, hub_pieces=5, num_nodes=48, seed=8),
                         "dst", seed=9)
    gj = dgl.prepare_spmm(dgl.graph((src, dst), num_nodes=n), te=256, bc=8,
                          wc=2)
    g = dt.graph((src, dst), num_nodes=n)
    monkeypatch.setattr(sk, "SLICE_BUDGET", n * 16 * 4)
    monkeypatch.setattr(sk, "SLICE_MIN_REUSE", 0)    # slice a small graph
    monkeypatch.setattr(sk, "PAD_DEVICES", ("cuda", "cpu"))
    rng = np.random.default_rng(10)
    E, F = g.num_edges(), 41
    x = rng.normal(size=(n, F)).astype(np.float32)
    t = rng.normal(size=(n, F)).astype(np.float32)
    args = [x] if wkind == "none" else \
        [x, rng.normal(size=(E,)).astype(np.float32)]
    op = "copy_lhs" if wkind == "none" else "mul"

    def fwd_j(*a):
        return dgl.gspmm(gj, op, reducer, *a, "u", "e") if len(a) == 2 \
            else dgl.gspmm(gj, op, reducer, a[0])
    out_j = fwd_j(*map(jnp.asarray, args))
    grads_j = jax.grad(lambda *a: (fwd_j(*a) * t).sum(),
                       argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ins = [torch.tensor(a, requires_grad=True) for a in args]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda s: (saved.append(tuple(s.shape)), s)[1], lambda s: s):
        # on the CPU dt.gspmm composes a sum without K1's wrapper
        out = sk.gspmm_sum(g, *ins) if reducer == "sum" \
            else dt.gspmm(g, op, reducer, *ins, "u", "e") if len(ins) == 2 \
            else dt.gspmm(g, op, reducer, ins[0])
    assert (n, F) in saved and sum(s == (n, 64) for s in saved) == \
        (0 if reducer == "sum" else 1)              # raw alone is padded
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), ins)
    if reducer == "sum":
        fwd_tol = grad_tol = PALLAS_SUM_TOL
    else:
        fwd_tol, grad_tol = FWD_TOL, GRAD_TOL
    if wkind == "none" and reducer != "sum":
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(out_j))
    else:
        assert_close(out.detach().numpy(), out_j, fwd_tol, "forward")
    for name, a, b in zip(("dx", "dw"), grads, grads_j):
        assert_close(a.numpy(), b, grad_tol, name)
