"""K1's packed route for short rows: the plan's single rows and the route
rule.

Where at least ``K1_PACK_SHARE`` (three quarters) of the rows of an
indptr have at most ``K1_SHORT`` edges and a warp holds at least two lane
groups, the CUDA kernel sums the short
rows of each aligned window of ``K1_PACK_ROWS`` rows in one warp, one lane
group a row, each row's edges in edge order; rows of more edges, up to
``K1_PIECE``, are listed in the plan (``singles``) and walked a warp each,
and longer rows keep their pieces.  Here, on the CPU:

* the plan against a numpy reference on degree lists of ones with empty
  rows first, last and between, rows of ``K1_SHORT`` and ``K1_SHORT + 1``
  edges, rows longer than ``K1_PIECE`` between short ones and row counts
  that are no multiple of a window or of the lane groups: every row lies
  in exactly one item (a long row's pieces, its window, or a single row);
* ``k1_route`` as a pure function of the degrees, F and the load width,
  and the launcher's route from its arguments;
* a plain version that follows the windows (``packed_plain``: each short
  row summed in edge order, one float32 add a step, the other rows as the
  row plan has them) against ``segment_sum_plain`` run in float64 within
  ``K1_TOL`` (2e-5 of max|ref|, the tolerance ``chip_smoke.py`` holds the
  kernel to), in all three modes and for every weight kind (none, (E,),
  (E, F), per head), float32 and bf16 rows;
* the same on a small ``prepare_rgcn`` pair graph against the JAX
  package's R-GCN functions (Pallas in interpret mode at full precision,
  as ``tests/test_torch_rgcn.py`` runs them: 1e-5);
* the plan cached in ``g.derived`` with its single rows and moved by
  ``Graph.to``.

Inputs are made from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops import rgcn as jrgcn

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops import rgcn as trgcn
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk

torch.set_num_threads(2)

K1_TOL = 2e-5
RGCN_TOL = 1e-5
T, S, P = sk.K1_PIECE, sk.K1_SHORT, sk.K1_PACK_ROWS


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def np_items(deg, piece=T, short=S, rows=P):
    """Each row's item by a walk over the rows: ("window", k) for a row of
    at most min(short, piece) edges, ("single", r) for one of at most
    piece, ("long", r) for the rest."""
    lim = min(short, piece)
    return [("window", r // rows) if d <= lim else
            ("single", r) if d <= piece else ("long", r)
            for r, d in enumerate(deg)]


def _indptr(deg):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                            .astype(np.int32))


def _degree_lists():
    """Degree lists with the cases the plan must get right."""
    rng = np.random.default_rng(7)
    ones = np.ones(101, np.int64)
    ones[[0, 40, 41, 100]] = 0                   # empty first, between, last
    edges = np.ones(77, np.int64)
    edges[[10, 11]] = [S, S + 1]                 # at the limit, one past it
    edges[[30, 50]] = [T + 1, 3 * T]             # long rows among short
    edges[33] = T                                # a row of T edges: single
    mixed = rng.integers(0, 2 * S, 333)          # short and single rows
    mixed[rng.integers(0, 333, 5)] = 5 * T + 1
    return {"ones": ones, "edges": edges, "mixed": mixed,
            "empty": np.zeros(9, np.int64), "one": np.array([S]),
            "one-long": np.array([T + 1]), "none": np.zeros(0, np.int64),
            "ones-33": np.ones(33, np.int64)}


@pytest.mark.parametrize("name", list(_degree_lists()))
def test_plan_items_match_numpy(name):
    deg = _degree_lists()[name]
    plan = sk.row_plan(_indptr(deg))
    items = np_items(deg)
    assert plan.singles.tolist() == [r for k, r in items if k == "single"]
    assert plan.long_rows.tolist() == [r for k, r in items if k == "long"]
    for t in plan:
        assert t.dtype == torch.int32 and t.is_contiguous()
    # every row in exactly one item: a long row's pieces, a window, a row
    seen = np.zeros(len(deg), np.int64)
    for r, (kind, k) in enumerate(items):
        if kind == "window":
            assert r // P == k and deg[r] <= S
            seen[r] += 1
    seen[plan.singles.long().numpy()] += 1
    seen[plan.long_rows.long().numpy()] += 1
    assert (seen == 1).all()
    assert plan.short_rows(len(deg)) == int((deg <= S).sum())
    pieces_of = plan.piece_row.long().numpy()
    assert set(pieces_of.tolist()) == set(plan.long_rows.tolist())


def test_plan_with_small_pieces():
    """With pieces of 4 edges a row of 5 is long, not single, and a row of
    4 is short: no row is two of them."""
    deg = np.array([1, 4, 5, 16, 2, 3])
    plan = sk.row_plan(_indptr(deg), 4)
    assert sk.short_limit(4) == 4
    assert plan.long_rows.tolist() == [2, 3]
    assert plan.singles.tolist() == []
    assert plan.short_rows(6) == 4
    plan = sk.row_plan(_indptr(np.array([1, 17, 16, 300, 0])))
    assert plan.singles.tolist() == [1] and plan.long_rows.tolist() == [3]


@pytest.mark.parametrize("F,V,groups", [
    (1, 1, 32), (7, 1, 4), (8, 4, 16), (10, 2, 4), (16, 4, 8), (32, 4, 4),
    (41, 1, 1), (64, 4, 2), (65, 1, 1), (128, 4, 1), (602, 2, 1)])
def test_route_rule(F, V, groups):
    """k1_route as a pure function of the degrees, F and V: packed where a
    warp holds two lane groups or more and K1_PACK_SHARE (three quarters)
    of the rows or more are short; lanes as the kernel computes them."""
    assert 32 // sk.edge_lanes(F, V) == groups
    assert sk.K1_PACK_SHARE == 0.75
    rng = np.random.default_rng(F)
    for deg, short_share in (
            (np.ones(64, np.int64), 1.0),
            (rng.poisson(101, 64), 0.0),                   # Reddit's rows
            (np.r_[np.ones(48), np.full(16, S + 1)].astype(np.int64), 0.75),
            (np.r_[np.ones(47), np.full(17, S + 1)].astype(np.int64), 0.73),
            (np.r_[np.ones(32), np.full(32, S + 1)].astype(np.int64), 0.5),
            (np.r_[np.ones(31), np.full(33, S + 1)].astype(np.int64), 0.48),
            (np.zeros(64, np.int64), 1.0)):
        short = int((deg <= S).sum())
        assert short == round(short_share * 64)
        want = "packed" if groups >= 2 and short * 4 >= 3 * 64 else "rows"
        assert sk.k1_route(64, short, F, V) == want
        plan = sk.row_plan(_indptr(deg))
        assert sk.plan_route(plan, 64, F, V) == want


def test_route_of_the_launcher():
    """The launcher's route from its own widths: x's load width (its
    alignment) and the slice."""
    deg = np.ones(64, np.int64)
    ip = _indptr(deg)
    src = torch.arange(64, dtype=torch.int32)
    buf = torch.zeros(64 * 10 + 1)
    for x, want in ((buf[:640].view(64, 10), "packed"),     # V = 2: G = 4
                    (buf[1:641].view(64, 10), "packed"),    # V = 1: G = 2
                    (torch.zeros(64, 128), "rows"),         # G = 1
                    (torch.zeros(64, 41), "rows")):
        launch = sk.segment_sum_launcher(ip, x, src)
        assert launch.route() == want
    launch = sk.segment_sum_launcher(ip, torch.zeros(64, 128), src)
    assert launch.route(32) == "packed"          # a 32-column slice: G = 4


def _pieces(indptr, x, gidx, eid, w, plan):
    """Each long row as the sum of its pieces' partial rows, in piece
    order."""
    out = {}
    for l, r in enumerate(plan.long_rows.tolist()):
        acc = None
        for p in range(int(plan.piece_ptr[l]), int(plan.piece_ptr[l + 1])):
            b, e = plan.pieces[p].tolist()
            j = torch.arange(b, e)
            we = None if w is None else w[eid[j] if eid is not None else j]
            part = sk.segment_sum_plain(
                torch.tensor([0, e - b], dtype=torch.int32), x,
                (gidx[j] if gidx is not None else j).int(), None, we,
                out_dtype=torch.float32)[0]
            acc = part if acc is None else acc + part
        out[r] = acc
    return out


def packed_plain(indptr, x, gidx=None, eid=None, w=None, plan=None):
    """K1's arithmetic as the packed route orders it: each short row's
    edges (the windows' rows) added in edge order, one float32 multiply
    and add a step; the single rows as one sum; the long rows as their
    pieces' partial rows in piece order.  Rounded once to x's dtype."""
    out = sk.segment_sum_plain(indptr, x, gidx, eid, w,
                               out_dtype=torch.float32)
    for r, acc in _pieces(indptr, x, gidx, eid, w, plan).items():
        out[r] = acc
    ip = indptr.long()
    n = ip.numel() - 1
    rows = torch.nonzero(ip[1:] - ip[:-1] <= sk.short_limit()).squeeze(1)
    assert rows.numel() == plan.short_rows(n)
    beg, deg = ip[rows], ip[rows + 1] - ip[rows]
    acc = torch.zeros((rows.numel(), x.shape[1]), dtype=torch.float32)
    for j in range(int(deg.max()) if deg.numel() else 0):
        have = deg > j
        p = beg[have] + j
        m = (x[gidx[p]] if gidx is not None else x[p]).float()
        if w is not None:
            we = (w[eid[p]] if eid is not None else w[p]).float()
            m = m * (we[:, None] if we.dim() == 1 else we)
        acc[have] = acc[have] + m
    out[rows] = acc
    return out.to(x.dtype)


def _graph(seed, n=300):
    """A graph whose dst rows are mostly of 0-2 edges, with a row of S and
    of S + 1, a hub over 3 pieces and a run of one-edge rows longer than a
    pack; src rows (the CSR direction) are short and long too."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 3, n)
    deg[[5, 6]] = [S, S + 1]
    deg[100] = 2 * T + 7
    deg[150:220] = 1
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.shape[0])
    src[:300] = 7                                 # a long src row
    perm = rng.permutation(dst.shape[0])
    return dt.graph((src[perm], dst[perm]), num_nodes=n)


def _mode_args(g, mode, F, wkind, dtype, rng):
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
                                 .astype(np.float32)).to(dtype)
    H = 2 if F % 2 == 0 else 1
    args["w"] = {
        "none": None,
        "scalar": torch.from_numpy(rng.normal(size=E).astype(np.float32)),
        "full": torch.from_numpy(rng.normal(size=(E, F)).astype(np.float32)),
        "head": sk.flat_weight(torch.from_numpy(
            rng.normal(size=(E, H, 1)).astype(np.float32)), (rows, H, F // H))
    }[wkind]
    return args, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wkind", ["none", "scalar", "full", "head"])
@pytest.mark.parametrize("mode", ["fwd", "rev", "edge"])
@pytest.mark.parametrize("F", [1, 10, 41])
def test_packed_plain_matches_plain(F, mode, wkind, dtype):
    g = _graph(F)
    rng = np.random.default_rng(F + 1)
    args, plan = _mode_args(g, mode, F, wkind, dtype, rng)
    assert plan.short_rows(args["indptr"].numel() - 1) > 0
    assert plan.long_rows.numel() > 0
    if mode != "rev":                  # the CSR rows have no single row
        assert plan.singles.numel() > 0
    out = packed_plain(plan=plan, **args)
    assert out.dtype == dtype
    ref = sk.segment_sum_plain(**{k: (v.double() if v is not None and
                                      v.is_floating_point() else v)
                                  for k, v in args.items()})
    if dtype == torch.float32:
        assert_close(out.numpy(), ref.numpy(), K1_TOL, f"{mode} {wkind}")
    else:
        # one rounding to bf16 of the float32 sum: half an ulp of each row
        r = ref.float()
        ulp = torch.where(r == 0, torch.zeros_like(r), 2.0 ** (
            torch.floor(torch.log2(r.abs().clamp(min=1e-30))) - 7))
        scale = float(r.abs().max())
        assert bool(((out.float() - r).abs() <= ulp + K1_TOL * scale).all())
    assert torch.equal(out, packed_plain(plan=plan, **args))     # repeats
    empty = torch.from_numpy(np.flatnonzero(
        np.diff(args["indptr"].numpy()) == 0))
    assert not bool(out[empty].float().any())


@pytest.fixture(scope="module")
def pair_plans():
    """A small R-GCN pair graph of many short rows in both packages."""
    rng = np.random.default_rng(11)
    n, e, R = 400, 900, 6
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    et = rng.integers(0, R, e).astype(np.int32)
    gj = dgl.graph((src, dst), num_nodes=n)
    gt = dt.graph((src, dst), num_nodes=n)
    return (dgl.prepare_rgcn(gj, et, R, te=64), dt.prepare_rgcn(gt, et, R),
            n)


def test_pair_graph_matches_jax(pair_plans, monkeypatch):
    """The pair graph's forward (with and without a norm), its dx over the
    CSR rows and the per-dst edge-row sums, each through ``packed_plain``
    over the port's plans, against the JAX package's rgcn functions."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    pj, pt, n = pair_plans
    pg = pt.pair_graph
    M, F = pt.num_pairs, 8
    p_csc, p_csr = pg.derived["k1_plan_csc"], pg.derived["k1_plan_csr"]
    seg = pt.dst_segments
    for plan, rows in ((p_csc, M), (p_csr, n), (seg.plan, n)):
        assert sk.plan_route(plan, rows, F, 4) == "packed"
    rng = np.random.default_rng(12)
    x = rng.normal(size=(n, F)).astype(np.float32)
    cot = rng.normal(size=(M, F)).astype(np.float32)
    # the norm in the original graph's internal order; the pair graph
    # reads it through the plan's edge permutation
    norm = rng.random(pg.num_edges()).astype(np.float32)
    for nrm in (None, norm):
        wt = None if nrm is None else torch.from_numpy(nrm)[
            pt.edge_perm.long()]
        out = packed_plain(pg.csc_indptr, torch.from_numpy(x), pg.src,
                           w=wt, plan=p_csc)
        agg, vjp = jax.vjp(lambda xx: jrgcn.rgcn_aggregate_pairs(
            pj, xx, None if nrm is None else jnp.asarray(nrm)),
            jnp.asarray(x))
        assert_close(out.numpy(), agg, RGCN_TOL, f"aggregate {nrm is None}")
        dx = packed_plain(pg.csr_indptr, torch.from_numpy(cot),
                          sk.rev_gidx(pg), pg.csr_eids, wt, plan=p_csr)
        assert_close(dx.numpy(), vjp(jnp.asarray(cot))[0], RGCN_TOL,
                     f"aggregate dx {nrm is None}")
    msg = rng.normal(size=(M, 6)).astype(np.float32)
    red = packed_plain(seg.indptr, torch.from_numpy(msg), plan=seg.plan)
    assert_close(red.numpy(), jrgcn.rgcn_reduce_pairs(pj, jnp.asarray(msg),
                                                      n), RGCN_TOL, "reduce")
    assert_close(red.numpy(), trgcn.rgcn_reduce_pairs(
        pt, torch.from_numpy(msg), n).numpy(), K1_TOL, "port reduce")


def test_plan_cached_and_moved():
    g = _graph(3)
    g = sk.prepare_spmm(g, dense_hub=False)
    plan = g.derived["k1_plan_csc"]
    assert plan.singles.numel() > 0
    assert sk.graph_row_plan(g, "csc") is plan
    moved = g.to("cpu")
    m = moved.derived["k1_plan_csc"]
    assert isinstance(m, sk.RowPlan) and m is not plan
    for a, b in zip(m, plan):
        assert torch.equal(a, b)
    seg = sk.graph_segments(g, "nodes")
    assert torch.equal(seg.to("cpu").plan.singles, seg.plan.singles)
    # the route of gspmm on this graph, as the dispatch log names it
    x = torch.zeros(g.num_src_nodes, 10)
    assert sk.gspmm_sum_route(g, x) == "packed"
    assert sk.gspmm_sum_route(g, torch.zeros(g.num_src_nodes, 128)) == "rows"
    assert sk.gspmm_rows_route(g, torch.zeros(g.num_edges(), 10)) == "packed"
