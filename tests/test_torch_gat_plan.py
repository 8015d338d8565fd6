"""K2 and K3 through the row plan: long rows cut into pieces.

The CUDA kernels sum each piece of a long row in its own warp (K2: the
CSC plan, partial num and den; K3: the CSR plan, partial dWh and del),
write the partials to scratch and add a long row's partials in piece
order; K3 writes each edge's draw and dw from the piece that owns it.
'exact' mode takes each dst row's max first (K4 over el, then
``exact_shift``), so K2's pieces all subtract the row's max and the
fix-up only adds.  Here, on the CPU,
plain versions that follow the plan the same way

* agree with ``gat_fwd_plain`` and ``gat_bwd_plain``, all in float64,
  within 1e-5 of max|ref|, in both softmax modes, at (H, D) in {(8, 8),
  (1, 7), (1, 41)}, with the hub as a dst row (K2's pieces) and as a src
  row (K3's), with and without attn_w, with rows of exactly T and T + 1
  edges and empty rows, in a large-spread 'exact' case and at H = 2,
  D = 3,100, wider than the first K3's shared-memory limit;
* through ``gat_attention_fused`` and its gradients, with pieces of 16
  edges, agree with the JAX fused op on a
  ``prepare_spmm``'d graph (Pallas in interpret mode,
  ``DGL_TPU_SPMM_MODE=highest``) within 1e-4, as ``test_torch_gat.py``
  holds the unplanned plain versions;
* ``GatFused`` hands K2 the CSC plan and K3 the CSR plan cached on the
  graph, and the load-width rule picks what the kernels' notes say.

Inputs are made from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.gat import gat_attention as jax_gat

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as smk
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk
from test_torch_segment_max_plan import (_combine_pieces, _degrees, _edges,
                                         _piece_edges, _split, assert_close)

torch.set_num_threads(2)

PLAN_TOL = 1e-5
PALLAS_TOL = 1e-4
T = sk.K1_PIECE
SLOPE = 0.2


def _rows_of(indptr):
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(deg.numel()), deg)


def _fwd_sums(u, v, e, n, wh, el, er, w, shift, H, D):
    """K2's sums before the divide over edges (u -> row v), edge ids e
    (CSC positions): num (n, H*D) and den (n, H)."""
    p = torch.exp(F.leaky_relu(el[u] + er[v], SLOPE) - shift[v])
    pw = p * w[e] if w is not None else p
    num = wh.new_zeros((n, H, D)).index_add(
        0, v, pw[:, :, None] * wh.view(-1, H, D)[u])
    return num.reshape(n, H * D), p.new_zeros((n, H)).index_add(0, v, p)


def planned_fwd(indptr, src, wh, el, er, w, shift, slope, exact, plan):
    """K2 as the kernel orders it: a row of at most T edges summed whole, a long row as its pieces' partial num and den
    added in piece order; then rst = num / den (0 where den is 0).  In
    'exact' mode the shift is K4's max of el made into the row's max
    (``exact_shift``) first."""
    assert slope == SLOPE
    if exact:
        shift = gk.exact_shift(smk.segment_max_plain(indptr, el, src), er,
                               slope)
    N, H = er.shape
    D = wh.shape[1] // H
    rows = _rows_of(indptr)
    j_all = torch.arange(src.numel())
    P = plan.pieces.shape[0]
    if P:
        piece_ip, j = _piece_edges(plan)
        prow = plan.piece_row.long()
    num, den = _fwd_sums(src.long(), rows, j_all, N, wh, el, er, w, shift,
                         H, D)
    if P:
        pnum, pden = _fwd_sums(src.long()[j], _rows_of(piece_ip), j, P, wh,
                               el, er[prow], w, shift[prow], H, D)
        long_rows = plan.long_rows.long()
        num[long_rows] = _combine_pieces(plan, pnum, torch.add, 0.0)
        den[long_rows] = _combine_pieces(plan, pden, torch.add, 0.0)
    dsafe = torch.where(den > 0, den, torch.ones_like(den))
    rst = torch.where((den > 0).repeat_interleave(D, 1),
                      (num.view(N, H, D) / dsafe[:, :, None]).reshape(N, H * D),
                      torch.zeros_like(num))
    return rst, den, shift


def _bwd_terms(u, v, e, wh, el, er, shift, den, sds, dout, w, H, D):
    """K3's per-edge terms over edges (u -> v): draw, dw, and the dWh
    message aw * dout[v]."""
    raw = el[u] + er[v]
    dv = den[v]
    a = torch.exp(torch.clamp(F.leaky_relu(raw, SLOPE) - shift[v], max=60.0))
    a = a / torch.where(dv > 0, dv, torch.ones_like(dv))
    do_v = dout.view(-1, H, D)[v]
    daw = (wh.view(-1, H, D)[u] * do_v).sum(-1)
    wv = w[e] if w is not None else torch.ones_like(a)
    draw = a * (daw * wv - sds[v]) * torch.where(
        raw >= 0, torch.ones_like(raw), torch.full_like(raw, SLOPE))
    return draw, a * daw, ((a * wv)[:, :, None] * do_v).flatten(1)


def planned_bwd(csr_indptr, csr_eids, dst_csr, wh, el, er, shift, den, sds,
                dout, w, slope, want_dw, plan):
    """K3 as the kernel orders it: a src row of at most T edges summed whole, a long row as its pieces' partial dWh and
    del added in piece order; draw and dw per edge at its internal id."""
    assert slope == SLOPE
    Ns, HD = wh.shape
    H = el.shape[1]
    D = HD // H
    E = csr_eids.numel()
    u, v, e = _rows_of(csr_indptr), dst_csr.long(), csr_eids.long()
    P = plan.pieces.shape[0]
    dr, dws, msg = _bwd_terms(u, v, e, wh, el, er, shift, den, sds, dout, w,
                              H, D)
    dwh = wh.new_zeros((Ns, HD)).index_add(0, u, msg)
    del_ = el.new_zeros((Ns, H)).index_add(0, u, dr)
    if P:
        piece_ip, j = _piece_edges(plan)
        pe = _rows_of(piece_ip)
        long_rows = plan.long_rows.long()
        dwh[long_rows] = _combine_pieces(
            plan, wh.new_zeros((P, HD)).index_add(0, pe, msg[j]), torch.add,
            0.0)
        del_[long_rows] = _combine_pieces(
            plan, el.new_zeros((P, H)).index_add(0, pe, dr[j]), torch.add,
            0.0)
    draw = el.new_empty((E, H))
    draw[e] = dr
    dw = None
    if w is not None and want_dw:
        dw = el.new_empty((E, H))
        dw[e] = dws
    return dwh, del_, draw, dw


def _graph(hub, piece, hub_pieces=101, num_nodes=64, seed=0):
    return dt.graph(*_split(_edges(_degrees(piece, hub_pieces, num_nodes,
                                            seed), hub, seed=seed + 1)))


def _inputs(rng, g, H, D, with_w=True, scale=1.0, dtype=np.float64):
    N, E = g.num_src_nodes, g.num_edges()

    def t(shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(dtype))
    w = torch.from_numpy(((rng.random((E, H)) > 0.3) / 0.7).astype(dtype)) \
        if with_w else None
    return (t((N, H * D)), t((N, H), scale), t((N, H), scale), w,
            t((N, H * D)))


def _check_vs_plain(g, H, D, exact, with_w, piece, rng, scale=1.0):
    wh, el, er, w, dout = _inputs(rng, g, H, D, with_w, scale)
    shift = None if exact else gk.shift_bound(el, er, SLOPE)
    p_fwd = sk.row_plan(g.csc_indptr, piece)
    p_rev = sk.row_plan(g.csr_indptr, piece)
    fwd = (g.csc_indptr, g.src, wh, el, er, w, shift, SLOPE, exact)
    ref = gk.gat_fwd_plain(*fwd)
    out = planned_fwd(*fwd, p_fwd)
    for name, a, r in zip(("rst", "den", "shift"), out, ref):
        assert_close(a.numpy(), r.numpy(), PLAN_TOL, name)
    rst, den, sh = ref
    sds = (rst.view(-1, H, D) * dout.view(-1, H, D)).sum(-1)
    bwd = (g.csr_indptr, g.csr_eids, sk.rev_gidx(g), wh, el, er, sh, den,
           sds, dout, w, SLOPE)
    refs = gk.gat_bwd_plain(*bwd)
    outs = planned_bwd(*bwd, True, p_rev)
    for name, a, r in zip(("dwh", "del", "draw", "dw"), outs, refs):
        assert (a is None) == (r is None), name
        if r is not None:
            assert_close(a.numpy(), r.numpy(), PLAN_TOL, name)
    return p_fwd, p_rev


@pytest.mark.parametrize("with_w", [True, False])
@pytest.mark.parametrize("hub", ["dst", "src"])
@pytest.mark.parametrize("H,D", [(8, 8), (1, 7), (1, 41)])
@pytest.mark.parametrize("mode", ["shift", "exact"])
def test_planned_matches_plain(mode, H, D, hub, with_w):
    """Pieces of T = 256 edges, the hub over 101 of them (K2's when it is
    a dst row, K3's when it is a src row), rows of T and T + 1 edges and
    empty rows."""
    g = _graph(hub, T, seed=H + D)
    rng = np.random.default_rng(H * 100 + D)
    p_fwd, p_rev = _check_vs_plain(g, H, D, mode == "exact", with_w, T, rng)
    long_plan = p_fwd if hub == "dst" else p_rev
    assert long_plan.long_rows.tolist() == [1, 4, 6]    # row 3 has T edges
    assert long_plan.piece_row.tolist() == [1] * 101 + [4] * 2 + [6] * 4


def test_planned_large_spread_exact():
    """Logits spread over more than 100 (el, er scaled by 60): 'exact'
    takes each row's true max before the pieces' sums, so no piece's
    partials underflow where the plain version keeps them."""
    g = _graph("dst", 16, seed=5)
    rng = np.random.default_rng(5)
    _check_vs_plain(g, 8, 8, True, True, 16, rng, scale=60.0)


@pytest.mark.parametrize("hub", ["dst", "src"])
def test_planned_wider_than_old_limit(hub):
    """H = 2, D = 3,100: H*D + H = 6,202 > 6,144, where the first K3 ran
    out of shared memory."""
    g = _graph(hub, 16, hub_pieces=6, num_nodes=24, seed=6)
    rng = np.random.default_rng(6)
    p_fwd, p_rev = _check_vs_plain(g, 2, 3100, False, True, 16, rng)
    assert (p_fwd if hub == "dst" else p_rev).pieces.shape[0] > 6


def _through_planned(monkeypatch, piece, seen):
    """Route GatFused through the planned versions, with pieces of
    ``piece`` edges."""
    def fwd(indptr, src, wh, el, er, w, shift, slope, exact, *, plan=None):
        assert isinstance(plan, sk.RowPlan)          # the cached plan
        seen["fwd"] = plan
        return planned_fwd(indptr, src, wh, el, er, w, shift, slope, exact,
                           sk.row_plan(indptr, piece))

    def bwd(*args, plan=None):
        assert isinstance(plan, sk.RowPlan)
        seen["bwd"] = plan
        return planned_bwd(*args, sk.row_plan(args[0], piece))
    monkeypatch.setattr(gk, "gat_fwd", fwd)
    monkeypatch.setattr(gk, "gat_bwd", bwd)


def _hub_graphs(hub_pieces=101, num_nodes=48, seed=3):
    """A dst hub and a src hub, each over ``hub_pieces`` pieces of 16
    edges, rows of 16 and 17 edges and empty rows, as one graph."""
    deg = _degrees(16, hub_pieces, num_nodes, seed)
    src, dst, n = _edges(deg, "dst", seed=seed + 1)
    src2, dst2, _ = _edges(deg, "src", seed=seed + 2)
    src, dst = np.concatenate([src, src2]), np.concatenate([dst, dst2])
    g = dt.graph((src, dst), num_nodes=n)
    for d in ("csc", "csr"):
        assert sk.row_plan(getattr(g, f"{d}_indptr"), 16).pieces.shape[0] \
            > hub_pieces
    gj = dgl.prepare_spmm(dgl.graph((src, dst), num_nodes=n), te=256, bc=8,
                          wc=2)
    return gj, g


def _jax_run(g, fsrc, el, er, w, t):
    args = [jnp.asarray(a) for a in (fsrc, el, er)]
    if w is not None:
        args.append(jnp.asarray(w))

    def loss(*a):
        out = jax_gat(g, a[0], a[1], a[2], SLOPE, a[3] if len(a) > 3
                      else None)
        return (out * t).sum(), out
    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(
        range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_run(g, mode, fsrc, el, er, w, t):
    ins = [torch.tensor(a, requires_grad=True) for a in (fsrc, el, er)]
    if w is not None:
        ins.append(torch.tensor(w, requires_grad=True))
    out = gk.gat_attention_fused(g, *ins[:3], SLOPE,
                                 ins[3] if w is not None else None,
                                 softmax=mode)
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), ins)
    return out.detach().numpy(), [x.numpy() for x in grads]


def _vs_jax(monkeypatch, mode, H, D, with_w=True, scale=1.0, seed=7,
            hub_pieces=101):
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", mode)
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    seen = {}
    _through_planned(monkeypatch, 16, seen)
    gj, g = _hub_graphs(hub_pieces, 48 if hub_pieces > 100 else 24)
    rng = np.random.default_rng(seed)
    N, E = g.num_src_nodes, g.num_edges()
    fsrc = rng.normal(size=(N, H, D)).astype(np.float32)
    el = (scale * rng.normal(size=(N, H))).astype(np.float32)
    er = (scale * rng.normal(size=(N, H))).astype(np.float32)
    w = ((rng.random((E, H)) > 0.3) / 0.7).astype(np.float32) \
        if with_w else None
    t = rng.normal(size=(N, H, D)).astype(np.float32)
    rj = _jax_run(gj, fsrc, el, er, w, t)
    rt = _port_run(g, mode, fsrc, el, er, w, t)
    assert set(seen) == {"fwd", "bwd"}
    return rj, rt


@pytest.mark.parametrize("H,D", [(8, 8), (1, 7), (1, 41)])
@pytest.mark.parametrize("mode", ["shift", "exact"])
def test_planned_fused_vs_jax_prepared(monkeypatch, mode, H, D):
    """gat_attention_fused through the planned versions (pieces of 16
    edges) and its gradients against the JAX
    fused op."""
    rj, rt = _vs_jax(monkeypatch, mode, H, D)
    assert_close(rt[0], rj[0], PALLAS_TOL, "forward")
    for name, a, b in zip(("dfsrc", "del", "der", "dattn_w"), rt[1], rj[1]):
        assert_close(a, b, PALLAS_TOL, name)


def test_planned_fused_vs_jax_without_attn_w(monkeypatch):
    rj, rt = _vs_jax(monkeypatch, "shift", 2, 16, with_w=False)
    assert_close(rt[0], rj[0], PALLAS_TOL, "forward")
    for name, a, b in zip(("dfsrc", "del", "der"), rt[1], rj[1]):
        assert_close(a, b, PALLAS_TOL, name)


def test_planned_fused_vs_jax_large_spread(monkeypatch):
    """'exact' at a logit spread over 100 across pieces; the logit grads
    are held to 1e-4 of the term scale max|dattn_w|, as in
    test_torch_gat.py."""
    rj, rt = _vs_jax(monkeypatch, "exact", 2, 8, scale=60.0, seed=8)
    assert np.isfinite(rt[0]).all()
    assert_close(rt[0], rj[0], PALLAS_TOL, "forward")
    assert_close(rt[1][0], rj[1][0], PALLAS_TOL, "dfsrc")
    assert_close(rt[1][3], rj[1][3], PALLAS_TOL, "dattn_w")
    term = float(np.abs(rj[1][3]).max())
    for name, i in (("del", 1), ("der", 2)):
        err = float(np.abs(rt[1][i] - rj[1][i]).max())
        assert err <= PALLAS_TOL * term, f"{name}: {err} vs {term}"


def test_planned_fused_vs_jax_wide(monkeypatch):
    """H = 2, D = 3,100, wider than the first K3 took (the JAX package runs
    its composed path at this width)."""
    rj, rt = _vs_jax(monkeypatch, "shift", 2, 3100, seed=9, hub_pieces=6)
    assert_close(rt[0], rj[0], PALLAS_TOL, "forward")
    for name, a, b in zip(("dfsrc", "del", "der", "dattn_w"), rt[1], rj[1]):
        assert_close(a, b, PALLAS_TOL, name)


def test_gat_fused_passes_cached_plans(monkeypatch):
    """GatFused hands K2 the CSC plan and K3 the CSR plan cached on the
    graph (the wrappers take ``plan=`` on the CPU too), and asks K3 for dw
    only when attn_w needs a gradient."""
    g = sk.prepare_spmm(_graph("dst", T, hub_pieces=3))
    seen = {}
    real_fwd, real_bwd = gk.gat_fwd, gk.gat_bwd

    def fwd(*a, plan=None):
        seen["fwd"] = plan
        return real_fwd(*a, plan=plan)

    def bwd(*a, plan=None):
        seen["bwd"], seen["want_dw"] = plan, a[12]
        return real_bwd(*a, plan=plan)
    monkeypatch.setattr(gk, "gat_fwd", fwd)
    monkeypatch.setattr(gk, "gat_bwd", bwd)
    H, D = 2, 16
    fsrc = torch.randn(g.num_src_nodes, H, D, requires_grad=True)
    el = torch.randn(g.num_src_nodes, H, requires_grad=True)
    er = torch.randn(g.num_dst_nodes, H, requires_grad=True)
    gk.gat_attention_fused(g, fsrc, el, er).sum().backward()
    assert seen["fwd"] is g.derived["k1_plan_csc"]
    assert seen["bwd"] is g.derived["k1_plan_csr"]
    assert fsrc.grad.shape == fsrc.shape and el.grad.shape == el.shape
    # K3 writes dw only where attn_w wants a gradient (dropout does not)
    w = torch.ones(g.num_edges(), H)
    for grad in (False, True):
        w.requires_grad_(grad)
        gk.gat_attention_fused(g, fsrc, el, er, 0.2, w).sum().backward()
        assert seen["want_dw"] is grad and (w.grad is not None) == grad


def test_load_width_and_lane_rules():
    """The load width over the head width D (a lane's columns lie in one
    head) and every row tensor's alignment; each kernel's lane budget is a
    power of two the C entry takes (V to 8 floats)."""
    buf = torch.zeros(4 * 64 + 8)
    al = buf[:4 * 64].view(4, 64)
    assert sk.vector_width(8, al, al) == 4                # H = 8, D = 8
    assert sk.vector_width(8, al, buf[2:4 * 64 + 2].view(4, 64)) == 2
    assert sk.vector_width(41, buf[:41].view(1, 41)) == 1
    assert sk.vector_width(7, buf[:28].view(4, 7)) == 1
    assert sk.vector_width(3100, buf[:0].view(0, 3100)) == 4
    for lf in (gk.K2_LANE_FLOATS, gk.K3_LANE_FLOATS):
        assert lf in (4, 8)


def test_exact_shift_is_the_row_max():
    """leaky(max_u el[u] + er[v]) equals max_u leaky(el[u] + er[v]) bit for
    bit (leaky and the rounded add are monotone), and an empty row's
    shift is -1e30, as the first K2 wrote it."""
    g = _graph("dst", 16, hub_pieces=4, num_nodes=32, seed=10)
    rng = np.random.default_rng(10)
    el = torch.from_numpy((30 * rng.normal(size=(32, 3))).astype(np.float32))
    er = torch.from_numpy((30 * rng.normal(size=(32, 3))).astype(np.float32))
    rows = _rows_of(g.csc_indptr)
    logit = F.leaky_relu(el[g.src.long()] + er[rows], SLOPE)
    ref = torch.full((32, 3), gk.NEG).scatter_reduce(
        0, rows[:, None].expand_as(logit), logit, "amax")
    got = gk.exact_shift(smk.segment_max_plain(g.csc_indptr, el, g.src), er,
                         SLOPE)
    assert torch.equal(got, ref)
    assert bool((got[0] == gk.NEG).all())                # row 0 is empty
