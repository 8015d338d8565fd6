"""Masked (padded) graphs in the PyTorch port against the JAX package, on
a block whose edges are 35% padding, with dst rows whose edges are all
padding, rows with no edges at all and a hub row longer than K1's piece.

* gspmm copy_u, u_mul_e and copy_e with sum, mean, max and min, forward
  and gradients, against the JAX bare masked graph (its composed path)
  on tie-free data, and max/min with ties against the JAX graph prepared
  with ``prepare_spmm`` (its mask-aware Pallas plan, interpret mode),
  which gives every tied edge the full cotangent as K5 does;
* ``gat_attention`` (composed on the CPU) and ``gat_attention_fused``
  (K2/K3's plain versions over the real-edge view) with and without
  attn_w; ``gsddmm`` with every op over every edge; ``edge_softmax``;
* the real-edge view against a graph built on the host from the real
  edges;
* CUDA dispatch: a tensor that reports ``is_cuda`` shows that a masked
  graph reaches the K1, K4/K5, K2/K3 and K6 wrappers with the view's
  arrays (K6 with the masked graph's own), and that nothing plain runs.

Tolerances (max abs error / max |reference|): forwards 1e-5 and
gradients 1e-5 against the composed JAX path (float32 sums in another
order); 1e-4 against the prepared JAX graph and for the GAT operators
(the Pallas f32x2 split; exp and softmax).  Gradients at padded edges and
outputs of all-padding rows are held to be exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.gat import gat_attention as jgat_attention

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
from dgl_hack_tpu_torch.ops.cuda import sddmm_kernel as k6
from dgl_hack_tpu_torch.ops.cuda import segment_max_kernel as smk
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk

torch.set_num_threads(2)

TOL, KERNEL_TOL = 1e-5, 1e-4
NS, ND, F = 500, 60, 6
PAD_ROWS = (0, 1, 2)          # every in-edge masked
EMPTY_FROM = 55               # rows 55.. have no in-edges at all
HUB = 5                       # ~290 real in-edges, over K1_PIECE


@pytest.fixture(autouse=True)
def _precise(monkeypatch):
    """The JAX Pallas paths at full f32 precision."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _edges(seed=0):
    """About 1,100 distinct (src, dst) pairs in shuffled order (no two
    edges carry the same message, so a max has no ties unless the data
    tie), 450 of them into the hub, and a mask."""
    rng = np.random.default_rng(seed)
    hub = rng.choice(NS, 450, replace=False) * EMPTY_FROM + HUB
    pair = np.unique(np.concatenate([hub, rng.choice(NS * EMPTY_FROM, 650)]))
    pair = rng.permutation(pair)
    src, dst = pair // EMPTY_FROM, pair % EMPTY_FROM
    mask = rng.random(len(pair)) > 0.35
    mask[np.isin(dst, PAD_ROWS)] = False
    return src, dst, mask


def _blocks(seed=0):
    src, dst, mask = _edges(seed)
    gj = dgl.block((src, dst), NS, ND, edge_mask=mask)
    gt = dt.block((src, dst), NS, ND, edge_mask=mask)
    return gj, gt


def _operand(rng, g, target, shape, ties=False):
    n = {"u": g.num_src_nodes, "v": g.num_dst_nodes, "e": g.num_edges()}
    size = (n[target],) + tuple(shape)
    if ties:
        return rng.integers(-3, 4, size).astype(np.float32)
    return rng.normal(size=size).astype(np.float32)


def _padded(gt):
    return ~gt.edge_mask.numpy()


# ---------------------------------------------------------------------------
# the real-edge view
# ---------------------------------------------------------------------------
def test_real_edge_view_matches_host_build():
    src, dst, mask = _edges(1)
    gt = dt.block((src, dst), NS, ND, edge_mask=mask)
    view = sk.real_edges(gt)
    ref = dt.block((src[mask], dst[mask]), NS, ND)
    for name in ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids"):
        got = getattr(view.graph, name)
        assert got.dtype == torch.int32, name
        assert torch.equal(got, getattr(ref, name)), name
    assert view.graph.edge_mask is None
    np.testing.assert_array_equal(view.eid.numpy(),
                                  np.nonzero(gt.edge_mask.numpy())[0])
    assert sk.real_edges(gt) is view                   # cached
    moved = gt.to("cpu")
    assert torch.equal(moved.derived["real_edges"].eid, view.eid)
    assert sk.real_in_degrees(gt).tolist() == ref.in_degrees().tolist()
    assert gt.in_degrees().tolist() != ref.in_degrees().tolist()


@pytest.mark.parametrize("reducer", ["sum", "mean", "max"])
def test_real_edge_view_without_padding_shares_the_arrays(reducer):
    """A mask with no padding gives a view over the masked graph's own
    arrays and no gather; gspmm and its gradients equal the unmasked
    graph's."""
    src, dst, _ = _edges(8)
    gt = dt.block((src, dst), NS, ND, edge_mask=np.ones(len(src), bool))
    bare = dt.block((src, dst), NS, ND)
    view = sk.real_edges(gt)
    assert view.eid is None and view.graph.edge_mask is None
    for name in ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids"):
        assert getattr(view.graph, name) is getattr(gt, name), name
    assert gt.to("cpu").derived["real_edges"].eid is None
    rng = np.random.default_rng(9)
    x = _operand(rng, gt, "u", (F,))
    w = _operand(rng, gt, "e", (1,))
    outs = []
    for g in (gt, bare):
        ins = [torch.tensor(a, requires_grad=True) for a in (x, w)]
        out = dt.gspmm(g, "mul", reducer, *ins)
        outs.append([out.detach(), *torch.autograd.grad(
            (out * torch.arange(F)).sum(), ins)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_prepare_spmm_builds_the_views_plans():
    _, gt = _blocks(2)
    out = dt.prepare_spmm(gt)
    kg = out.derived["real_edges"].graph
    assert {"k1_plan_csc", "k1_plan_csr", "dst_csr"} <= set(kg.derived)
    assert kg.derived["k1_plan_csc"].long_rows.tolist() == [HUB]


# ---------------------------------------------------------------------------
# gspmm
# ---------------------------------------------------------------------------
def _gspmm_both(gj, gt, op, reducer, lhs, rhs, lt, rt, seed=7):
    """Forward and the gradients of sum(out * t) in both packages."""
    def fwd_j(a, b):
        return dgl.gspmm(gj, op, reducer, a, b, lt, rt)
    ja = None if lhs is None else jnp.asarray(lhs)
    jb = None if rhs is None else jnp.asarray(rhs)
    out_j = np.asarray(fwd_j(ja, jb))
    t = np.random.default_rng(seed).normal(size=out_j.shape).astype(
        np.float32)
    wrt = tuple(i for i, a in enumerate((ja, jb)) if a is not None)
    grads_j = jax.grad(lambda a, b: (fwd_j(a, b) * t).sum(), argnums=wrt)(
        ja, jb)
    ta = None if lhs is None else torch.tensor(lhs, requires_grad=True)
    tb = None if rhs is None else torch.tensor(rhs, requires_grad=True)
    out_t = dt.gspmm(gt, op, reducer, ta, tb, lt, rt)
    ins = [a for a in (ta, tb) if a is not None]
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(t)).sum(), ins)
    return out_t.detach().numpy(), out_j, [g.numpy() for g in grads_t], \
        [np.asarray(g) for g in grads_j]


GSPMM_CASES = [("copy_lhs", "u", "e", None), ("mul", "u", "e", (1,)),
               ("mul", "u", "e", (F,)), ("copy_rhs", "u", "e", (F,))]


@pytest.mark.parametrize("reducer", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("op,lt,rt,wshape", GSPMM_CASES)
def test_gspmm_masked_matches_jax(op, lt, rt, wshape, reducer):
    """Tie-free data against the JAX composed path; all-padding and empty
    rows give 0, and the edge operand's gradient is 0 at padded edges."""
    gj, gt = _blocks()
    rng = np.random.default_rng(3)
    lhs = None if op == "copy_rhs" else _operand(rng, gt, lt, (F,))
    rhs = None if wshape is None else _operand(rng, gt, rt, wshape)
    out, ref, grads, grads_j = _gspmm_both(gj, gt, op, reducer, lhs, rhs,
                                           lt, rt)
    assert_close(out, ref, TOL, "forward")
    for i, (a, b) in enumerate(zip(grads, grads_j)):
        assert_close(a, b, TOL, f"gradient {i}")
    assert float(np.abs(out[list(PAD_ROWS)]).max()) == 0.0
    assert float(np.abs(out[EMPTY_FROM:]).max()) == 0.0
    if rhs is not None:
        assert float(np.abs(grads[-1][_padded(gt)]).max()) == 0.0


@pytest.mark.parametrize("reducer", ["max", "min"])
@pytest.mark.parametrize("wshape", [None, (1,)])
def test_gspmm_masked_ties_match_prepared_jax(wshape, reducer):
    """Small integers tie in most rows: every tied real edge gets the full
    cotangent in both the port (K5's plain version over the view) and the
    JAX mask-aware Pallas plan; padded edges get nothing."""
    gj, gt = _blocks(4)
    gjp = dgl.prepare_spmm(gj, te=256, bc=8, wc=2)
    rng = np.random.default_rng(5)
    x = _operand(rng, gt, "u", (F,), ties=True)
    w = None if wshape is None else _operand(rng, gt, "e", wshape, True)
    op = "copy_lhs" if w is None else "mul"
    out, ref, grads, grads_j = _gspmm_both(gjp, gt, op, reducer, x, w,
                                           "u", "e")
    assert_close(out, ref, 0.0, "forward")
    for i, (a, b) in enumerate(zip(grads, grads_j)):
        assert_close(a, b, KERNEL_TOL, f"gradient {i}")
    if w is not None:
        assert float(np.abs(grads[1][_padded(gt)]).max()) == 0.0


def test_mean_divides_by_real_in_degree():
    _, gt = _blocks(6)
    x = torch.ones(NS, 2)
    out = dt.gspmm(gt, "copy_lhs", "mean", x)
    deg = sk.real_in_degrees(gt)
    np.testing.assert_array_equal(out[:, 0].numpy(), (deg > 0).float())
    out = sk.gspmm_sum(gt, x) / deg.clamp(min=1)[:, None]
    np.testing.assert_array_equal(out[:, 0].numpy(), (deg > 0).float())


# ---------------------------------------------------------------------------
# gat_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["composed", "shift", "exact"])
@pytest.mark.parametrize("with_w", [False, True])
def test_gat_attention_masked_matches_jax(path, with_w):
    """The composed path and K2/K3's plain versions over the real-edge
    view against the JAX composed path; attn_w's gradient is 0 at padded
    edges."""
    gj, gt = _blocks(8)
    rng = np.random.default_rng(9)
    H, D = 2, 3
    fsrc = _operand(rng, gt, "u", (H, D))
    el = _operand(rng, gt, "u", (H,))
    er = _operand(rng, gt, "v", (H,))
    w = rng.uniform(0.5, 2.0, (gt.num_edges(), H)).astype(np.float32) \
        if with_w else None
    ins = [fsrc, el, er] + ([w] if with_w else [])

    def fwd_j(*a):
        return jgat_attention(gj, a[0], a[1], a[2], 0.2,
                                 a[3] if with_w else None)
    ref = np.asarray(fwd_j(*map(jnp.asarray, ins)))
    t = rng.normal(size=ref.shape).astype(np.float32)
    grads_j = jax.grad(lambda *a: (fwd_j(*a) * t).sum(),
                       argnums=tuple(range(len(ins))))(
        *map(jnp.asarray, ins))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    tw = tins[3] if with_w else None
    if path == "composed":
        out = dt.gat_attention(gt, *tins[:3], 0.2, tw)
    else:
        out = gk.gat_attention_fused(gt, *tins[:3], 0.2, tw, softmax=path)
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), tins)
    assert_close(out.detach().numpy(), ref, KERNEL_TOL, "forward")
    for i, (a, b) in enumerate(zip(grads, grads_j)):
        assert_close(a.numpy(), np.asarray(b), KERNEL_TOL, f"gradient {i}")
    assert float(out.detach()[list(PAD_ROWS)].abs().max()) == 0.0
    if with_w:
        assert float(grads[3][torch.from_numpy(_padded(gt))].abs().max()) \
            == 0.0


# ---------------------------------------------------------------------------
# gsddmm and edge_softmax: every edge, the mask unread
# ---------------------------------------------------------------------------
SDDMM_CASES = [("add", "u", "v", (F,)), ("sub", "u", "v", (F,)),
               ("mul", "u", "v", (F,)), ("div", "u", "v", (F,)),
               ("dot", "u", "v", (F,)), ("dot", "u", "v", (2, 3)),
               ("copy_rhs", "u", "v", (F,)), ("add", "e", "v", (F,)),
               ("sub", "v", "u", (F,)), ("copy_lhs", "u", "e", (F,))]


@pytest.mark.parametrize("op,lt,rt,shape", SDDMM_CASES)
def test_gsddmm_masked_matches_jax(op, lt, rt, shape):
    gj, gt = _blocks(10)
    rng = np.random.default_rng(11)
    lhs = _operand(rng, gt, lt, shape)
    rhs = _operand(rng, gt, rt, shape)
    if op == "div":
        rhs = np.abs(rhs) + 0.5
    ins = [lhs, rhs]

    def fwd_j(a, b):
        return dgl.gsddmm(gj, op, a, b, lt, rt)
    ref = np.asarray(fwd_j(*map(jnp.asarray, ins)))
    t = rng.normal(size=ref.shape).astype(np.float32)
    grads_j = jax.grad(lambda a, b: (fwd_j(a, b) * t).sum(),
                       argnums=(0, 1))(*map(jnp.asarray, ins))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    out = dt.gsddmm(gt, op, *tins, lt, rt)
    (out * torch.from_numpy(t)).sum().backward()
    assert_close(out.detach().numpy(), ref, TOL, "forward")
    for a, b, name in zip(tins, grads_j, ("lhs", "rhs")):
        got = np.zeros_like(np.asarray(b)) if a.grad is None else \
            a.grad.numpy()
        assert_close(got, np.asarray(b), TOL, name)


@pytest.mark.parametrize("order", ["internal", "eid"])
def test_edge_softmax_masked_matches_jax(order):
    gj, gt = _blocks(12)
    rng = np.random.default_rng(13)
    logits = rng.normal(size=(gt.num_edges(), 2, 1)).astype(np.float32)
    ref = np.asarray(dgl.edge_softmax(gj, jnp.asarray(logits), order))
    out = dt.edge_softmax(gt, torch.from_numpy(logits), order)
    assert_close(out.numpy(), ref, TOL)
    pad = _padded(gt) if order == "internal" else \
        _padded(gt)[gt.user2int.numpy()]
    assert float(np.abs(out.numpy()[pad]).max()) == 0.0


# ---------------------------------------------------------------------------
# CUDA dispatch through a tensor that reports is_cuda
# ---------------------------------------------------------------------------
class _CudaTagged(torch.Tensor):
    """A CPU tensor that reports is_cuda, to drive the CUDA dispatch on a
    machine without a card."""

    @property
    def is_cuda(self):
        return True


def _untag(t):
    return None if t is None else t.as_subclass(torch.Tensor)


def _tagged(a):
    return torch.from_numpy(a).as_subclass(_CudaTagged).requires_grad_()


def _no_plain():
    return not [k for k in sk.LAUNCHES.counts if k.startswith("plain.")]


@pytest.fixture
def k1_calls(monkeypatch):
    """Each K1 wrapper call, as (site, indptr), run on untagged tensors."""
    calls = []
    real = sk.segment_sum

    def k1(indptr, x, gidx=None, eid=None, w=None, *, site="fwd",
           plan=None):
        calls.append((site, indptr))
        return real(indptr, _untag(x), gidx, eid, _untag(w), site=site,
                    plan=plan)
    for mod in (sk, gk, k6):
        monkeypatch.setattr(mod, "segment_sum", k1)
    sk.LAUNCHES.reset()
    return calls


@pytest.mark.parametrize("op,reducer", [("copy_lhs", "sum"),
                                        ("mul", "mean"),
                                        ("copy_rhs", "sum")])
def test_masked_gspmm_reaches_k1_on_cuda(k1_calls, op, reducer):
    gj, gt = _blocks(14)
    rng = np.random.default_rng(15)
    x = _operand(rng, gt, "u", (F,))
    w = _operand(rng, gt, "e", (1,) if op == "mul" else (F,))
    lhs = None if op == "copy_rhs" else x
    rhs = None if op == "copy_lhs" else w
    ref = dt.gspmm(gt, op, reducer, *[None if a is None else
                                      torch.from_numpy(a)
                                      for a in (lhs, rhs)])
    ins = [None if a is None else _tagged(a) for a in (lhs, rhs)]
    out = dt.gspmm(gt, op, reducer, *ins)
    out.sum().backward()
    view = sk.real_edges(gt).graph
    assert k1_calls and all(ip is view.csc_indptr or ip is view.csr_indptr
                            for _, ip in k1_calls), k1_calls
    assert k1_calls[0][1] is view.csc_indptr
    assert _no_plain(), sk.LAUNCHES.counts
    assert_close(_untag(out).detach().numpy(), ref.numpy(), TOL)
    if rhs is not None:
        assert float(_untag(ins[1].grad)[
            torch.from_numpy(_padded(gt))].abs().max()) == 0.0


@pytest.mark.parametrize("reducer", ["max", "min"])
def test_masked_gspmm_reaches_k4_k5_on_cuda(monkeypatch, reducer):
    calls = []
    real_fwd, real_bwd = smk.segment_max, smk.segment_max_bwd

    def k4(indptr, x, gidx, w=None, **kw):
        calls.append(("k4", indptr))
        return real_fwd(indptr, _untag(x), gidx, _untag(w), **kw)

    def k5(csr_indptr, dst_csr, csr_eids, x, w, raw, g, want_dw=True,
           **kw):
        calls.append(("k5", csr_indptr))
        return real_bwd(csr_indptr, dst_csr, csr_eids, _untag(x), _untag(w),
                        _untag(raw), _untag(g), want_dw, **kw)
    monkeypatch.setattr(smk, "segment_max", k4)
    monkeypatch.setattr(smk, "segment_max_bwd", k5)
    _, gt = _blocks(16)
    rng = np.random.default_rng(17)
    x, w = _operand(rng, gt, "u", (F,)), _operand(rng, gt, "e", (1,))
    ref = dt.gspmm(gt, "mul", reducer, torch.from_numpy(x),
                   torch.from_numpy(w))
    calls.clear()
    sk.LAUNCHES.reset()
    tw = _tagged(w)
    out = dt.gspmm(gt, "mul", reducer, _tagged(x), tw)
    out.sum().backward()
    view = sk.real_edges(gt).graph
    assert calls == [("k4", view.csc_indptr), ("k5", view.csr_indptr)]
    assert _no_plain(), sk.LAUNCHES.counts
    assert_close(_untag(out).detach().numpy(), ref.numpy(), 0.0)
    assert float(_untag(tw.grad)[torch.from_numpy(_padded(gt))]
                 .abs().max()) == 0.0


def test_masked_gat_reaches_k2_k3_on_cuda(monkeypatch, k1_calls):
    calls = []
    real_fwd, real_bwd = gk.gat_fwd, gk.gat_bwd

    def k2(indptr, src, wh, el, er, w, shift, slope, exact, **kw):
        calls.append(("k2", indptr, src))
        return real_fwd(indptr, src, _untag(wh), _untag(el), _untag(er),
                        _untag(w), _untag(shift), slope, exact, **kw)

    def k3(csr_indptr, *args, **kw):
        calls.append(("k3", csr_indptr, None))
        return real_bwd(csr_indptr, *[_untag(a) if isinstance(a, torch.Tensor)
                                      else a for a in args], **kw)
    monkeypatch.setattr(gk, "gat_fwd", k2)
    monkeypatch.setattr(gk, "gat_bwd", k3)
    _, gt = _blocks(18)
    rng = np.random.default_rng(19)
    H, D = 2, 4
    ins = [_operand(rng, gt, "u", (H, D)), _operand(rng, gt, "u", (H,)),
           _operand(rng, gt, "v", (H,)),
           rng.uniform(0.5, 2.0, (gt.num_edges(), H)).astype(np.float32)]
    ref = dt.gat_attention(gt, *map(torch.from_numpy, ins[:3]), 0.2,
                           torch.from_numpy(ins[3]))
    tins = [_tagged(a) for a in ins]
    out = dt.gat_attention(gt, *tins[:3], 0.2, tins[3])
    out.sum().backward()
    view = sk.real_edges(gt).graph
    assert [c[0] for c in calls] == ["k2", "k3"]
    assert calls[0][1] is view.csc_indptr and calls[0][2] is view.src
    assert calls[1][1] is view.csr_indptr
    assert [site for site, _ in k1_calls] == ["edge"]
    assert k1_calls[0][1] is view.csc_indptr
    assert _no_plain(), sk.LAUNCHES.counts
    assert_close(_untag(out).detach().numpy(), ref.detach().numpy(),
                 KERNEL_TOL)
    assert float(_untag(tins[3].grad)[torch.from_numpy(_padded(gt))]
                 .abs().max()) == 0.0


def test_masked_gsddmm_reaches_k6_over_every_edge(monkeypatch, k1_calls):
    calls = []
    real = k6.sddmm

    def rec(op_, dst, rhs, lhs=None, src=None, dot_d=0, *, site="fwd"):
        calls.append((op_, site, dst))
        return real(op_, dst, _untag(rhs), _untag(lhs), src, dot_d,
                    site=site)
    monkeypatch.setattr(k6, "sddmm", rec)
    _, gt = _blocks(20)
    rng = np.random.default_rng(21)
    x, y = _operand(rng, gt, "u", (2, 4)), _operand(rng, gt, "v", (2, 4))
    ref = dt.gsddmm(gt, "dot", torch.from_numpy(x), torch.from_numpy(y))
    out = dt.gsddmm(gt, "dot", _tagged(x), _tagged(y))
    out.sum().backward()
    assert calls[0] == ("dot", "fwd", gt.dst), calls
    assert all(ip is gt.csc_indptr or ip is gt.csr_indptr
               for _, ip in k1_calls), k1_calls
    assert out.shape == (gt.num_edges(), 2, 1)
    assert _no_plain(), sk.LAUNCHES.counts
    assert_close(_untag(out).detach().numpy(), ref.numpy(), 0.0)
