"""K2 and K3's staged route over a bf16 Wh (``csrc/stage.cuh``): what of it
runs on the CPU.

The staged kernels run only on the card (``chip_smoke.py``'s
``bf16_attention`` and ``bf16_attention_reddit`` phases hold them to their
plain versions there).  Here:

* the padded copy (``pad_heads`` at ``padded_head_width``): zero in its pad
  columns, the caller's tensor untouched; the plain versions of K2 and K3
  over padded copies of Wh and dout, sliced back to D columns a head,
  equal the plain versions over the originals bit for bit.  The inputs are
  bf16 values and the plain versions run in float64, as ``chip_smoke.py``
  runs its references: every product of two bf16 values and every sum of
  such products here is exact in float64, so the zero columns change no
  bit whatever order torch sums in;
* the bf16-dout rule (``bf16_dout``): K3 may gather dout in bf16 where
  fsrc is bf16, packed or not, and never beside a float32 fsrc; on a small
  graph the float32 dout that reaches ``GatFused.backward`` under a bf16
  fsrc equals its own bf16 rounding bit for bit;
* the route rule (``gat_route``) and the shape of the staged walk
  (``stage_shape``, ``head_layout``) as pure functions at H * D in 8 * 8,
  1 * 41, 4 * 16 and 8 * 1, and where the ring must shrink to fit shared
  memory or the heads take more than one pass; the staged K3's passes
  over ranges of dst nodes (``k3_passes``, ``dst_cuts``);
* ``dt.gat_attention`` with bf16 operands at H = 1, D = 41 (an odd head
  width: the staged route's padded case) on the CPU against the JAX
  package's prepared graph (Pallas in interpret mode at full precision),
  within one bf16 ulp plus ``PALLAS_TOL`` of max|ref|, the rule of
  ``tests/test_torch_bf16_attention.py``.

Inputs are made from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu.ops.gat import gat_attention as jax_gat

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.ops.cuda import gat_kernel as gk
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel as sk

torch.set_num_threads(2)

PALLAS_TOL = 1e-4
N, E = 200, 1500
SHAPES = ((8, 8), (1, 41), (4, 16), (8, 1))


def _bf16_values(rng, shape):
    """Standard normal values rounded to bf16, as float64."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(torch.bfloat16).double()


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    return dt.graph((rng.integers(0, N, E), rng.integers(0, N, E)),
                    num_nodes=N)


# ---------------------------------------------------------------------------
# The padded copy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,D,Dp", [(8, 8, 8), (1, 41, 48), (4, 16, 16),
                                    (8, 1, 1), (3, 5, 8), (2, 7, 8),
                                    (4, 3, 4), (1, 7, 8)])
def test_padded_head_width(H, D, Dp):
    """Dp >= D, each head padded alike, a row of H heads whole 16-byte
    pieces of bf16 (8 | H * Dp), and no wider than that needs."""
    assert gk.padded_head_width(H, D) == Dp
    assert Dp >= D and (H * Dp) % 8 == 0
    assert all((H * d) % 8 for d in range(D, Dp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_heads_zero_pad(dtype):
    """The copy holds each head's D values, then zeros to Dp; in the asked
    dtype; the caller's tensor is not changed."""
    rng = np.random.default_rng(1)
    H, D, Dp = 2, 7, 8
    x = torch.from_numpy(rng.normal(size=(5, H * D)).astype(np.float32))
    keep = x.clone()
    p = gk.pad_heads(x, H, D, Dp, dtype)
    assert p.shape == (5, H * Dp) and p.dtype == dtype
    p3 = p.view(5, H, Dp)
    assert bool((p3[:, :, D:] == 0).all())
    assert torch.equal(p3[:, :, :D], x.view(5, H, D).to(dtype))
    assert torch.equal(x, keep)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("H,D", [(1, 41), (3, 5), (2, 7)])
def test_plain_over_padded_copy_is_bitwise(H, D, exact):
    """K2 and K3's plain versions over padded copies of Wh and dout, sliced
    back to D columns a head, equal them over the originals bit for bit:
    rst and den; dWh, del, draw and dw."""
    g = _graph(2)
    rng = np.random.default_rng(3)
    Dp = gk.padded_head_width(H, D)
    wh = _bf16_values(rng, (N, H * D)).to(torch.bfloat16)
    el, er = _bf16_values(rng, (N, H)), _bf16_values(rng, (N, H))
    w = torch.from_numpy((rng.random((E, H)) > 0.3) / 0.5)
    dout = _bf16_values(rng, (N, H * D))
    shift = None if exact else gk.shift_bound(el, er, 0.2)
    whp = gk.pad_heads(wh, H, D, Dp)
    ref = gk.gat_fwd_plain(g.csc_indptr, g.src, wh, el, er, w, shift, 0.2,
                           exact)
    pad = gk.gat_fwd_plain(g.csc_indptr, g.src, whp, el, er, w, shift, 0.2,
                           exact)
    assert torch.equal(pad[0].view(N, H, Dp)[:, :, :D].reshape(N, H * D),
                       ref[0])
    assert torch.equal(pad[1], ref[1]) and torch.equal(pad[2], ref[2])
    rst, den, sh = ref
    sds = (rst.view(N, H, D) * dout.view(N, H, D)).sum(-1)
    args = (g.csr_indptr, g.csr_eids, sk.rev_gidx(g))
    b_ref = gk.gat_bwd_plain(*args, wh, el, er, sh, den, sds, dout, w, 0.2)
    b_pad = gk.gat_bwd_plain(*args, whp, el, er, sh, den, sds,
                             gk.pad_heads(dout, H, D, Dp), w, 0.2)
    assert torch.equal(
        b_pad[0].view(N, H, Dp)[:, :, :D].reshape(N, H * D), b_ref[0])
    for a, b in zip(b_pad[1:], b_ref[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The bf16-dout rule
# ---------------------------------------------------------------------------
def test_bf16_dout_rule():
    assert gk.bf16_dout(torch.bfloat16)
    assert not gk.bf16_dout(torch.float32)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fdtype", [torch.float32, torch.bfloat16])
def test_dout_reaching_backward(fdtype, packed, monkeypatch):
    """GatFused.backward asks K3 for a bf16 dout exactly where fsrc is bf16
    (packed or not), and there the float32 dout it hands K3 equals its own
    bf16 rounding bit for bit; beside a float32 fsrc it does not ask."""
    seen = {}
    real = gk.gat_bwd

    def bwd(*a, **kw):
        seen["dout"], seen["kw"] = a[9], dict(kw)
        return real(*a, **kw)
    monkeypatch.setattr(gk, "gat_bwd", bwd)
    g = _graph(4)
    rng = np.random.default_rng(5)
    H, D = 2, 8
    fsrc = torch.from_numpy(rng.normal(size=(N, H, D)).astype(np.float32))
    fsrc = fsrc.to(fdtype).requires_grad_(True)
    el = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
    er = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(N, H, D)).astype(np.float32))
    out = gk.gat_attention_fused(g, fsrc, el, er, packed=packed)
    (out.float() * t).sum().backward()
    dout = seen["dout"]
    assert dout.dtype == torch.float32
    asked = seen["kw"].get("dout_bf16", False)
    assert asked == (fdtype == torch.bfloat16)
    if asked:
        assert torch.equal(dout, dout.to(torch.bfloat16).float())
    else:
        assert not torch.equal(dout, dout.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# The route rule and the staged walk's shape
# ---------------------------------------------------------------------------
# (H, D): Dp, vec, Lh, NC, lanes a group; K2's record with w and edges a
# stage; K3's with w and a float32 dout and its edges; K3's record with w
# and a bf16 dout
STAGED = {(8, 8): (8, 8, 1, 1, 8, 192, 16, 416, 8, 288),
          (1, 41): (48, 8, 8, 1, 8, 128, 32, 224, 16, 128),
          (4, 16): (16, 8, 2, 1, 8, 160, 16, 336, 8, 208),
          (8, 1): (1, 1, 1, 1, 8, 80, 32, 192, 16, 176)}


@pytest.mark.parametrize("H,D", SHAPES)
def test_stage_shape(H, D):
    """The padded width, load width, head layout, records and edges a stage
    (the most of 32, 16, 8 whose records fit STAGE_BYTES) of both staged
    kernels at the default lane floats (8): one pass, every head in one
    lane group, the ring within the block's shared memory."""
    Dp, vec, Lh, NC, lanes, rec2, C2, rec3, C3, rec3b = STAGED[(H, D)]
    for kernel, rec, C in (("fwd", rec2, C2), ("bwd", rec3, C3)):
        st = gk.stage_shape(kernel, H, D)
        assert (st["Dp"], st["vec"], st["Lh"], st["NC"], st["lanes"],
                st["record"]) == (Dp, vec, Lh, NC, lanes, rec)
        assert st["nchunk"] == 1 and st["Hp"] >= H
        assert (st["stages"], st["edges"]) == (gk.STAGES, C)
        assert C * rec <= gk.STAGE_BYTES < 2 * C * rec or C == 32
        assert st["smem"] == gk.STAGE_WARPS * gk.STAGES * (C * rec + 4 * C) \
            <= gk.STAGE_SMEM
    assert gk.stage_shape("bwd", H, D, dout_bf16=True)["record"] == rec3b


@pytest.mark.parametrize("H,D", SHAPES)
def test_route_rule(H, D):
    """A bf16 Wh takes the staged route where the shape fits; float32 keeps
    the head-major walk at every shape."""
    for kernel in ("fwd", "bwd"):
        assert gk.gat_route(kernel, H, D, torch.bfloat16) == "staged"
        assert gk.gat_route(kernel, H, D, torch.float32) == "rows"


@pytest.mark.parametrize("H,D", [(2, 3100), (8, 64), (64, 1)])
def test_route_rule_wide_heads(H, D):
    """Heads that take more than one pass of a lane group (a head wider than
    32 lanes of 8 values, or more heads than a group holds) stay on the
    head-major walk in bf16 too."""
    lay = gk.head_layout(H, gk.padded_head_width(H, D),
                         gk.stage_vec(gk.padded_head_width(H, D)), 8)
    assert lay["nchunk"] > 1 or lay["Hp"] < H
    for kernel in ("fwd", "bwd"):
        assert gk.stage_shape(kernel, H, D) is None
        assert gk.gat_route(kernel, H, D, torch.bfloat16) == "rows"


def test_ring_shrinks_to_fit():
    """A record too wide for the asked ring takes fewer edges a stage, then
    fewer stages, within STAGE_SMEM; none fits: no staged route."""
    st = gk.stage_shape("bwd", 8, 32, stages=4, edges=32)
    assert st["smem"] <= gk.STAGE_SMEM
    assert (st["stages"], st["edges"]) == (4, 8)
    assert gk.stage_shape("bwd", 8, 32, stages=4, edges=8)["edges"] == 8
    assert gk.stage_shape("bwd", 4, 16, stages=2, edges=32)["edges"] == 32


@pytest.mark.parametrize("lane_floats,Lh,NC", [(2, 2, 1), (4, 2, 1),
                                               (8, 1, 2)])
def test_head_layout(lane_floats, Lh, NC):
    """rowwalk.cuh:head_shape's layout at H = 8, D = 8 and 4 float32 values
    a load: a lane holds at least one load, and fewer lanes a head hold more
    floats each."""
    lay = gk.head_layout(8, 8, 4, lane_floats)
    assert (lay["Lh"], lay["NC"], lay["nchunk"]) == (Lh, NC, 1)
    assert lay["lanes"] == min(32, Lh * 8) and lay["Hp"] == 8


@pytest.mark.parametrize("passes", [2, 3, 5])
def test_dst_cuts_partition_rows(passes):
    """The staged K3's passes over ranges of dst nodes: pass p takes, of
    each CSR row, the run of edges [cuts[p - 1], cuts[p]) (the row's start
    and end outside), whose dst lie in [ceil(p N / P), ceil((p + 1) N /
    P)); the runs of a row's passes cover it once, in order."""
    g = _graph(7)
    dst = sk.rev_gidx(g)
    cuts = gk.dst_cuts(g.csr_indptr, dst, N, passes).numpy()
    ip, d = g.csr_indptr.numpy(), dst.numpy()
    assert cuts.shape == (passes - 1, N) and cuts.dtype == np.int32
    for u in range(N):
        bounds = [ip[u], *cuts[:, u], ip[u + 1]]
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        for p in range(passes):
            lo, hi = -(-p * N // passes), -(-(p + 1) * N // passes)
            run = d[bounds[p]:bounds[p + 1]]
            assert ((run >= lo) & (run < hi)).all()
    assert gk._cached_cuts(g.csr_indptr, dst, N, passes) is \
        gk._cached_cuts(g.csr_indptr, dst, N, passes)


def test_k3_passes():
    """One pass where the dst rows that K3 gathers fit ``K3_PASS_BYTES``;
    at synthetic Reddit (232,965 nodes) 3 passes for H = 8, D = 8 with a
    float32 dout (416 - 32 bytes a dst), 2 with a bf16 one, 2 and 1 at
    H = 1, D = 41."""
    n = 232_965
    assert gk.k3_passes(N, 8, 8) == 1
    assert [gk.k3_passes(n, H, D, True, b) for H, D in ((8, 8), (1, 41))
            for b in (False, True)] == [3, 2, 2, 1]
    assert gk.k3_passes(10 ** 9, 8, 8) == gk.K3_PASSES_MAX


# ---------------------------------------------------------------------------
# bf16 operands at an odd head width against the JAX package
# ---------------------------------------------------------------------------
def bf16_ulp(v):
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("with_w", [False, True])
def test_bf16_odd_width_vs_jax_prepared(with_w, monkeypatch):
    """bf16 fsrc, el, er (and attn_w) at H = 1, D = 41: ``dt.gat_attention``
    on the CPU and the JAX prepared graph give the output and every
    gradient in bf16, each within one bf16 ulp plus PALLAS_TOL of max|ref|
    of the other's."""
    monkeypatch.setenv("DGL_TPU_SPMM_MODE", "highest")
    monkeypatch.setenv("DGL_TPU_GAT_SOFTMAX", "shift")
    H, D = 1, 41
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    gp = dgl.prepare_spmm(dgl.graph((src, dst), num_nodes=N), te=256, bc=8,
                          wc=2)
    gt = dt.graph((src, dst), num_nodes=N)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((N, H, D), (N, H), (N, H))]
    if with_w:
        arrs.append(((rng.random((E, H)) > 0.3) / 0.7).astype(np.float32))
    arrs = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for a in arrs]
    t = rng.normal(size=(N, H, D)).astype(np.float32)
    tq = np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))

    def f(*a):
        out = jax_gat(gp, a[0], a[1], a[2], 0.2, a[3] if with_w else None)
        return (out.astype(jnp.float32) * tq).sum(), out
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    (_, jout), jgrads = jax.value_and_grad(
        f, argnums=tuple(range(len(args))), has_aux=True)(*args)
    ins = [torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
           for a in arrs]
    out = dt.gat_attention(gt, *ins[:3], 0.2, ins[3] if with_w else None)
    grads = torch.autograd.grad((out.float() * torch.tensor(tq)).sum(), ins)
    for name, a, b in zip(("out", "dfsrc", "del", "der", "dattn_w"),
                          [out, *grads], [jout, *jgrads]):
        assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
        a = a.detach().float().numpy().astype(np.float64)
        b = np.asarray(b.astype(jnp.float32), np.float64)
        allow = bf16_ulp(np.maximum(np.abs(a), np.abs(b))) \
            + PALLAS_TOL * float(np.abs(b).max())
        err = float((np.abs(a - b) / allow).max())
        assert err <= 1.0, f"{name}: {err:.3g} of the bound"
