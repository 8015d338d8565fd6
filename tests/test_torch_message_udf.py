"""The message-passing API of the PyTorch port beyond ``update_all`` with
builtins, against the JAX package: the padded mailbox, reduce UDFs,
``send_and_recv``/``pull``/``push``/``send``/``recv`` with builtin and UDF
pairs, ``group_apply_edges`` and ``multi_update_all`` with a reduce UDF,
on plain and masked graphs, forward and gradients.

Both sides run on bare graphs (the JAX side composes in XLA, the port runs
its kernels' plain versions on the CPU) from the same numpy inputs.
Tolerance: 1e-5 of max|ref| (the same float32 sums in another order).
``max_degree`` is at least the largest in-degree wherever the mailbox is
compared, so no two edges write one slot.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu import fn as jfn
from dgl_hack_tpu.core import message as jmsg

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import fn as tfn
from dgl_hack_tpu_torch.core import message as tmsg

torch.set_num_threads(2)

TOL = 1e-5
N, E, F = 40, 200, 3


def assert_close(out, ref, tol=TOL, what=""):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _pair(seed, masked=False):
    """The same graph in both packages: distinct (src, dst) pairs (a max
    then has no tie, whose cotangent the JAX bare graph splits and the
    port does not: ROADMAP trap 5) in user order other than CSC, nodes
    34.. without in-edges, in-degrees up to about 12; ``masked`` drops a
    quarter of the edges through ``edge_mask``."""
    rng = np.random.default_rng(seed)
    pair = rng.choice(N * (N - 6), E, replace=False)
    src, dst = pair // (N - 6), pair % (N - 6)
    mask = rng.random(E) > 0.25 if masked else None
    return (dgl.graph((src, dst), num_nodes=N, edge_mask=mask),
            dt.graph((src, dst), num_nodes=N, edge_mask=mask))


def _x(seed, shape=(N, F)):
    return np.random.default_rng(100 + seed).normal(size=shape).astype(
        np.float32)


MAX_DEG = 16


def _msg_udf(pkg):
    def message(edges):
        return {"m": edges.src["h"] * 2.0 + edges.data["w"]}
    return message


def _reduce_udf(pkg):
    """A masked mean-and-max of the mailbox plus the dst's own data."""
    xp = jnp if pkg == "jax" else torch

    def reduce(nodes):
        m = nodes.mailbox["m"]
        mask = nodes.mask[..., None]
        if pkg == "jax":
            mask = mask.astype(m.dtype)
            deg = nodes.degrees.astype(m.dtype)
        else:
            mask = mask.to(m.dtype)
            deg = nodes.degrees.to(m.dtype)
        s = (m * mask).sum(1)
        big = xp.where(mask > 0, m, -1e30 * xp.ones_like(m))
        mx = big.max(1) if pkg == "jax" else big.max(1).values
        mx = xp.where(deg[:, None] > 0, mx, xp.zeros_like(mx))
        return {"o": s / xp.maximum(deg, xp.ones_like(deg))[:, None] + mx
                + nodes.data["y"]}
    return reduce


PAIRS = {
    "copy_u_sum": lambda f, pkg: (f.copy_u("h", "m"), f.sum("m", "o")),
    "u_mul_e_mean": lambda f, pkg: (f.u_mul_e("h", "w", "m"),
                                    f.mean("m", "o")),
    "copy_u_max": lambda f, pkg: (f.copy_u("h", "m"), f.max("m", "o")),
    "udf_msg_sum": lambda f, pkg: (_msg_udf(pkg), f.sum("m", "o")),
    "udf_msg_min": lambda f, pkg: (_msg_udf(pkg), f.min("m", "o")),
    "udf_reduce": lambda f, pkg: (_msg_udf(pkg), _reduce_udf(pkg)),
}


def _jax_run(gj, call, x, w, y, seed_field=None):
    """Run ``call(g)`` on the JAX graph; (out, dx) of sum(o * cot)."""
    cot = _x(7, (N, F))

    def f(x):
        g = gj.local_var()
        g.ndata["h"] = x
        g.edata_internal["w"] = jnp.asarray(w)
        g.ndata["y"] = jnp.asarray(y)
        if seed_field is not None:
            g.ndata["o"] = jnp.asarray(seed_field)
        call(g)
        return (g.ndata["o"] * cot).sum(), g.ndata["o"]
    (_, out), dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    return out, dx


def _torch_run(gt, call, x, w, y, seed_field=None):
    cot = torch.from_numpy(_x(7, (N, F)))
    xt = torch.from_numpy(x).requires_grad_()
    g = gt.local_var()
    g.ndata["h"] = xt
    g.edata_internal["w"] = torch.from_numpy(w)
    g.ndata["y"] = torch.from_numpy(y)
    if seed_field is not None:
        g.ndata["o"] = torch.from_numpy(seed_field)
    call(g)
    out = g.ndata["o"]
    (out * cot).sum().backward()
    assert "o" not in gt.ndata          # local_var kept the parent clean
    return out, xt.grad


def _inputs(seed):
    return _x(seed), _x(seed + 1, (E, F)), _x(seed + 2, (N, F))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("max_degree", [None, MAX_DEG])
def test_build_mailbox_matches_jax(masked, max_degree):
    gj, gt = _pair(1, masked)
    v = _x(1, (E, 2, 2))
    mj, maskj, degj = jmsg.build_mailbox(gj, {"m": jnp.asarray(v)},
                                         max_degree)
    mt, maskt, degt = tmsg.build_mailbox(gt, {"m": torch.from_numpy(v)},
                                         max_degree)
    np.testing.assert_array_equal(mt["m"].numpy(), np.asarray(mj["m"]))
    np.testing.assert_array_equal(maskt.numpy(), np.asarray(maskj))
    np.testing.assert_array_equal(degt.numpy(), np.asarray(degj))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_update_all_matches_jax(pair, masked):
    """Every (message, reduce) kind through update_all, forward and dx."""
    gj, gt = _pair(2, masked)
    x, w, y = _inputs(2)
    kw = {} if pair != "udf_reduce" else {"max_degree": MAX_DEG}
    if pair == "u_mul_e_mean":
        w = w[:, :1]
    jref, jdx = _jax_run(gj, lambda g: jmsg.update_all(
        g, *PAIRS[pair](jfn, "jax"), **kw), x, w, y)
    out, dx = _torch_run(gt, lambda g: tmsg.update_all(
        g, *PAIRS[pair](tfn, "torch"), **kw), x, w, y)
    assert_close(out, jref, what="out")
    assert_close(dx, jdx, what="dx")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_send_and_recv_matches_jax(pair, masked):
    """A seeded half of the edges (user ids, repeats included)."""
    gj, gt = _pair(3, masked)
    x, w, y = _inputs(3)
    if pair == "u_mul_e_mean":
        w = w[:, :1]
    eids = np.random.default_rng(30).integers(0, E, E // 2)
    jref, jdx = _jax_run(gj, lambda g: jmsg.send_and_recv(
        g, jnp.asarray(eids), *PAIRS[pair](jfn, "jax")), x, w, y)
    out, dx = _torch_run(gt, lambda g: g.send_and_recv(
        eids, *PAIRS[pair](tfn, "torch")), x, w, y)
    assert_close(out, jref, what="out")
    assert_close(dx, jdx, what="dx")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_push_matches_jax(pair, masked):
    gj, gt = _pair(4, masked)
    x, w, y = _inputs(4)
    if pair == "u_mul_e_mean":
        w = w[:, :1]
    u = np.random.default_rng(40).choice(N, 12, replace=False)
    jref, jdx = _jax_run(gj, lambda g: jmsg.push(
        g, jnp.asarray(u), *PAIRS[pair](jfn, "jax")), x, w, y)
    out, dx = _torch_run(gt, lambda g: g.push(
        u, *PAIRS[pair](tfn, "torch")), x, w, y)
    assert_close(out, jref, what="out")
    assert_close(dx, jdx, what="dx")


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_pull_matches_jax(pair, seeded):
    """Rows of v updated; the others keep a field that existed with the
    same shape (``seeded``), and a new field is written whole."""
    gj, gt = _pair(5)
    x, w, y = _inputs(5)
    if pair == "u_mul_e_mean":
        w = w[:, :1]
    v = np.random.default_rng(50).choice(N, 9, replace=False)
    seed = _x(51) if seeded else None
    kw = {} if pair != "udf_reduce" else {"max_degree": MAX_DEG}
    jref, jdx = _jax_run(gj, lambda g: jmsg.pull(
        g, jnp.asarray(v), *PAIRS[pair](jfn, "jax"), **kw), x, w, y, seed)
    out, dx = _torch_run(gt, lambda g: tmsg.pull(
        g, v, *PAIRS[pair](tfn, "torch"), **kw), x, w, y, seed)
    assert_close(out, jref, what="out")
    assert_close(dx, jdx, what="dx")
    if seeded:
        rest = np.setdiff1d(np.arange(N), v)
        np.testing.assert_array_equal(out.detach().numpy()[rest],
                                      seed[rest])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reducer", ["sum", "max", "udf"])
def test_send_recv_matches_jax(reducer, masked):
    gj, gt = _pair(6, masked)
    x, w, y = _inputs(6)
    v = np.arange(0, N, 3)
    seed = _x(61)

    def call(pkg, f, mod):
        rf = _reduce_udf(pkg) if reducer == "udf" else \
            getattr(f, reducer)("m", "o")
        mf = _msg_udf(pkg) if reducer == "udf" else f.copy_u("h", "m")

        def run(g):
            mod.send(g, mf)
            mod.recv(g, v, rf)
        return run
    jref, jdx = _jax_run(gj, call("jax", jfn, jmsg), x, w, y, seed)
    out, dx = _torch_run(gt, call("torch", tfn, tmsg), x, w, y, seed)
    assert_close(out, jref, what="out")
    assert_close(dx, jdx, what="dx")


def test_recv_without_send_raises_and_replace_drops_staged():
    _, gt = _pair(7)
    gt.ndata["h"] = torch.from_numpy(_x(7))
    with pytest.raises(RuntimeError, match="without a prior send"):
        gt.recv([0], tfn.sum("m", "o"))
    gt.send(tfn.copy_u("h", "m"))
    with pytest.raises(RuntimeError, match="without a prior send"):
        gt.replace().recv([0], tfn.sum("m", "o"))
    gt.recv([0, 1], tfn.sum("m", "o"))
    with pytest.raises(RuntimeError, match="without a prior send"):
        gt.recv([0], tfn.sum("m", "o"))       # consumed


def _softmax_udf(pkg):
    """Per-group softmax of the edge logits (an edge field plus the
    product of its two endpoints' fields, so that x gets a gradient
    through both sides) over the real slots."""
    xp = jnp if pkg == "jax" else torch

    def func(edges):
        s = edges.data["s"][..., 0] + (edges.src["h"]
                                       * edges.dst["h"]).sum(-1)
        s = xp.where(edges.mask, s, -1e30 * xp.ones_like(s))
        e = xp.exp(s - (s.max(1, keepdims=True) if pkg == "jax"
                        else s.max(1, keepdim=True).values))
        e = e * edges.mask
        return {"a": (e / e.sum(1, keepdims=True) if pkg == "jax"
                      else e / e.sum(1, keepdim=True))[..., None]}
    return func


@pytest.mark.parametrize("group_by,max_degree", [("src", None),
                                                  ("dst", MAX_DEG)])
def test_group_apply_edges_matches_jax(group_by, max_degree):
    gj, gt = _pair(8)
    x, s = _x(8), _x(9, (E, 1))
    cot = _x(10, (E, 1))

    def jf(x, s):
        g = gj.local_var()
        g.ndata["h"] = x
        g.edata["s"] = s
        jmsg.group_apply_edges(g, group_by, _softmax_udf("jax"),
                               max_degree=max_degree)
        return (g.edata["a"] * cot).sum(), g.edata["a"]
    (_, ref), (jdx, jds) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(s))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    g = gt.local_var()
    g.ndata["h"] = xt
    g.edata["s"] = st
    g.group_apply_edges(group_by, _softmax_udf("torch"),
                        max_degree=max_degree)
    (g.edata["a"] * torch.from_numpy(cot)).sum().backward()
    assert_close(g.edata["a"], ref, what="a")
    assert_close(xt.grad, jdx, what="dx")
    assert_close(st.grad, jds, what="ds")


def test_group_apply_edges_src_on_a_masked_graph():
    """Grouped by src on a masked graph, the padded slots read as zeros
    (the mask taken in the grouped order) and each edge gets back its own
    group's value: against a host reference."""
    _, gt = _pair(9, masked=True)
    w = torch.from_numpy(_x(11, (E, 1)))
    gt.edata["w"] = w

    def func(edges):
        total = edges.data["w"].sum(1, keepdim=True)
        return {"t": total.expand_as(edges.data["w"])}
    gt.group_apply_edges("src", func)
    s, _ = gt.host_edges()
    keep = gt.edge_mask[gt.user2int.long()].numpy()
    wn = w.numpy()[:, 0]
    want = np.array([wn[(s == s[e]) & keep].sum() for e in range(E)])
    np.testing.assert_allclose(gt.edata["t"].numpy()[:, 0], want,
                               rtol=1e-5, atol=1e-6)


def test_method_forms_take_the_jax_arguments():
    """Graph.pull/push/send_and_recv/send/recv/group_apply_edges as the
    JAX lambdas take them, the same results as the functions."""
    gj, gt = _pair(10)
    x = _x(10)
    res = {}
    for name, g, f, conv in (("jax", gj, jfn, jnp.asarray),
                             ("torch", gt, tfn, torch.from_numpy)):
        g = g.local_var()
        g.ndata["h"] = conv(x)
        g.pull(np.arange(5), f.copy_u("h", "m"), f.sum("m", "a"))
        g.push(np.arange(5), f.copy_u("h", "m"), f.sum("m", "b"))
        g.send_and_recv(np.arange(30), f.copy_u("h", "m"), f.max("m", "c"))
        g.send(f.copy_u("h", "m"))
        g.recv(np.arange(7), f.sum("m", "d"))
        g.update_all(f.copy_u("h", "m"), f.sum("m", "e"))
        res[name] = [np.asarray(g.ndata[k]) for k in "abcde"]
    for a, b in zip(res["torch"], res["jax"]):
        assert_close(a, b)


def _hetero_pair():
    data = {("user", "plays", "game"): ([0, 0, 1, 2, 3, 3], [0, 1, 1, 2, 0,
                                                           2]),
            ("developer", "develops", "game"): ([0, 1, 1], [0, 1, 2])}
    counts = {"user": 4, "game": 3, "developer": 2}
    return dgl.heterograph(data, counts), dt.heterograph(data, counts)


@pytest.mark.parametrize("cross", ["sum", "max", "stack"])
def test_multi_update_all_reduce_udf_matches_jax(cross):
    """A reduce UDF per relation over its mailbox, then the cross-type
    reducer, forward and gradients."""
    hj, ht = _hetero_pair()
    feats = {"user": _x(12, (4, F)), "developer": _x(13, (2, F))}
    cot = _x(14, (3, 2, F) if cross == "stack" else (3, F))

    def udf(pkg):
        def reduce(nodes):
            m = nodes.mailbox["m"]
            mask = nodes.mask[..., None]
            mask = mask.astype(m.dtype) if pkg == "jax" else mask.to(m.dtype)
            return {"agg": (m * mask).sum(1) * 2.0 + 1.0}
        return reduce

    def run(h, f, pkg, fs):
        for nt, v in fs.items():
            h.nodes_data(nt)["h"] = v
        h.multi_update_all({"plays": (f.copy_u("h", "m"), udf(pkg)),
                            "develops": (f.copy_u("h", "m"), udf(pkg))},
                           cross, max_degree=4)
        return h.nodes_data("game")["agg"]

    def jloss(fs):
        out = run(hj.local_var(), jfn, "jax", fs)
        return (out * cot).sum(), out
    (_, ref), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in feats.items()})
    ft = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    out = run(ht.local_var(), tfn, "torch", ft)
    (out * torch.from_numpy(cot)).sum().backward()
    assert_close(out, ref, what="agg")
    for nt in feats:
        assert_close(ft[nt].grad, jg[nt], what=f"d{nt}")
