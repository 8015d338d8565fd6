"""update_all / apply_edges / apply_nodes with the builtin functions: the
PyTorch port against the JAX package, on the CPU, from the same graph and
numpy inputs.  Both run bare graphs (composed paths; the port's K6 combos
run K6's plain version), so results agree to 1e-5 * max|ref| (exact f32,
only the summation order differs).  Reduce UDFs, send/recv, pull/push,
send_and_recv and group_apply_edges are held against the JAX package in
test_torch_message_udf.py.
"""
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import fn

torch.set_num_threads(2)

TOL = 1e-5
N, E = 40, 300


def assert_close(out, ref, tol=TOL, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(out - ref).max()) <= tol * scale, what


def _pair(seed, block=False):
    """The same graph in both packages, with node features 'h' (N, 2, 3),
    'w' (N, 2, 1), an edge feature 'a' (E, 2, 3) in user order, and 'x' on
    the dst side of a block."""
    rng = np.random.default_rng(seed)
    ns = N + 6 if block else N
    src = rng.integers(0, ns, E)
    dst = rng.integers(0, N - 4, E)                 # 4 empty dst rows
    if block:
        gj = dgl.block((src, dst), num_src=ns, num_dst=N)
        gt = dt.block((src, dst), num_src=ns, num_dst=N)
    else:
        gj = dgl.graph((src, dst), num_nodes=N)
        gt = dt.graph((src, dst), num_nodes=N)
    feats = {
        "srcdata": {"h": rng.uniform(0.5, 2.0, (ns, 2, 3)),
                    "w": rng.uniform(0.5, 2.0, (ns, 2, 1))},
        "dstdata": {"h": rng.uniform(0.5, 2.0, (N, 2, 3)),
                    "x": rng.uniform(0.5, 2.0, (N, 2, 3))},
        "edata": {"a": rng.normal(size=(E, 2, 3))},
    }
    for frame, fields in feats.items():
        for k, v in fields.items():
            v = v.astype(np.float32)
            getattr(gj, frame)[k] = jnp.asarray(v)
            getattr(gt, frame)[k] = torch.from_numpy(v)
    return gj, gt


MESSAGES = [
    ("u_dot_v", ("h", "h")), ("u_add_v", ("h", "x")),
    ("v_sub_u", ("x", "h")), ("u_div_v", ("h", "h")),
    ("e_mul_v", ("a", "x")), ("u_mul_e", ("h", "a")),
    ("v_dot_u", ("h", "h")), ("copy_u", ("h",)), ("copy_e", ("a",))]


@pytest.mark.parametrize("name,fields", MESSAGES)
@pytest.mark.parametrize("block", [False, True])
def test_apply_edges_builtin(name, fields, block):
    gj, gt = _pair(1, block)
    gj.apply_edges(getattr(dgl.function, name)(*fields, "m"))
    gt.apply_edges(getattr(fn, name)(*fields, "m"))
    assert_close(gt.edata["m"].numpy(), gj.edata["m"], what=name)
    assert_close(gt.edata_internal["m"].numpy(),
                 gj.edata_internal["m"], what=name)


@pytest.mark.parametrize("msg,fields", [
    ("copy_u", ("h",)), ("u_mul_e", ("h", "a")), ("u_add_v", ("h", "x")),
    ("copy_e", ("a",)), ("u_mul_v", ("w", "x"))])
@pytest.mark.parametrize("red", ["sum", "mean", "max"])
def test_update_all_builtin(msg, fields, red):
    gj, gt = _pair(2, block=msg == "u_mul_v")
    gj.update_all(getattr(dgl.function, msg)(*fields, "m"),
                  getattr(dgl.function, red)("m", "out"))
    gt.update_all(getattr(fn, msg)(*fields, "m"),
                  getattr(fn, red)("m", "out"))
    assert_close(gt.dstdata["out"].numpy(), gj.dstdata["out"],
                 what=f"{msg} {red}")


def test_update_all_edge_udf_builtin_reduce_and_apply_nodes():
    gj, gt = _pair(3)

    def udf_j(edges):
        return {"m": edges.src["h"] * edges.data["a"] - edges.dst["x"]}

    def udf_t(edges):
        return {"m": edges.src["h"] * edges.data["a"] - edges.dst["x"]}

    gj.update_all(udf_j, dgl.function.sum("m", "out"),
                  lambda nodes: {"out2": nodes.data["out"] * 2.0})
    gt.update_all(udf_t, fn.sum("m", "out"),
                  lambda nodes: {"out2": nodes.data["out"] * 2.0})
    assert_close(gt.ndata["out"].numpy(), gj.ndata["out"])
    assert_close(gt.ndata["out2"].numpy(), gj.ndata["out2"])


def test_apply_edges_udf_and_gradient():
    """An edge UDF over an EdgeBatch, and gradients through a builtin
    message with a dst-side operand (GsddmmFn's backward)."""
    gj, gt = _pair(4)
    gj.apply_edges(lambda e: {"s": (e.src["h"] * e.dst["h"]).sum(-1)})
    gt.apply_edges(lambda e: {"s": (e.src["h"] * e.dst["h"]).sum(-1)})
    assert_close(gt.edata["s"].numpy(), gj.edata["s"])
    h = gt.ndata["h"].clone().requires_grad_()
    gt.ndata["h"] = h
    gt.apply_edges(fn.u_dot_v("h", "h", "d"))
    gt.edata_internal["d"].sum().backward()
    # d/dh of sum_e <h[u], h[v]>: h[v] summed at u, h[u] summed at v
    ref = torch.zeros_like(h)
    ref.index_add_(0, gt.dst.long(), h.detach()[gt.src.long()])
    ref.index_add_(0, gt.src.long(), h.detach()[gt.dst.long()])
    assert_close(h.grad.numpy(), ref.numpy())


@pytest.mark.parametrize("order", ["internal", "eid"])
def test_graph_edge_softmax(order):
    gj, gt = _pair(6)
    logits = np.random.default_rng(6).normal(size=(E, 2, 1)).astype(
        np.float32)
    assert_close(gt.edge_softmax(torch.from_numpy(logits), order).numpy(),
                 gj.edge_softmax(jnp.asarray(logits), order), what=order)


def test_reduce_udf_and_unported_calls_raise():
    """The calls that raised before ``core/message.py`` was ported (a
    reduce UDF in update_all, send_and_recv, pull, push, send/recv,
    group_apply_edges) now run, with the JAX package's results (the full
    parity suite is test_torch_message_udf.py)."""
    gj, gt = _pair(5)
    res = {}
    for name, g, f, xp in (("jax", gj.local_var(), dgl.function, jnp),
                           ("torch", gt.local_var(), fn, torch)):
        def reduce_udf(nodes):
            return {"out": nodes.mailbox["m"].sum(1)}

        def group_udf(edges):
            return {"g": edges.src["h"] * edges.mask[:, :, None, None]}
        g.update_all(f.copy_u("h", "m"), reduce_udf)
        g.send_and_recv([0, 1], f.copy_u("h", "m"), f.sum("m", "o1"))
        g.pull([0], f.copy_u("h", "m"), f.sum("m", "o2"))
        g.push([0], f.copy_u("h", "m"), f.sum("m", "o3"))
        g.send(f.copy_u("h", "m"))
        g.recv([0], f.sum("m", "o4"))
        g.group_apply_edges("src", group_udf)
        res[name] = [np.asarray(g.ndata[k]) for k in
                     ("out", "o1", "o2", "o3", "o4")] + [
            np.asarray(g.edata["g"])]
    for a, b in zip(res["torch"], res["jax"]):
        assert_close(a, b)


def test_builtin_namespace_matches_jax():
    """The same names, building the same descriptors."""
    assert set(dgl.function.__all__) == set(fn.__all__)
    for name in ("u_dot_v", "e_sub_v", "src_mul_edge"):
        assert astuple(getattr(fn, name)("a", "b", "c")) == astuple(
            getattr(dgl.function, name)("a", "b", "c"))
    for name in ("copy_src", "copy_e", "mean", "max"):
        assert astuple(getattr(fn, name)("a", "b")) == astuple(
            getattr(dgl.function, name)("a", "b"))
    assert fn.v_dot_u("a", "b", "c").name == "v_dot_u"
    assert fn.copy_u("a", "m").name == "copy_u"
