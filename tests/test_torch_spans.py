"""The port's spans (``utils/profiling.py``): the no-op outside a trace,
the table of names, the nesting a training step shows under the CPU
profiler, and the set-up registry."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch.models.gnn_models import GAT, GraphSAGE
from dgl_hack_tpu_torch.models.training import node_classifier_step
from dgl_hack_tpu_torch.ops.cuda import spmm_kernel
from dgl_hack_tpu_torch.ops.cuda.gat_kernel import gat_attention_fused
from dgl_hack_tpu_torch.utils import profiling
from dgl_hack_tpu_torch.utils.profiling import SPANS, TOTALS, span, spanned

PKG = Path(dt.__file__).resolve().parent
OPENED = re.compile(r"\bspan(?:ned)?\(\s*\"([^\"]+)\"")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_graph(n=48, e=300, seed=0, **prepare):
    rng = np.random.default_rng(seed)
    g = dt.graph((rng.integers(0, n, e), rng.integers(0, n, e)),
                 num_nodes=n)
    return dt.prepare_spmm(g, device="cpu", **prepare)


def step_of(model, g, seed=0):
    rng = np.random.default_rng(seed)
    n = g.num_dst_nodes
    x = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    step, _ = node_classifier_step(model, g, x, y, torch.ones(n, dtype=bool),
                                   device="cpu")
    return step


def span_tree(prof):
    """{span: set of the program spans around it}, from a trace."""
    out = {}
    for e in prof.events():
        if e.name not in SPANS:
            continue
        up, around = e.cpu_parent, []
        while up is not None:
            if up.name in SPANS:
                around.append(up.name)
            up = up.cpu_parent
        out.setdefault(e.name, set()).add(tuple(around))
    return out


def test_span_is_one_noop_outside_a_trace():
    assert span("ops.gspmm") is span("kernel.k1")
    with span("ops.gspmm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        inside = span("ops.gspmm")
        assert isinstance(inside, torch.autograd.profiler.record_function)
    assert span("ops.gspmm") is span("trainer.forward")
    with pytest.raises(ValueError, match="not in"):
        span("ops.gspmm.typo")
    with pytest.raises(ValueError, match="not in"):
        spanned("aten::linear")


def test_every_opened_name_is_in_the_table():
    opened = set()
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        opened |= set(OPENED.findall(text))
        if path.name != "profiling.py":
            assert "record_function" not in text, path
    assert opened == set(SPANS)
    for name, s in SPANS.items():
        # trace.py's gemm_role and the harness's own spans read as before
        assert "GspmmHybrid" not in name and name != "aten::linear"
        assert not name.startswith(("autograd::", "gnnbench."))
        assert s.layer and s.meaning and "\n" not in s.meaning


def test_no_record_function_outside_a_trace(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __init__(self, name, *args):
            if name in SPANS:            # torch's optimizer opens its own
                entered.append(name)
            super().__init__(name, *args)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    g = tiny_graph(dense_threshold=4)
    for model in (GAT(4, 3, heads=(2, 1)), GraphSAGE(5, 3)):
        step = step_of(model, g)
        step()
        step()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert "trainer.forward" in entered and "ops.gspmm" in entered


def test_gat_step_nesting():
    step = step_of(GAT(4, 3, heads=(2, 1)), tiny_graph())
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    tree = span_tree(prof)
    conv = ("nn.GATConv", "trainer.forward")
    assert tree["trainer.forward"] == {()}
    assert tree["trainer.loss"] == {()}
    assert tree["trainer.backward"] == {()}
    assert tree["trainer.optimizer"] == {()}
    assert tree["nn.GATConv"] == {("trainer.forward",)}
    assert tree["nn.dropout"] == {conv}
    assert tree["nn.GATConv.attn_drop"] == {conv}
    assert tree["ops.gat_attention"] == {conv}
    # the CPU route composes gsddmm, edge_softmax and gspmm
    assert ("ops.gat_attention",) + conv in tree["ops.gspmm"]


def test_gat_fused_nesting():
    g = tiny_graph()
    rng = np.random.default_rng(1)
    N, H, D = g.num_src_nodes, 2, 3

    def leaf(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            requires_grad=True)
    fsrc, el, er = leaf(N, H, D), leaf(N, H), leaf(g.num_dst_nodes, H)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ops.gat_attention"):
            out = gat_attention_fused(g, fsrc, el, er)
        out.sum().backward()
    tree = span_tree(prof)
    assert tree["kernel.k2"] == {("ops.gat_attention",)}
    assert tree["ops.gat_attention.bwd"] == {()}
    assert tree["kernel.k3"] == {("ops.gat_attention.bwd",)}
    assert tree["kernel.k1"] == {("ops.gat_attention.bwd",)}


def test_sage_step_nesting_through_the_hybrid():
    g = tiny_graph(dense_threshold=4)
    assert "hybrid" in g.derived
    step = step_of(GraphSAGE(5, 3), g)
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    tree = span_tree(prof)
    gspmm = ("ops.gspmm", "nn.SAGEConv", "trainer.forward")
    assert tree["nn.SAGEConv"] == {("trainer.forward",)}
    assert tree["nn.dropout"] == {("trainer.forward",)}
    assert tree["ops.gspmm"] == {gspmm[1:]}
    assert tree["kernel.k1"] == {gspmm, ("ops.gspmm.bwd", "trainer.backward")}
    assert tree["kernel.hybrid_mm"] == tree["kernel.k1"]
    assert tree["ops.gspmm.bwd"] == {("trainer.backward",)}


def test_step_holds_no_logits_through_the_backward():
    """The spans split the step into statements; the (N, C) logits must
    still be freed before the backward, as the one-expression step did."""
    import weakref
    model = GraphSAGE(5, 3)
    step = step_of(model, tiny_graph())
    step()
    refs, alive = [], []
    model.register_forward_hook(
        lambda m, args, out: refs.append(weakref.ref(out)))
    model.sage0.fc_self.weight.register_hook(
        lambda g: alive.append(refs[-1]() is not None))
    step()
    assert alive == [False]


def test_setup_registry():
    TOTALS.reset()
    rng = np.random.default_rng(2)
    g = dt.graph((rng.integers(0, 48, 300), rng.integers(0, 48, 300)),
                 num_nodes=48)
    assert TOTALS.calls == {"graph.build": 1, "graph.build.sort": 2}
    g = dt.prepare_spmm(g, device="cpu", dense_threshold=4)
    assert TOTALS.calls["ops.prepare"] == 1
    assert TOTALS.calls["ops.plans"] >= 3
    for model in (GraphSAGE(5, 3), GAT(4, 3, heads=(2, 1))):
        step = step_of(model, g)
        step()
        plans = TOTALS.calls["ops.plans"]
        step()
        # a plan rebuilt inside a window would show here
        assert TOTALS.calls["ops.plans"] == plans
    assert set(TOTALS.seconds) == set(TOTALS.calls)
    assert all(v >= 0.0 for v in TOTALS.seconds.values())
    # a cold span inside one of its own name counts once, traced or not
    before = TOTALS.calls["ops.plans"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ops.plans"):
            with span("ops.plans"):
                pass
    assert TOTALS.calls["ops.plans"] == before + 1
    # torch's events merge a child into a parent of the same name
    assert sum(e.name == "ops.plans" for e in prof.events()) == 1
    TOTALS.reset()
    assert TOTALS.calls == {} and TOTALS.seconds == {}


def test_setup_registry_on_a_batch():
    rng = np.random.default_rng(3)
    bg = dt.prepare_spmm(dt.batch([
        dt.graph((rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)),
                 num_nodes=n) for n in (9, 17, 22)]), device="cpu")
    x = torch.from_numpy(rng.standard_normal((48, 4)).astype(np.float32))
    TOTALS.reset()
    dt.sum_nodes(bg, x)
    # the batch's node segments: one plan build, on the cache miss
    assert TOTALS.calls == {"ops.plans": 1}
    for model in (GraphSAGE(5, 3), GAT(4, 3, heads=(2, 1))):
        step = step_of(model, bg)
        step()
        step()
    dt.sum_nodes(bg, x)
    # a row plan built per call (K1 over an indptr with no cached plan) is
    # no set-up: it stays out of the registry
    spmm_kernel.row_plan(bg.csc_indptr)
    spmm_kernel.segments([3, 0, 5], "cpu")
    assert TOTALS.calls == {"ops.plans": 1}


def test_trace_shows_the_spans(tmp_path):
    step = step_of(GraphSAGE(5, 3), tiny_graph())
    with profiling.trace(str(tmp_path)) as prof:
        step()
    names = {e.name for e in prof.events()}
    assert {"trainer.forward", "nn.SAGEConv", "ops.gspmm"} <= names
    assert "trainer.optimizer" in (tmp_path / "trace.json").read_text()
