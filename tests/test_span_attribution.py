"""``gnnbench/spans.py``: device time charged to the port's spans, on
hand-made event lists as in ``gnnbench/tests/test_gnnbench_trace.py``,
and the backward's mapping on a real CPU profile of a training step."""
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from gnnbench import spans, trace

Range = namedtuple("Range", "start end")
K = namedtuple("K", "name device duration")
MAIN, AUTOGRAD = 1, 2


class Events:
    """A hand-made trace: host ops with ids, parents, threads and
    sequence numbers; device operations linked to the op that launched
    them."""

    def __init__(self):
        self.events = []
        self.next_id = 1

    def cpu(self, name, s, e, parent=None, *, seq=-1, thread=MAIN,
            fwd_thread=0, kernels=()):
        ev = SimpleNamespace(
            name=name, device_type=DeviceType.CPU, is_async=False,
            time_range=Range(s, e), cpu_parent=parent, kernels=list(kernels),
            id=self.next_id, sequence_nr=seq, thread=thread,
            fwd_thread=fwd_thread, is_user_annotation=False)
        self.next_id += 1
        self.events.append(ev)
        return ev

    def dev(self, name, s, e, op=None, annotation=False):
        """A device operation, and where ``op`` launched it, the CUDA call
        inside ``op`` that has its id (CUPTI's correlation id, which may
        equal a host op's own id)."""
        ev = SimpleNamespace(
            name=name, device_type=DeviceType.CUDA, is_async=False,
            time_range=Range(s, e), cpu_parent=None, kernels=[],
            id=self.next_id, sequence_nr=-1, thread=0, fwd_thread=0,
            is_user_annotation=annotation)
        self.events.append(ev)
        if op is not None:
            op.kernels.append(K(name, 0, e - s))
            t = op.time_range.start
            call = self.cpu("cudaLaunchKernel", t, t + 0.5, op,
                            thread=op.thread)
            call.id = ev.id
        self.next_id += 1
        return ev


def gat_step(with_spans=True):
    """One GAT-like step: forward under trainer / nn / ops / kernel spans,
    its backward on the autograd thread, and a few kernels around."""
    ev = Events()

    def sp(name, s, e, parent):
        return ev.cpu(name, s, e, parent) if with_spans else parent

    win = ev.cpu(trace.WINDOW, 100, 1100)
    step = ev.cpu(trace.STEP, 110, 1000, win)
    fwd = sp("trainer.forward", 120, 400, step)
    conv = sp("nn.GATConv", 125, 390, fwd)
    drop = sp("nn.dropout", 130, 160, conv)
    # ge peeks sequence number 7; the mul that makes node 7 comes later
    ge = ev.cpu("aten::ge", 135, 140, drop, seq=7)
    lin = ev.cpu("aten::linear", 165, 180, conv, seq=8)
    mm = ev.cpu("aten::mm", 166, 179, lin, seq=8)
    mul = ev.cpu("aten::mul", 182, 186, conv, seq=7)
    att = sp("ops.gat_attention", 190, 300, conv)
    gat = ev.cpu("GatFused", 192, 290, att, seq=9)
    k2 = sp("kernel.k2", 200, 280, gat)
    sp("trainer.backward", 420, 900, step)
    # the backward runs on the autograd thread
    e_mul = ev.cpu(f"{spans.BACKWARD}: MulBackward0", 430, 450, seq=7,
                   thread=AUTOGRAD, fwd_thread=MAIN)
    mul_b = ev.cpu("aten::mul", 432, 440, e_mul, thread=AUTOGRAD)
    e_gat = ev.cpu(f"{spans.BACKWARD}: GatFusedBackward", 460, 700, seq=9,
                   thread=AUTOGRAD, fwd_thread=MAIN)
    gat_b = sp("ops.gat_attention.bwd", 462, 690, e_gat)
    k3 = sp("kernel.k3", 470, 600, gat_b)
    e_acc = ev.cpu(f"{spans.BACKWARD}: torch::autograd::AccumulateGrad",
                   710, 720, thread=AUTOGRAD)
    acc = ev.cpu("aten::add_", 711, 719, e_acc, thread=AUTOGRAD)
    e_mm = ev.cpu(f"{spans.BACKWARD}: MmBackward0", 730, 760, seq=8,
                  thread=AUTOGRAD, fwd_thread=MAIN)
    mm_b = ev.cpu("aten::mm", 732, 758, e_mm, thread=AUTOGRAD)
    opt = sp("trainer.optimizer", 905, 990, step)
    adam = ev.cpu("aten::_foreach_add_", 910, 980, opt)
    ev.cpu("aten::item", 992, 999, step)
    ev.dev(trace.STEP, 110, 1000, annotation=True)
    ev.dev("nn.GATConv", 200, 300, annotation=True)
    ev.dev("Memset (Device)", 50, 130, ge)           # clipped at 100
    ev.dev("sm90_xmma_gemm_f32f32", 200, 260, mm)
    ev.dev("vectorized_elementwise_kernel", 260, 270, mul)
    ev.dev("void gat_fwd_kernel<float>", 270, 400, k2)
    ev.dev("vectorized_elementwise_kernel", 450, 470, mul_b)
    ev.dev("void gat_bwd_kernel<float>", 470, 650, k3)
    ev.dev("vectorized_elementwise_kernel", 720, 725, acc)
    ev.dev("ampere_sgemm_64x64", 760, 800, mm_b)
    k_adam = ev.dev("multi_tensor_apply_kernel", 930, 990, adam)
    # a host op may share a kernel's id: only a CUDA call launches
    ev.cpu("aten::zeros", 991, 992, step).id = k_adam.id
    ev.dev("void gat_bwd_kernel<float>", 1090, 1200, k3)   # clipped at 1100
    return ev.events


FWD = ("trainer.forward", "nn.GATConv")
EDGE = FWD + ("ops.gat_attention",)


def test_charges_innermost_backward_and_unattributed():
    events = gat_step()
    b = spans.SpanBooks(events)
    got = {c: pytest.approx(v) for c, v in b.charges.items()}
    assert got == {
        spans.Charge(FWD + ("nn.dropout",), False, "memset"): 0.03,
        spans.Charge(FWD, False, "gemm"): 0.06,
        spans.Charge(FWD, False, "other"): 0.01,
        spans.Charge(EDGE + ("kernel.k2",), False, "k2"): 0.13,
        # MulBackward0's node was made by aten::mul, not by aten::ge
        spans.Charge(FWD, True, "other"): 0.02,
        spans.Charge(EDGE + ("ops.gat_attention.bwd", "kernel.k3"), True,
                     "k3"): 0.19,
        # AccumulateGrad has no forward op: no span on its thread
        spans.Charge((), True, "other"): 0.005,
        spans.Charge(FWD, True, "gemm"): 0.04,
        spans.Charge(("trainer.optimizer",), False, "other"): 0.06}


def test_books_balance_with_the_window():
    events = gat_step()
    b = spans.SpanBooks(events)
    tr = trace.Trace(events)
    window_ms = sum(k.end - k.start for k in tr.kernels) * 1e-3
    assert b.window_ms == pytest.approx(window_ms, rel=1e-12)
    assert b.ms() == pytest.approx(window_ms, rel=1e-12)
    r = b.readings(steps=1)
    assert r["window_ms"] == pytest.approx(window_ms)
    assert r["step.unattributed_ms"] == pytest.approx(0.005)
    assert r["nn.elementwise_ms"] == pytest.approx(0.03 + 0.01 + 0.02)
    assert r["nn.gemm_ms"] == pytest.approx(0.1)
    assert r["trainer.optimizer_ms"] == pytest.approx(0.06)
    assert r["kernel.gat_op_ms"] == pytest.approx(0.13 + 0.19)
    assert r["kernel.gspmm_op_ms"] == 0.0
    # every device ms is charged somewhere, unattributed included
    assert sum(b.by_innermost().values()) == pytest.approx(window_ms)
    fam = b.by_innermost(families=True)
    assert sum(fam.values()) == pytest.approx(window_ms)
    assert fam["nn.GATConv bwd gemm"] == pytest.approx(0.04)
    assert fam["(unattributed) other"] == pytest.approx(0.005)
    assert b.readings(steps=2)["window_ms"] == pytest.approx(window_ms / 2)


def test_idle_gaps_by_span():
    events = gat_step()
    b = spans.SpanBooks(events)
    # busy [100,130] [200,400] [450,650] [720,725] [760,800] [930,990]
    # [1090,1100]; each gap goes to the innermost host op at its middle,
    # on any thread: 165 aten::linear, 425 and 865 the main thread
    # waiting in the backward, 685 the edge phase's backward on the
    # autograd thread, 742.5 MmBackward0's mm, 1040 only the window
    assert b.idle_by_innermost() == {
        "trainer.backward": pytest.approx(180e-6),
        "(no span)": pytest.approx(100e-6),
        "nn.GATConv": pytest.approx(70e-6),
        "ops.gat_attention.bwd bwd": pytest.approx(70e-6),
        "nn.GATConv bwd": pytest.approx(35e-6)}
    assert sum(b.idle.values()) == pytest.approx(
        trace.Trace(events).window_s - trace.Trace(events).busy_s)


def test_trace_readings_unchanged_by_program_spans():
    with_ = gat_step(True)
    without = gat_step(False)
    a, b = trace.Trace(with_), trace.Trace(without)
    for fam in ("k1", "k2", "k3", "gemm", "memset", "other"):
        assert a.ms(fam) == pytest.approx(b.ms(fam))
    assert dict(a.role_ms) == pytest.approx(dict(b.role_ms))
    assert a.busy_s == pytest.approx(b.busy_s)
    assert a.window_s == pytest.approx(b.window_s)
    assert sum(a.idle.values()) == pytest.approx(sum(b.idle.values()))
    assert a.breakdown()["device_ops"] == b.breakdown()["device_ops"]
    # the spans' copies on the device timeline are no device operation
    assert "nn.GATConv" not in dict(a.breakdown()["device_ops"])
    assert a.summary() == b.summary()
    # a gap inside the step is named by a span, not the harness's step
    assert trace.STEP in b.idle and "trainer.backward" in a.idle


def test_without_the_ports_spans_everything_is_unattributed():
    events = gat_step()
    b = spans.SpanBooks(events, names=())
    assert b.ms(lambda c: bool(c.path)) == 0.0
    assert b.readings(1)["step.unattributed_ms"] == pytest.approx(
        b.window_ms)


def test_backward_mapped_on_a_real_cpu_profile():
    """A SAGE step with a dropout under the CPU profiler: every backward
    op with a forward op maps to that op's spans, and the dropout's
    backward to the dropout."""
    import dgl_hack_tpu_torch as dt
    from dgl_hack_tpu_torch.models.gnn_models import GraphSAGE
    from dgl_hack_tpu_torch.models.training import node_classifier_step
    from torch.profiler import ProfilerActivity, profile, record_function
    rng = np.random.default_rng(3)
    N = 40
    g = dt.graph((rng.integers(0, N, 200), rng.integers(0, N, 200)),
                 num_nodes=N)
    x, y = torch.randn(N, 6), torch.randint(0, 3, (N,))
    step, _ = node_classifier_step(GraphSAGE(5, 3), g, x, y,
                                   torch.ones(N, dtype=torch.bool),
                                   device="cpu")
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            step()
    events = list(prof.events())
    b = spans.SpanBooks(events)
    assert b.charges == {} and b.window_ms == 0.0
    bwd = [e for e in events if e.name.startswith(spans.BACKWARD)]
    assert bwd
    paths = {e.name.split(": ", 1)[1]: b.path_of(e) for e in bwd}
    assert paths["WhereBackward0"] == (
        ("trainer.forward", "nn.dropout"), True)
    mapped = [p for p, _ in paths.values()]
    assert any(p[:2] == ("trainer.forward", "nn.SAGEConv") for p in mapped)
    assert ("trainer.loss",) in mapped
    for name, (path, backward) in paths.items():
        assert backward
        if "AccumulateGrad" in name:
            # no forward op: the spans around it on the calling thread
            assert path == ("trainer.backward",)
