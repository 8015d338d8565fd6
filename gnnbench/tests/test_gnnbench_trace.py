"""The trace reader on a hand-made event list: the window, busy and idle
time, kernel families, dense products by role, the breakdown."""
from collections import namedtuple
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from gnnbench import trace

Range = namedtuple("Range", "start end")
K = namedtuple("K", "name device duration")


def cpu(name, s, e, parent=None, kernels=()):
    return SimpleNamespace(name=name, device_type=DeviceType.CPU,
                           is_async=False, time_range=Range(s, e),
                           cpu_parent=parent, kernels=list(kernels))


def dev(name, s, e, annotation=False):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           is_async=False, time_range=Range(s, e),
                           is_user_annotation=annotation, kernels=[])


def test_window_families_roles_and_gaps():
    win = cpu(trace.WINDOW, 100, 1100)
    step = cpu(trace.STEP, 110, 1000, win)
    lin = cpu("aten::linear", 120, 130, step)
    mm_nn = cpu("aten::addmm", 121, 129, lin,
                [K("sm80_xmma_gemm_f32f32", 0, 100.0)])
    mm_hyb = cpu("aten::mm", 140, 150, step,
                 [K("cutlass::Kernel2<cutlass_80_simt_sgemm>", 0, 50.0)])
    bwd = cpu("autograd::engine::evaluate_function: GspmmHybridBackward",
              600, 700)
    mm_bwd = cpu("aten::mm", 610, 620, bwd, [K("ampere_sgemm_64x64", 0, 25.0)])
    idle_op = cpu("aten::nonzero", 900, 1050, step)
    events = [win, step, lin, mm_nn, mm_hyb, bwd, mm_bwd, idle_op,
              dev(trace.STEP, 110, 1000, annotation=True),
              dev("sm80_xmma_gemm_f32f32", 200, 300),
              dev("cutlass::Kernel2<cutlass_80_simt_sgemm>", 300, 350),
              dev("void (anonymous namespace)::segment_sum_kernel<4>(x)",
                  350, 650),
              dev("ampere_sgemm_64x64", 650, 675),
              dev("Memset (Device)", 50, 120),           # clipped at 100
              dev("void gat_fwd_kernel<float>(y)", 1000, 1200)]
    tr = trace.Trace(events)
    assert tr.window_s == pytest.approx(1000e-6)
    # busy: [100,120] + [200,675] + [1000,1100]
    assert tr.busy_s == pytest.approx(595e-6)
    assert tr.ms("k1") == pytest.approx(0.3)
    assert tr.ms("k2") == pytest.approx(0.1)
    assert tr.ms("gemm") == pytest.approx(0.175)
    assert tr.ms("gemm", "nn") == pytest.approx(0.1)
    assert tr.ms("gemm", "hybrid") == pytest.approx(0.075)
    # gaps: [120,200] mid 160 (step), [675,1000] mid 837.5 (step),
    # none at the end
    assert tr.idle == {trace.STEP: pytest.approx(405e-6)}
    b = tr.breakdown()
    assert b["device_ops"][0] == ["segment_sum_kernel", pytest.approx(3e-4)]
    assert len(b["device_ops"]) <= 10 and trace.STEP not in dict(
        b["device_ops"])


def test_gemm_role_rule():
    assert trace.gemm_role(["aten::mm", "aten::linear"]) == "nn"
    assert trace.gemm_role(
        ["aten::mm", "autograd::engine::evaluate_function: MmBackward0"]) \
        == "nn"
    assert trace.gemm_role(
        ["aten::mm",
         "autograd::engine::evaluate_function: GspmmHybridBackward"]) \
        == "hybrid"
    assert trace.gemm_role(["aten::mm", trace.STEP]) == "hybrid"
    assert trace.gemm_role([]) == "nn"


def test_families_from_names():
    assert trace.family_of("void segment_sum_pairs8_kernel<1>") == "k1"
    assert trace.family_of("void gat_bwd_staged_kernel<2>") == "k3"
    assert trace.family_of("void max_bwd_packed_kernel<>") == "k4k5"
    assert trace.family_of("void sddmm_dot_vec_kernel") == "k6"
    assert trace.family_of("at::native::elementwise_kernel") == "other"
