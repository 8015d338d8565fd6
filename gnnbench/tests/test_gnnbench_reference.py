"""The plain references: their parts against autograd and known values,
and each configuration's first training steps against the port's CPU
path at a tiny size (the test imports both; the references do not)."""
import pytest
import torch

from gnnbench import compare, harness, reference
from conftest import CELLS, tiny_cell


def _graph(n=7, e=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (e,), generator=g)
    dst = torch.randint(0, n, (e,), generator=g)
    return reference.RefGraph(src, dst, n)


def test_edge_sum_gradients():
    g = _graph()
    x = torch.randn(7, 2, 3, dtype=torch.float64, requires_grad=True)
    w = torch.rand(g.num_edges, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: reference.edge_sum(g, a, b),
                                    (x, w))
    y = torch.randn(7, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: reference.edge_mean(g, a), (y,))


def test_edge_sum_is_the_plain_sum(monkeypatch):
    monkeypatch.setattr(reference, "CHUNK_BYTES", 64)    # many chunks
    g = _graph(e=50)
    x = torch.randn(7, 5)
    want = torch.zeros(7, 5).index_add_(0, g.dst, x[g.src])
    assert torch.allclose(reference.edge_sum(g, x), want, atol=1e-6)
    deg = torch.bincount(g.dst, minlength=7).clamp(min=1)[:, None]
    assert torch.allclose(reference.edge_mean(g, x), want / deg, atol=1e-6)


def test_edge_softmax_sums_to_one_per_node():
    g = _graph(e=40)
    a = reference.edge_softmax(g, torch.randn(g.num_edges, 3))
    s = torch.zeros(7, 3).index_add_(0, g.dst, a)
    has = torch.bincount(g.dst, minlength=7) > 0
    assert torch.allclose(s[has], torch.ones_like(s[has]), atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0 + 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -(1.0 + 2 ** -10), 3.0])
    assert torch.equal(reference.to_tf32(x), want)
    a, b = torch.randn(30, 40), torch.randn(40, 20)
    rel = ((reference.Matmul("tf32")(a, b) - a @ b).abs().max()
           / (a @ b).abs().max())
    assert 1e-5 < float(rel) < 5e-3


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port_on_the_cpu(name):
    cell = tiny_cell(name)
    p = harness.prepare(cell, 2 ** 33 + 7, torch.device("cpu"), 0.0)
    harness.free_program(p)
    ref = harness.reference_run(p)
    got = compare.readings(p.prog, ref, p.params0)
    assert got["logits"] < 2e-5 and got["loss"] < 2e-6, got
    assert got["grad"] < 2e-5 and got["change"] < 1e-3, got
    # and the numbers separate the TF32 control from the program
    ctl = compare.readings(harness.reference_run(p, "tf32"), ref, p.params0)
    assert max(ctl["logits"], ctl["grad"]) > 10 * max(got["logits"],
                                                      got["grad"]), ctl
