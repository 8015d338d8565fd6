"""``correct`` comes out false where the timed path is broken underneath
a run (the harness's look for a card skipped, the port's CPU path at a
tiny size): a step that returns its state unchanged, half of the
training nodes left out of the loss's mean, an answer altered where it is
produced.  And the control, the reference in TF32 in the program's
place, fails one of each cell's numbers."""
import pytest
import torch

import dgl_hack_tpu_torch.models.training as training
import dgl_hack_tpu_torch.nn.conv as conv
from gnnbench import compare, harness
from conftest import CELLS, tiny_cell


def _state_unchanged(monkeypatch, name):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch, name):
    real = training.masked_cross_entropy

    def half(logits, labels, mask):
        idx = torch.nonzero(mask)[:, 0]
        kept = torch.zeros_like(mask)
        kept[idx[:idx.numel() // 2]] = True
        return real(logits, labels, kept)
    monkeypatch.setattr(training, "masked_cross_entropy", half)


def _answer_altered(monkeypatch, name):
    op = "gat_attention" if name.startswith("gat") else "gspmm"
    real = getattr(conv, op)

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[0] += 1.0                      # one row of the aggregate wrong
        return out
    monkeypatch.setattr(conv, op, altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    fault(monkeypatch, name)
    res, _ = harness.run_cell(cell, 77, 0.05, False, "cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    p = harness.prepare(cell, 2 ** 32 + 3, torch.device("cpu"), 0.0)
    harness.free_program(p)
    ref = harness.reference_run(p)
    numbers = compare.readings(harness.reference_run(p, "tf32"), ref,
                               p.params0)
    ok, checks = compare.judge(numbers, cell.limits)
    assert not ok, checks
