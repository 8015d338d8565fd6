"""Full-graph node-classification training, as
``dgl_hack_tpu.models.training``: one untimed warm-up step, then
``num_epochs - 1`` timed steps of forward, masked cross-entropy and an
AdamW update.  Graph classification over batches of graphs, as the loop
of ``examples/train_gin.py``: cross-entropy of the log-softmax, Adam.

``torch.optim.AdamW`` with eps 1e-8 applies the same update as
``optax.adamw``: decoupled weight decay lr*wd*p plus the bias-corrected
Adam step, on every parameter; ``torch.optim.Adam`` with eps 1e-8 that of
``optax.adam``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span

Tensor = torch.Tensor


def masked_cross_entropy(logits: Tensor, labels: Tensor,
                         mask: Tensor) -> Tensor:
    logp = F.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def masked_accuracy(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    pred = logits.argmax(-1)
    m = mask.to(torch.float32)
    ok = (pred == labels).to(torch.float32) * m
    return ok.sum() / m.sum().clamp(min=1.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def node_classifier_step(model: torch.nn.Module, g, feats, labels,
                         train_mask, *, lr: float = 1e-2,
                         weight_decay: float = 5e-4, seed: int = 0,
                         model_args: tuple = (),
                         model_kwargs: Optional[dict] = None,
                         device="cuda") -> Tuple[Callable[[], Tensor],
                                                 Callable[..., tuple]]:
    """The training step of ``train_node_classifier``, for callers that
    drive (or profile) the steps themselves.

    Moves the model, graph and inputs to ``device`` (the card unless the
    caller asks for the CPU; with no card, "cuda" raises rather than
    falling back), makes any parameters still uninitialised (lazy layers)
    by one forward pass, builds AdamW and returns ``(train_step,
    evaluate)``: ``train_step()`` takes one step of forward, masked
    cross-entropy, backward and update and returns the loss;
    ``evaluate(*masks)`` returns the accuracy on each mask.  Dropout draws
    come from a ``torch.Generator`` seeded with ``seed``.  A step opens
    the spans ``trainer.forward``, ``trainer.loss``, ``trainer.backward``
    and ``trainer.optimizer`` (``utils/profiling.py``)."""
    model_kwargs = model_kwargs or {}
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_node_classifier: no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    if g.device != device:
        g = g.to(device)

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    feats = None if feats is None else dev(feats, torch.float32)
    labels = dev(labels, torch.int64)
    train_mask = dev(train_mask, torch.bool)
    model = model.to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def logits_of(train: bool) -> Tensor:
        return model(g, *model_args, feats, deterministic=not train,
                     generator=gen if train else None, **model_kwargs)

    model.eval()
    with torch.no_grad():
        logits_of(False)                    # materialise lazy parameters
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay, eps=1e-8)

    def train_step() -> Tensor:
        with span("trainer.optimizer"):
            opt.zero_grad(set_to_none=True)
        with span("trainer.forward"):
            model.train()
            logits = logits_of(True)
        with span("trainer.loss"):
            loss = masked_cross_entropy(logits, labels, train_mask)
        # the (N, C) logits go before the backward, as a temporary would
        del logits
        with span("trainer.backward"):
            loss.backward()
        with span("trainer.optimizer"):
            opt.step()
        return loss.detach()

    @torch.no_grad()
    def evaluate(*masks) -> tuple:
        model.eval()
        logits = logits_of(False)
        return tuple(float(masked_accuracy(logits, labels,
                                           dev(m, torch.bool)))
                     for m in masks)
    return train_step, evaluate


def train_node_classifier(model: torch.nn.Module, g, feats, labels,
                          train_mask, val_mask, test_mask, *,
                          num_epochs: int = 200, lr: float = 1e-2,
                          weight_decay: float = 5e-4, seed: int = 0,
                          model_args: tuple = (),
                          model_kwargs: Optional[dict] = None,
                          log_every: int = 0, early_stop_patience: int = 0,
                          device="cuda") -> Dict[str, Any]:
    """Train ``model`` on graph ``g``; returns accuracies, epoch timing and
    the per-step losses (warm-up step first).

    Runs on ``device``, the card unless the caller asks for the CPU
    (``device="cpu"``); with no card, "cuda" raises rather than falling
    back.  The graph and numpy inputs are moved there.  Each step is
    ``node_classifier_step``'s."""
    device = torch.device(device)
    train_step, accuracy = node_classifier_step(
        model, g, feats, labels, train_mask, lr=lr,
        weight_decay=weight_decay, seed=seed, model_args=model_args,
        model_kwargs=model_kwargs, device=device)
    masks = tuple(torch.as_tensor(m, dtype=torch.bool).to(device)
                  for m in (train_mask, val_mask, test_mask))

    def evaluate():
        return accuracy(*masks)

    losses = [train_step()]                 # warm-up, outside the clock
    _sync(device)
    best_val, best_test, patience = 0.0, 0.0, 0
    t0 = time.perf_counter()
    for epoch in range(1, num_epochs):
        losses.append(train_step())
        if log_every and epoch % log_every == 0:
            tr, va, te = evaluate()
            print(f"epoch {epoch:4d} loss {float(losses[-1]):.4f} "
                  f"train {tr:.4f} val {va:.4f} test {te:.4f}")
        if early_stop_patience:
            _, va, te = evaluate()
            if va > best_val:
                best_val, best_test, patience = va, te, 0
            else:
                patience += 1
                if patience >= early_stop_patience:
                    break
    _sync(device)
    train_time = time.perf_counter() - t0

    tr, va, te = evaluate()
    return {"model": model,
            "losses": [float(v) for v in losses],
            "train_acc": tr, "val_acc": va, "test_acc": te,
            "best_test_acc": best_test if early_stop_patience else te,
            "train_time_s": train_time,
            "epochs_per_s": (num_epochs - 1) / max(train_time, 1e-9)}


def graph_batches(ds, lo: int, hi: int, batch_size: int, device="cuda"):
    """(batched graph, features, labels) of graphs ``lo``..``hi`` of a
    ``GraphClassificationDataset`` in whole batches (a last partial batch
    is dropped, as in ``examples/train_gin.py``), on ``device``."""
    from ..core.batch import batch
    device = torch.device(device)
    out = []
    for i in range(lo, hi - batch_size + 1, batch_size):
        bg = batch(ds.graphs[i:i + batch_size]).to(device)
        x = torch.from_numpy(np.concatenate(ds.features[i:i + batch_size]))
        y = torch.from_numpy(ds.labels[i:i + batch_size]).long()
        out.append((bg, x.to(device), y.to(device)))
    return out


def graph_classifier_step(model: torch.nn.Module, example_batch, *,
                          lr: float = 5e-3, device="cuda"):
    """The training step of ``train_graph_classifier``: moves the model to
    ``device`` (the card unless the caller asks for the CPU; with no card,
    "cuda" raises), makes its lazy parameters by one forward over
    ``example_batch`` (bg, x, y), builds Adam and returns ``(train_step,
    accuracy)``: ``train_step(bg, x, y)`` takes one step of forward,
    cross-entropy of the log-softmax, backward and update and returns the
    loss; ``accuracy(bg, x, y)`` the batch's accuracy."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("graph classification: no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    model = model.to(device)
    model.eval()
    with torch.no_grad():
        model(*example_batch[:2])           # materialise lazy parameters
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)

    def train_step(bg, x, y) -> Tensor:
        model.train()
        opt.zero_grad(set_to_none=True)
        logp = F.log_softmax(model(bg, x), -1)
        loss = -logp.gather(-1, y[:, None])[:, 0].mean()
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def accuracy(bg, x, y) -> float:
        model.eval()
        return float((model(bg, x).argmax(-1) == y).float().mean())
    return train_step, accuracy


def train_graph_classifier(model: torch.nn.Module, ds, *, epochs: int = 40,
                           batch_size: int = 16, lr: float = 5e-3,
                           train_frac: float = 0.8,
                           device="cuda") -> Dict[str, Any]:
    """Train ``model`` on the first ``train_frac`` of the dataset's graphs
    in batches, ``epochs`` passes, and test it on the rest: the loop of
    ``examples/train_gin.py``.  Returns the per-step losses, the mean
    test-batch accuracy and the training time (every step, the first
    included, ending in a synchronise)."""
    device = torch.device(device)
    n_train = int(train_frac * len(ds.graphs))
    train_b = graph_batches(ds, 0, n_train, batch_size, device)
    test_b = graph_batches(ds, n_train, len(ds.graphs), batch_size, device)
    train_step, accuracy = graph_classifier_step(model, train_b[0], lr=lr,
                                                 device=device)
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        for b in train_b:
            losses.append(train_step(*b))
    _sync(device)
    train_time = time.perf_counter() - t0
    test_acc = float(np.mean([accuracy(*b) for b in test_b]))
    return {"model": model, "losses": [float(v) for v in losses],
            "test_acc": test_acc, "train_time_s": train_time}
