"""Full-graph node-classification training, as
``dgl_hack_tpu.models.training``: one untimed warm-up step, then
``num_epochs - 1`` timed steps of forward, masked cross-entropy and an
AdamW update.

``torch.optim.AdamW`` with eps 1e-8 applies the same update as
``optax.adamw``: decoupled weight decay lr*wd*p plus the bias-corrected
Adam step, on every parameter.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    come from a ``torch.Generator`` seeded with ``seed``."""
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
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(logits_of(True), labels, train_mask)
        loss.backward()
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
