"""The plain reference's shared parts, in plain PyTorch.  Nothing here
imports the port, JAX or the JAX package.

* ``RefGraph``: the edges in the order of the stable sort on dst (the
  order in which a per-edge draw is laid out), and the in-degrees;
* ``edge_sum``: out[v] = sum over v's in-edges (u, v) of w[e] * x[u],
  summed in float64 and rounded once, so that the reference carries no
  float32 summation error of its own (a hub row sums 10^5 terms);
* ``edge_softmax``, ``dropout``, ``masked_cross_entropy``;
* ``Matmul``: the dense product in float32, or in TF32 (the control:
  both operands rounded to TF32's 10-bit mantissa, to nearest with ties
  away from zero as the tensor cores convert, float32 sums; the
  backward's products too);
* ``train``: the first steps of full-graph training (forward, masked
  cross-entropy, backward, AdamW by hand), given a configuration's
  ``forward``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

Tensor = torch.Tensor
# edges a chunk of ``edge_sum``: about 1 GiB of float64 messages
CHUNK_BYTES = 1 << 30


class RefGraph:
    """(src, dst) sorted stably on dst, with in-degrees (int64)."""

    def __init__(self, src: Tensor, dst: Tensor, num_nodes: int):
        order = torch.sort(dst, stable=True).indices
        self.src = src[order]
        self.dst = dst[order]
        self.num_nodes = int(num_nodes)
        self.in_deg = torch.bincount(self.dst, minlength=self.num_nodes)

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())


def _chunk(E: int, row_elems: int) -> int:
    return max(1, min(E, CHUNK_BYTES // (8 * max(row_elems, 1))))


def _sum_into(n: int, x: Tensor, w: Optional[Tensor], gather: Tensor,
              scatter: Tensor) -> Tensor:
    """float64 out[scatter[e]] += w[e] * x[gather[e]] over the edges in
    chunks; w (E,) or (E, H) against x (N, ...) or (N, H, D)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.float64,
                      device=x.device)
    E = gather.numel()
    step = _chunk(E, x[0].numel())
    for e0 in range(0, E, step):
        m = x[gather[e0:e0 + step]].double()
        if w is not None:
            ww = w[e0:e0 + step].double()
            m = m * ww.reshape(ww.shape + (1,) * (m.dim() - ww.dim()))
        out.index_add_(0, scatter[e0:e0 + step], m)
    return out


class _EdgeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, src, dst, n_src, n_dst):
        ctx.save_for_backward(x, w, src, dst)
        ctx.n_src = n_src
        return _sum_into(n_dst, x, w, src, dst).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, src, dst = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _sum_into(ctx.n_src, g, w, dst, src).to(x.dtype)
        if w is not None and ctx.needs_input_grad[1]:
            gw = torch.empty_like(w)
            E = src.numel()
            step = _chunk(E, x[0].numel())
            for e0 in range(0, E, step):
                s, d = src[e0:e0 + step], dst[e0:e0 + step]
                prod = g[d].double() * x[s].double()
                gw[e0:e0 + step] = prod.reshape(
                    prod.shape[:w.dim()] + (-1,)).sum(-1).to(w.dtype)
        return gx, gw, None, None, None, None


def edge_sum(g: RefGraph, x: Tensor, w: Optional[Tensor] = None) -> Tensor:
    """out[v] = sum_{e=(u,v)} w[e] * x[u] (w None: 1), in x's dtype."""
    return _EdgeSum.apply(x, w, g.src, g.dst, g.num_nodes, g.num_nodes)


def edge_mean(g: RefGraph, x: Tensor) -> Tensor:
    """The mean of x over each node's in-neighbours (0 without any)."""
    deg = g.in_deg.to(x.dtype).clamp(min=1)
    return edge_sum(g, x) / deg.reshape((-1,) + (1,) * (x.dim() - 1))


def edge_softmax(g: RefGraph, e: Tensor) -> Tensor:
    """Softmax of e (E, H) over each node's in-edges; the denominators
    summed in float64."""
    n, H = g.num_nodes, e.shape[1]
    idx = g.dst[:, None].expand(-1, H)
    m = torch.full((n, H), float("-inf"), dtype=e.dtype, device=e.device)
    m = m.scatter_reduce(0, idx, e.detach(), "amax", include_self=True)
    ex = torch.exp(e - m[g.dst])
    den = torch.zeros((n, H), dtype=torch.float64, device=e.device)
    den = den.index_add(0, g.dst, ex.double())
    return ex / den[g.dst].to(e.dtype)


def dropout(x: Tensor, p: float, draw: Optional[Callable]) -> Tensor:
    """Inverted dropout: keep where a uniform draw is at least p, scaled
    by 1/(1-p); the identity without a draw (evaluation) or at p = 0."""
    if draw is None or p == 0.0:
        return x
    keep = draw(tuple(x.shape)) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def masked_cross_entropy(logits: Tensor, labels: Tensor,
                         mask: Tensor) -> Tensor:
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def to_tf32(t: Tensor) -> Tensor:
    """t (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (the tensor cores' conversion)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).t(), to_tf32(a).t() @ g


class Matmul:
    """a @ b in float32 (``precision="float32"``) or TF32."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, a: Tensor, b: Tensor) -> Tensor:
        if self.precision == "tf32":
            return _Tf32Matmul.apply(a, b)
        return a @ b

    def linear(self, x: Tensor, w: Tensor, b: Optional[Tensor] = None):
        """x @ w.T + b, as ``nn.Linear`` with weight (out, in)."""
        y = self(x, w.t())
        return y if b is None else y + b


@dataclass
class Run:
    """The first steps of a training run: step 1's logits, each step's
    loss, step 1's gradients and the parameters after the last step."""
    logits1: Tensor
    losses: List[float]
    grads1: Dict[str, Tensor]
    params: Dict[str, Tensor]


def adamw_(params: Dict[str, Tensor], grads: Dict[str, Tensor],
           state: Dict[str, tuple], t: int, lr: float, wd: float,
           betas, eps: float) -> None:
    """One AdamW step in place (decoupled weight decay, bias-corrected)."""
    b1, b2 = betas
    for k, p in params.items():
        g = grads[k]
        m, v = state.get(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        denom = v.sqrt() / (1 - b2 ** t) ** 0.5 + eps
        p.mul_(1 - lr * wd).sub_(lr / (1 - b1 ** t) * m / denom)


def train(forward: Callable, cfg: dict, params0: Dict[str, Tensor], data,
          dropout_seed: int, steps: int = 3, matmul: Matmul = None,
          fault: Optional[str] = None) -> Run:
    """``steps`` steps of full-graph training from ``params0``: the
    dropout draws from a generator on the data's device seeded with
    ``dropout_seed``, in the order ``forward`` makes them.  ``fault``
    plants one of the faults the comparison has to catch, for reading it:
    "half_batch" (the loss over the first half of the training nodes) or
    "answer" (1 added to the first training node's first logit)."""
    matmul = matmul or Matmul()
    dev = data.x.device
    g = RefGraph(data.src, data.dst, data.num_nodes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(dropout_seed)

    def draw(shape):
        return torch.rand(shape, generator=gen, device=dev)

    mask = data.train_mask
    first = int(torch.nonzero(mask)[0, 0])
    if fault == "half_batch":
        idx = torch.nonzero(mask)[:, 0]
        mask = torch.zeros_like(mask)
        mask[idx[:idx.numel() // 2]] = True
    elif fault not in (None, "answer"):
        raise ValueError(fault)
    params = {k: v.detach().clone() for k, v in params0.items()}
    state: Dict[str, tuple] = {}
    losses, logits1, grads1 = [], None, None
    cache: dict = {}          # what forward computes once from the inputs
    for t in range(1, steps + 1):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        logits = forward(cfg, leaves, g, data.x, draw, matmul, cache)
        if fault == "answer":
            logits = logits.clone()
            logits[first, 0] += 1.0
        loss = masked_cross_entropy(logits, data.labels, mask)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        losses.append(float(loss.detach()))
        if t == 1:
            logits1 = logits.detach()
            grads1 = {k: v.detach().clone() for k, v in grads.items()}
        params = {k: v.detach() for k, v in leaves.items()}
        with torch.no_grad():
            adamw_(params, grads, state, t, cfg["lr"], cfg["weight_decay"],
                   cfg["adam_betas"], cfg["adam_eps"])
        del logits, loss, grads
    return Run(logits1, losses, grads1, params)

