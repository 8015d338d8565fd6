"""Segment reductions in plain torch: the composed path of gspmm and
edge_softmax.

Conventions match the JAX package (and DGL):

* ``mean`` = sum / clamp(count, 1);
* ``max``/``min`` over an empty segment give 0, not +-inf;
* ``prod`` over an empty segment gives 1;
* integer data take the dtype's limits where float data take +-inf, so an
  empty integer segment gives ``iinfo.min`` (max) or ``iinfo.max`` (min),
  as ``jax.ops.segment_max``/``segment_min`` give it;
* ids outside ``[0, num_segments)`` are dropped, as ``jax.ops.segment_*``
  drop them: each reduction writes into one spare row past the end, where
  every such id is sent by a ``torch.where``, and cuts it off, so that no
  id is checked on the host and none reaches ``index_add`` or
  ``scatter_reduce`` out of range (on the card that would be a
  device-side assert).
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

_REDUCERS = ("sum", "mean", "max", "min", "prod")


def _expand(x: Tensor, ref: Tensor) -> Tensor:
    """Broadcast a (E,) vector against trailing feature dims of ``ref``."""
    return x.reshape(x.shape + (1,) * (ref.dim() - 1))


def _lowest(dtype: torch.dtype):
    """The identity of max: -inf, or the integer dtype's least value."""
    return -float("inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _highest(dtype: torch.dtype):
    """The identity of min: +inf, or the integer dtype's greatest value."""
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def _in_range(segment_ids: Tensor, num_segments: int) -> Tensor:
    """``segment_ids`` with every id outside ``[0, num_segments)`` sent to
    the spare row ``num_segments``."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(ok, segment_ids, num_segments)


def _scatter(data: Tensor, segment_ids: Tensor, num_segments: int,
             how: str, init: float) -> Tensor:
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), init,
                     dtype=data.dtype, device=data.device)
    idx = _in_range(segment_ids.long(), num_segments)
    idx = _expand(idx, data).expand_as(data)
    return out.scatter_reduce(0, idx, data, how,
                              include_self=True)[:num_segments]


def segment_sum(data: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, _in_range(segment_ids, num_segments),
                         data)[:num_segments]


def segment_mean(data: Tensor, segment_ids: Tensor,
                 num_segments: int) -> Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones_like(segment_ids, dtype=data.dtype),
                      segment_ids, num_segments)
    return s / _expand(cnt.clamp(min=1), s)


def segment_max(data: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    m = _scatter(data, segment_ids, num_segments, "amax",
                 _lowest(data.dtype))
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def segment_min(data: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    m = _scatter(data, segment_ids, num_segments, "amin",
                 _highest(data.dtype))
    return torch.where(torch.isposinf(m), torch.zeros_like(m), m)


def segment_prod(data: Tensor, segment_ids: Tensor,
                 num_segments: int) -> Tensor:
    return _scatter(data, segment_ids, num_segments, "prod", 1.0)


def segment_softmax(data: Tensor, segment_ids: Tensor,
                    num_segments: int) -> Tensor:
    """Numerically stable per-segment softmax over ``data``'s leading axis:
    segment max -> subtract -> exp -> segment sum -> divide."""
    m = segment_max(data.detach(), segment_ids, num_segments)
    e = torch.exp(data - m[segment_ids])
    s = segment_sum(e, segment_ids, num_segments)
    return e / s.clamp(min=torch.finfo(data.dtype).tiny)[segment_ids]


_SEGMENT_FNS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
    "prod": segment_prod,
}


def apply_identity_mask(reducer: str, data: Tensor, mask: Tensor) -> Tensor:
    """Replace masked-out rows with the reducer's identity element."""
    ident = {"sum": 0, "mean": 0, "max": _lowest(data.dtype),
             "min": _highest(data.dtype), "prod": 1}
    if reducer not in ident:
        raise ValueError(f"unknown reducer {reducer!r}")
    fill = torch.full((), ident[reducer], dtype=data.dtype,
                      device=data.device)
    return torch.where(_expand(mask, data), data, fill)


def segment_reduce(reducer: str, data: Tensor, segment_ids: Tensor,
                   num_segments: int, indices_are_sorted: bool = False,
                   mask: Optional[Tensor] = None) -> Tensor:
    """Dispatch a named reducer; ``mask`` (E,) bool drops padded entries,
    which contribute the reducer's identity (and are not counted by
    ``mean``).  ``indices_are_sorted`` is the JAX package's hint that
    ``segment_ids`` are non-decreasing; it is accepted and changes no
    result (sums over sorted runs on the card go through K1's edge-row
    mode, ``ops/cuda/spmm_kernel.py:segment_sum_rows``)."""
    if reducer not in _SEGMENT_FNS:
        raise ValueError(
            f"unknown reducer {reducer!r}; expected one of {_REDUCERS}")
    if mask is not None:
        data = apply_identity_mask(reducer, data, mask)
        if reducer == "mean":
            s = segment_sum(data, segment_ids, num_segments)
            cnt = segment_sum(mask.to(data.dtype), segment_ids, num_segments)
            return s / _expand(cnt.clamp(min=1), s)
    return _SEGMENT_FNS[reducer](data, segment_ids, num_segments)


def bincount(ids: Tensor, weights: Optional[Tensor], length: int) -> Tensor:
    """float32 counts of each id in ``[0, length)``, or the sums of
    ``weights`` per id; other ids are dropped (``jax.ops.segment_sum`` in
    the JAX package, which is no TPU kernel; plain torch on either
    device)."""
    w = torch.ones(ids.shape, dtype=torch.float32, device=ids.device) \
        if weights is None else weights
    return segment_sum(w, ids.long(), length)
