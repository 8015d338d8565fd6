"""flax's initialisers and its ``Dense`` layer, in torch.

The JAX package's layers initialise as flax does: ``Dense`` kernels
lecun-normal (a normal truncated at two standard deviations) unless a
layer names ``xavier`` (glorot-uniform), recurrent kernels orthogonal,
biases zero.  The port draws from the same distributions, so that its
models train as the JAX examples do.  Fans are flax's: a kernel of shape
(..., in, out) has fan_in = in * prod(...), fan_out = out * prod(...).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

Tensor = torch.Tensor

# flax's truncated normal divides the standard deviation by the standard
# deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def fans(shape: Sequence[int]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a flax-layout kernel (..., in, out)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


@torch.no_grad()
def lecun_normal_(t: Tensor, fan_in: int) -> Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


@torch.no_grad()
def glorot_uniform_(t: Tensor, fan_in: int, fan_out: int) -> Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit)


@torch.no_grad()
def orthogonal_blocks_(t: Tensor, block: int) -> Tensor:
    """Each (block, cols) row block of t orthogonal, as flax initialises
    each gate's recurrent kernel of a stacked GRU/LSTM weight."""
    for i in range(0, t.shape[0], block):
        nn.init.orthogonal_(t[i:i + block])
    return t


def bias_keep(size: int, dropped: slice) -> Tensor:
    """A (size,) mask of ones with zeros at ``dropped``: multiplied into a
    stacked torch cell bias, it removes the gates' biases that flax's GRU
    and LSTM cells lack (they then get a zero gradient and stay 0 under
    Adam and AdamW)."""
    keep = torch.ones(size)
    keep[dropped] = 0.0
    return keep


KERNEL_INITS = ("lecun_normal", "xavier")


class GRUCell(nn.GRUCell):
    """flax's ``GRUCell`` as an ``nn.GRUCell`` (stacked gates r, z, n):
    lecun-normal input kernels, orthogonal recurrent kernels, zero biases.
    flax's ``hr`` and ``hz`` have no bias, so the first two thirds of
    ``bias_hh`` are masked out (``bias_keep``).  Called as ``nn.GRUCell``
    is, ``cell(input, hx)``, it returns the new hidden state (flax's
    carry)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size)
        lecun_normal_(self.weight_ih, input_size)
        orthogonal_blocks_(self.weight_hh, hidden_size)
        nn.init.zeros_(self.bias_ih)
        nn.init.zeros_(self.bias_hh)
        self.register_buffer("hh_bias_keep", bias_keep(
            3 * hidden_size, slice(0, 2 * hidden_size)), persistent=False)

    def forward(self, input: Tensor, hx: Tensor) -> Tensor:
        return torch.gru_cell(input, hx, self.weight_ih, self.weight_hh,
                              self.bias_ih, self.bias_hh * self.hh_bias_keep)


class Dense(nn.LazyLinear):
    """flax's ``Dense``: the input width is taken from the first call, the
    kernel is lecun-normal (``kernel_init="xavier"``: glorot-uniform) and
    the bias zero.  An ``nn.Linear`` (weight (out, in)) once materialised,
    so ``interop`` converts it as one."""

    cls_to_become = None

    def __init__(self, out_features: int, bias: bool = True,
                 kernel_init: str = "lecun_normal"):
        if kernel_init not in KERNEL_INITS:
            raise ValueError(f"kernel_init {kernel_init!r}; expected one of "
                             f"{KERNEL_INITS}")
        self.kernel_init = kernel_init
        super().__init__(out_features, bias=bias)

    def reset_parameters(self) -> None:
        if self.has_uninitialized_params() or self.in_features == 0:
            return
        if self.kernel_init == "xavier":
            glorot_uniform_(self.weight, self.in_features, self.out_features)
        else:
            lecun_normal_(self.weight, self.in_features)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
