"""Operations of a dense layer's products, float32: x (M, K) @ W.T (K, N)
forward; backward dW, and dx where the input needs a gradient."""
from __future__ import annotations


def linear(rows: int, fan_in: int, fan_out: int, input_grad: bool):
    """(forward ops, backward ops)."""
    one = 2 * rows * fan_in * fan_out
    return one, one * (2 if input_grad else 1)


def adamw_bytes(num_params: int) -> int:
    """The optimizer's compulsory traffic: parameters, gradients and both
    moments read, parameters and moments written, float32."""
    return num_params * 4 * 7
