"""Feature initializers (reference: python/dgl/init.py), as
``dgl_hack_tpu.core.init``."""
from __future__ import annotations

import torch


def zero_initializer(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def base_initializer(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)
