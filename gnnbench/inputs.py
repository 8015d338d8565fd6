"""What a cell feeds both sides: the graph, features, labels and training
mask made from ``--seed``, the weights, and the seeds of each draw."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draws named ``tag`` under the run's ``seed``
    (any whole number): different tags draw independently."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(subseed(seed, tag))
    return gen


@dataclass
class GraphData:
    """A node-classification input on the device: the edges (src, dst) in
    the generator's order, int64; x (N, F) float32; labels (N,) int64; the
    training mask (N,) bool."""
    src: Tensor
    dst: Tensor
    x: Tensor
    labels: Tensor
    train_mask: Tensor
    num_nodes: int
    num_classes: int

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())

    @property
    def in_feats(self) -> int:
        return int(self.x.shape[1])


def make_weights(specs: List[Tuple[str, Tuple[int, ...], float]], seed: int,
                 device) -> Dict[str, Tensor]:
    """Initial weights by name from ``specs`` (name, shape, std): a normal
    draw scaled by std, or zeros where std is 0.  One draw on the device
    for all of them."""
    total = sum(_numel(shape) for _, shape, std in specs if std > 0)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device)
    out, off = {}, 0
    for name, shape, std in specs:
        n = _numel(shape)
        if std > 0:
            out[name] = (flat[off:off + n] * std).view(shape).clone()
            off += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
