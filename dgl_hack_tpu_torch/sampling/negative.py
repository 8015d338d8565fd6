"""Negative edge sampling for link prediction, as
``dgl_hack_tpu.sampling.negative``: uniform negative edges, and DGL-KE's
chunked scheme, which corrupts one endpoint of a whole chunk of positive
edges against one shared row of negative nodes."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def uniform_negative_edges(num_nodes: int, num_samples: int,
                           rng: Optional[np.random.Generator] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) of ``num_samples`` edges drawn uniformly over the
    nodes."""
    rng = rng or np.random.default_rng()
    return (rng.integers(0, num_nodes, num_samples).astype(np.int32),
            rng.integers(0, num_nodes, num_samples).astype(np.int32))


class ChunkedNegativeSampler:
    """Per chunk of ``chunk_size`` positive edges, ``neg_sample_size``
    corrupting nodes shared by the chunk; ``mode`` says which endpoint they
    replace ('head' or 'tail')."""

    def __init__(self, neg_sample_size: int, chunk_size: int,
                 mode: str = "tail", seed: Optional[int] = None):
        if mode not in ("head", "tail"):
            raise ValueError(f"mode must be 'head' or 'tail', got {mode!r}")
        self.neg_sample_size = neg_sample_size
        self.chunk_size = chunk_size
        self.mode = mode
        self.rng = np.random.default_rng(seed)

    def sample(self, num_pos: int, num_nodes: int) -> np.ndarray:
        """(num_chunks, neg_sample_size) negative node ids."""
        num_chunks = -(-num_pos // self.chunk_size)
        return self.rng.integers(
            0, num_nodes,
            (num_chunks, self.neg_sample_size)).astype(np.int32)
