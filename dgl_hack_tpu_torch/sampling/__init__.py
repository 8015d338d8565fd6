"""Minibatch sampling, as ``dgl_hack_tpu.sampling``: neighbor sampling
into blocks and negative sampling.  Random walks, PinSAGE and the
nodeflow sampler are not ported yet (ROADMAP: 'sampling')."""
from .negative import ChunkedNegativeSampler, uniform_negative_edges
from .neighbor import (EdgeSampler, GraphDataLoader,
                       MultiLayerNeighborSampler, NodeDataLoader,
                       sample_layer_neighbors, sample_neighbors, select_topk)

__all__ = ["sample_neighbors", "MultiLayerNeighborSampler", "NodeDataLoader",
           "GraphDataLoader", "select_topk", "sample_layer_neighbors",
           "EdgeSampler", "uniform_negative_edges", "ChunkedNegativeSampler"]
