"""Minibatch sampling, as ``dgl_hack_tpu.sampling``: neighbor sampling
into blocks (through the native host sampler), random walks, the PinSAGE
samplers, negative sampling and ``NodeFlow``."""
from .negative import ChunkedNegativeSampler, uniform_negative_edges
from .neighbor import (EdgeSampler, GraphDataLoader,
                       MultiLayerNeighborSampler, NodeDataLoader,
                       sample_layer_neighbors, sample_neighbors, select_topk)
from .nodeflow import NodeFlow
from .pinsage import PinSAGESampler, RandomWalkNeighborSampler
from .randomwalk import (metapath_random_walk, node2vec_random_walk,
                         pack_traces, random_walk, random_walk_with_restart)

__all__ = ["sample_neighbors", "MultiLayerNeighborSampler", "NodeDataLoader",
           "GraphDataLoader", "select_topk", "sample_layer_neighbors",
           "EdgeSampler", "random_walk", "node2vec_random_walk",
           "random_walk_with_restart", "metapath_random_walk", "pack_traces",
           "uniform_negative_edges", "ChunkedNegativeSampler",
           "RandomWalkNeighborSampler", "PinSAGESampler", "NodeFlow"]
