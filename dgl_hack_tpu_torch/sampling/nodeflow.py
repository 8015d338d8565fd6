"""NodeFlow, as ``dgl_hack_tpu.sampling.nodeflow`` (DGL:
python/dgl/nodeflow.py): the legacy layered minibatch with
``copy_from_parent``, ``block_compute`` and ``prop_flow``, over the list
of bipartite blocks that ``MultiLayerNeighborSampler`` draws.

Node ids stay on the host (numpy); the layers' frames hold tensors on the
blocks' device.  ``block_compute`` is ``update_all`` on one block, so on
the card a builtin sum or mean reaches the segment-sum kernel through the
block's real-edge view, and max/min the segment-max kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.graph import Graph
from ..core.message import apply_edges, update_all

Tensor = torch.Tensor


class _LayerBatch:
    """What an ``apply_layer`` UDF sees: the layer's frame as ``data``."""

    def __init__(self, data: Dict[str, Tensor]):
        self.data = data


class NodeFlow:
    """Layered computation flow: ``num_blocks`` bipartite blocks between
    ``num_layers = num_blocks + 1`` node layers.  layers[0] is the input
    frontier (the outermost sampled nodes); the last layer holds the seeds
    (DGL's layer indexing, include/dgl/nodeflow.h:27-49)."""

    def __init__(self, blocks: Sequence[Graph],
                 layer_node_ids: Sequence[np.ndarray]):
        if len(layer_node_ids) != len(blocks) + 1:
            raise ValueError(f"{len(blocks)} blocks need "
                             f"{len(blocks) + 1} layers of node ids, got "
                             f"{len(layer_node_ids)}")
        self.blocks = list(blocks)
        self._layer_ids = [np.asarray(x) for x in layer_node_ids]
        self._layer_frames = [dict() for _ in self._layer_ids]

    @classmethod
    def from_sampler(cls, g: Graph, seeds, sampler,
                     device="cuda") -> "NodeFlow":
        """Sample the blocks of ``seeds`` with ``sampler``
        (``MultiLayerNeighborSampler``) and move them to ``device``."""
        blocks, input_nodes, seeds = sampler.sample_blocks(g, seeds)
        layer_ids = [input_nodes]
        for blk in blocks:
            layer_ids.append(layer_ids[-1][:blk.num_dst_nodes])
        return cls([b.to(device) for b in blocks], layer_ids)

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def num_layers(self) -> int:
        return len(self._layer_ids)

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def layer_parent_nid(self, layer: int) -> np.ndarray:
        """Parent-graph node ids of a layer."""
        return self._layer_ids[layer]

    def layer_nid(self, layer: int) -> np.ndarray:
        """NodeFlow-local node ids of a layer: consecutive across layers."""
        off = sum(len(self._layer_ids[i]) for i in range(layer))
        return np.arange(off, off + len(self._layer_ids[layer]),
                         dtype=np.int64)

    def map_to_parent_nid(self, nid) -> np.ndarray:
        """NodeFlow-local ids -> parent ids."""
        flat = np.concatenate([np.asarray(x, np.int64)
                               for x in self._layer_ids])
        return flat[np.asarray(nid, np.int64)]

    def map_from_parent_nid(self, layer: int, parent_nid) -> np.ndarray:
        """Parent ids -> NodeFlow-local ids within a layer; -1 where the
        node is not in the layer."""
        ids = np.asarray(self._layer_ids[layer], np.int64)
        lut = {int(p): i for i, p in enumerate(ids)}
        off = int(self.layer_nid(layer)[0]) if len(ids) else 0
        return np.asarray([lut.get(int(p), -1 - off) + off
                           for p in np.asarray(parent_nid).ravel()],
                          np.int64)

    def layer_size(self, layer: int) -> int:
        return len(self._layer_ids[layer])

    def block_size(self, block_id: int) -> int:
        """Real (unmasked) edges in a block."""
        blk = self.blocks[block_id]
        if blk.edge_mask is not None:
            return int(blk.host("edge_mask").sum())
        return blk.num_edges()

    def block_edges(self, block_id: int):
        """(src, dst) endpoints of a block in block-local ids, user order."""
        return self.blocks[block_id].edges(order="eid")

    def block_parent_eid(self, block_id: int) -> np.ndarray:
        """Parent-graph edge ids of a block: the sampler's edata['_ID']."""
        blk = self.blocks[block_id]
        if "_ID" not in blk.edata:
            raise KeyError("block carries no parent eids "
                           "(sampler did not record edata['_ID'])")
        return blk.edata["_ID"].cpu().numpy()

    def layers(self, layer: int) -> Dict[str, Tensor]:
        return self._layer_frames[layer]

    def apply_layer(self, layer: int, func: Callable,
                    inplace: bool = True) -> Dict[str, Tensor]:
        """Apply a node UDF to one layer's frame; the UDF sees ``.data``
        and returns a dict."""
        res = func(_LayerBatch(dict(self._layer_frames[layer])))
        if not isinstance(res, dict):
            raise TypeError("apply_layer UDF must return a dict")
        if inplace:
            self._layer_frames[layer].update(res)
        return res

    def _bind(self, block_id: int) -> Graph:
        """The block with the frames of its two layers attached."""
        blk = self.blocks[block_id]
        blk._node_frames = (dict(self._layer_frames[block_id]),
                            dict(self._layer_frames[block_id + 1]))
        return blk

    def apply_block(self, block_id: int, func: Callable) -> None:
        """Apply an edge function over one block; the results land in the
        block's edge frame."""
        apply_edges(self._bind(block_id), func)

    def copy_from_parent(self, parent_ndata: dict, fields=None) -> None:
        """Gather each layer's rows of the parent's node features (numpy
        arrays or tensors, gathered where they lie) onto the blocks'
        device."""
        for li, ids in enumerate(self._layer_ids):
            for k, v in parent_ndata.items():
                if fields is None or k in fields:
                    v = torch.as_tensor(v)
                    idx = torch.from_numpy(np.asarray(ids, np.int64))
                    self._layer_frames[li][k] = \
                        v[idx.to(v.device)].to(self.device)

    def copy_to_parent(self, parent_ndata: dict, fields=None,
                       layer: int = -1) -> Dict[str, Tensor]:
        """A copy of ``parent_ndata`` with a layer's frame written at its
        parent rows (the parent's tensors are not changed); a field the
        parent lacks gets zeros elsewhere, sized by the parent's first
        field."""
        layer = layer % self.num_layers
        ids = torch.from_numpy(np.asarray(self._layer_ids[layer], np.int64))
        out = dict(parent_ndata)
        for k, v in self._layer_frames[layer].items():
            if fields is not None and k not in fields:
                continue
            if k in out:
                base = torch.as_tensor(out[k])
            elif parent_ndata:
                n = len(next(iter(parent_ndata.values())))
                base = v.new_zeros((n,) + tuple(v.shape[1:]))
            else:
                raise ValueError("copy_to_parent needs a parent frame "
                                 "to size new fields against")
            out[k] = base.index_copy(0, ids.to(base.device),
                                     v.to(base.device, base.dtype))
        return out

    def block_compute(self, block_id: int, message_func, reduce_func,
                      apply_node_func: Optional[Callable] = None) -> None:
        """Message passing from layer ``block_id`` to ``block_id + 1``."""
        blk = self._bind(block_id)
        update_all(blk, message_func, reduce_func, apply_node_func)
        self._layer_frames[block_id + 1].update(blk._node_frames[-1])

    def prop_flow(self, message_func, reduce_func,
                  apply_node_func: Optional[Callable] = None) -> None:
        """``block_compute`` through every block in order."""
        for i in range(self.num_blocks):
            self.block_compute(i, message_func, reduce_func,
                               apply_node_func)
