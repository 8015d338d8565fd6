"""Host-resident feature store with per-batch pulls to the card, as
``dgl_hack_tpu.distributed.feature_store`` (reference: the shared-memory
graph store, contrib/graph_store.py:270 SharedMemoryStoreServer, and the
KVStore pull path for features larger than the card, dis_kvstore.py and
DGL-KE's --mix_cpu_gpu).

Features stay in host memory (optionally memory-mapped .npy files, the
shared-memory analogue: several processes map the same pages); a batch's
rows are gathered on the host and copied to the card through a pinned
buffer.  ``save_shared_graph``/``attach_shared_graph`` do the same for a
graph's structure arrays: workers attach read-only maps without copying.
"""
from __future__ import annotations

import json
import warnings
from typing import Dict, Optional

import numpy as np
import torch


class FeatureStore:
    """dict of host arrays with a row-pull API."""

    def __init__(self, arrays: Optional[Dict[str, np.ndarray]] = None):
        self._arrays: Dict[str, np.ndarray] = dict(arrays or {})

    @classmethod
    def from_mmap(cls, paths: Dict[str, str]) -> "FeatureStore":
        """Memory-map .npy files: the shared-memory multi-process analogue
        (several worker processes map the same pages)."""
        return cls({k: np.load(p, mmap_mode="r") for k, p in paths.items()})

    def add(self, name: str, arr: np.ndarray) -> None:
        self._arrays[name] = arr

    def save(self, prefix: str) -> Dict[str, str]:
        paths = {}
        for k, v in self._arrays.items():
            paths[k] = f"{prefix}.{k}.npy"
            np.save(paths[k], np.asarray(v))
        return paths

    def pull(self, name: str, rows, to_device: bool = True, device="cuda"):
        """Gather rows on the host; with ``to_device``, a tensor on
        ``device`` (copied to a card through pinned memory, queued on the
        current stream), else the numpy rows."""
        out = np.asarray(self._arrays[name])[np.asarray(rows)]
        if not to_device:
            return out
        device = torch.device(device)
        t = torch.from_numpy(np.ascontiguousarray(out))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def push_add(self, name: str, rows, values) -> None:
        """Sparse-row accumulate (the KVClient.push 'sum' handler,
        reference: dis_kvstore.py:956); ``values`` a numpy array or a
        tensor on either device."""
        arr = self._arrays[name]
        if not arr.flags.writeable:
            raise ValueError(f"feature {name!r} is read-only (mmap'ed)")
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        np.add.at(arr, np.asarray(rows), np.asarray(values))

    def __contains__(self, name):
        return name in self._arrays

    def __getitem__(self, name):
        return self._arrays[name]


# ---------------------------------------------------------------------------
# shared graph STRUCTURE store (reference: ImmutableGraph::CopyToSharedMem,
# include/dgl/immutable_graph.h:942 + SharedMemoryDGLGraph workers,
# contrib/graph_store.py:517)
# ---------------------------------------------------------------------------
_GRAPH_FIELDS = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids",
                 "int2user", "user2int")


def save_shared_graph(prefix: str, g) -> Dict[str, str]:
    """Write the graph's structure arrays as .npy files for multi-process
    page sharing (the mmap analogue of the reference's named-shm CSR).
    Returns {field: path} plus a 'meta' entry; the files are the JAX
    package's."""
    paths: Dict[str, str] = {}
    for f in _GRAPH_FIELDS:
        v = g.host(f)
        if v is not None:
            paths[f] = f"{prefix}.{f}.npy"
            np.save(paths[f], v)
    meta_path = f"{prefix}.graphmeta.json"
    with open(meta_path, "w") as fh:
        json.dump({"num_src": g.num_src_nodes, "num_dst": g.num_dst_nodes,
                   "is_block": g.is_block,
                   "fields": sorted(paths)}, fh)
    paths["meta"] = meta_path
    return paths


def attach_shared_graph(prefix: str):
    """Attach to a saved graph WITHOUT copying: every structure array is a
    read-only map, shared through the page cache across sampler
    processes (the SharedMemoryDGLGraph worker role).  The graph is on the
    CPU, its tensors views of the maps and its host cache the maps
    themselves, which is what samplers, planners and transforms read;
    ``Graph.to`` copies it to a card."""
    from ..core.graph import Graph
    with open(f"{prefix}.graphmeta.json") as fh:
        meta = json.load(fh)
    arrays = {f: np.load(f"{prefix}.{f}.npy", mmap_mode="r")
              for f in meta["fields"]}
    with warnings.catch_warnings():
        # a tensor over a read-only map: the graph never writes its
        # structure
        warnings.simplefilter("ignore", UserWarning)
        tensors = {f: torch.from_numpy(a) for f, a in arrays.items()}
    return Graph(num_src=meta["num_src"], num_dst=meta["num_dst"],
                 is_block=meta["is_block"], host_cache=dict(arrays),
                 **tensors)
