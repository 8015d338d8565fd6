"""Graph (de)serialization, as ``dgl_hack_tpu.data.io`` (reference:
python/dgl/data/graph_serialize.py): a plain ``.npz`` of structure arrays
and feature frames, in exactly the JAX module's layout, so that each
package reads the other's files.

A graph on the card is written from host copies; ``load_*`` return host
graphs (``Graph.to`` / ``HeteroGraph.to`` move them).
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import Graph, _build


def _host(v) -> np.ndarray:
    """A feature (tensor on any device, or array-like) as a host array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _npz(path) -> str:
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def save_graphs(path: str, graphs: Sequence[Graph],
                labels: Dict[str, np.ndarray] | None = None) -> None:
    """Save a list of graphs (+ optional label arrays) to ``path``."""
    if isinstance(graphs, Graph):
        graphs = [graphs]
    payload: Dict[str, np.ndarray] = {}
    meta = []
    for i, g in enumerate(graphs):
        s, d = g.host_edges()
        payload[f"g{i}_src"] = s
        payload[f"g{i}_dst"] = d
        gm = {"num_src": g.num_src_nodes, "num_dst": g.num_dst_nodes,
              "is_block": g.is_block,
              "ndata": sorted(g._node_frames[0].keys()),
              "edata": sorted(g._edge_frame.keys())}
        for k in gm["ndata"]:
            payload[f"g{i}_n_{k}"] = _host(g._node_frames[0][k])
        for k in gm["edata"]:
            payload[f"g{i}_e_{k}"] = _host(g.edata[k])
        meta.append(gm)
    if labels:
        for k, v in labels.items():
            payload[f"label_{k}"] = _host(v)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"graphs": meta,
                    "labels": sorted(labels.keys()) if labels else []}
                   ).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_graphs(path: str) -> Tuple[List[Graph], Dict[str, np.ndarray]]:
    with np.load(_npz(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        graphs = []
        for i, gm in enumerate(meta["graphs"]):
            g = _build(z[f"g{i}_src"], z[f"g{i}_dst"], gm["num_src"],
                       gm["num_dst"], is_block=gm["is_block"])
            for k in gm["ndata"]:
                g._node_frames[0][k] = torch.from_numpy(z[f"g{i}_n_{k}"])
            for k in gm["edata"]:
                g.edata[k] = torch.from_numpy(z[f"g{i}_e_{k}"])
            graphs.append(g)
        labels = {k: z[f"label_{k}"] for k in meta["labels"]}
    return graphs, labels


def save_heterograph(path: str, hg) -> None:
    """Serialize a HeteroGraph (reference: heterograph pickling,
    src/graph/pickle.cc) to npz."""
    payload = {}
    meta = {"ntypes": {}, "etypes": []}
    for nt in hg.ntypes:
        meta["ntypes"][nt] = hg.num_nodes(nt)
        for k in hg.nodes_data(nt).keys():
            payload[f"n_{nt}_{k}"] = _host(hg.nodes_data(nt)[k])
    for i, c in enumerate(hg.canonical_etypes):
        s, d = hg.relations[c].host_edges()
        payload[f"e{i}_src"] = s
        payload[f"e{i}_dst"] = d
        meta["etypes"].append(list(c))
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_heterograph(path: str):
    from ..core.heterograph import heterograph
    with np.load(_npz(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        data = {}
        for i, c in enumerate(meta["etypes"]):
            data[tuple(c)] = (z[f"e{i}_src"], z[f"e{i}_dst"])
        hg = heterograph(data, num_nodes_dict=meta["ntypes"])
        for nt in meta["ntypes"]:
            for key in z.files:
                pref = f"n_{nt}_"
                if key.startswith(pref):
                    hg.nodes_data(nt)[key[len(pref):]] = \
                        torch.from_numpy(z[key])
    return hg
