"""Parameter conversion between the JAX package and the port.

A flax params tree, given as nested dicts of numpy arrays (``{"params":
{"layer0": {"weight": ..., "bias": ...}}}``), becomes the port's
``state_dict``: keys join the tree path with dots.  Dense ``kernel (in,
out)`` becomes ``nn.Linear``'s ``weight (out, in)``; every other leaf
(``GraphConv.weight (in, out)``, ``bias``, ``attn_l``/``attn_r (1, H, D)``)
keeps its name and layout.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree (nested dicts of arrays) -> port state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
                continue
            arr = np.array(leaf, dtype=np.float32)
            if name == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(arr.T.copy())
            else:
                out[f"{prefix}{name}"] = torch.from_numpy(arr)

    walk(params, "")
    return out


def state_dict_to_flax(state: Mapping[str, torch.Tensor],
                       dense_modules=()) -> Dict:
    """Inverse of ``flax_to_state_dict``.  ``dense_modules`` names the
    sub-modules that are flax ``Dense`` layers (``nn.Linear`` here, e.g.
    ``"gat0.fc"``): their ``weight`` goes back to ``kernel (in, out)``."""
    tree: Dict = {}
    dense = set(dense_modules)
    for key, val in state.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight" and ".".join(path) in dense:
            leaf, arr = "kernel", arr.T.copy()
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return {"params": tree}


def dense_module_names(model: torch.nn.Module):
    """Names of a model's ``nn.Linear`` sub-modules (flax ``Dense``)."""
    return [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)]
