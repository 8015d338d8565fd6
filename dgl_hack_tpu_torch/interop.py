"""Parameter conversion between the JAX package and the port.

A flax params tree, given as nested dicts of numpy arrays (``{"params":
{"layer0": {"weight": ..., "bias": ...}}}``), becomes the port's
``state_dict``: keys join the tree path with dots.

* A Dense ``kernel (in, out)`` becomes ``nn.Linear``'s ``weight (out,
  in)``.  An attention kernel is 3-D: ``query``/``key``/``value`` (in, H,
  Dh) and ``out`` (H, Dh, out) are first merged to 2-D over the heads,
  and their (H, Dh) biases flattened.
* A LayerNorm ``scale`` becomes ``weight``; an ``Embed``'s ``embedding``
  (num_embeddings, features) becomes ``nn.Embedding``'s ``weight``, same
  layout.  ``state_dict_to_flax`` takes both back when told which modules
  they are (``embed_modules``, ``norm_modules``).
* A flax ``GRUCell`` (``ir``/``iz``/``in`` with biases, ``hr``/``hz``
  without, ``hn`` with) becomes ``nn.GRUCell``'s stacked ``weight_ih``/
  ``weight_hh`` in gate order r, z, n, with ``bias_hh = [0, 0, b_hn]``.
* A flax LSTM cell (``ii``/``if``/``ig``/``io`` without biases,
  ``hi``/``hf``/``hg``/``ho`` with) becomes ``nn.LSTMCell``'s, in gate
  order i, f, g, o, with ``bias_ih = 0``.
* Every other leaf (``GraphConv.weight (in, out)``, ``bias``,
  ``attn_l``/``attn_r (1, H, D)``, ``eps``, ``RelGraphConv``'s ``weight``,
  ``w_comp``, ``h_bias`` and ``loop_weight``, GMMConv's ``mu`` and
  ``inv_sigma``, AtomicConv's radial parameters, a PReLU's
  ``negative_slope``) keeps its name and layout.

Sub-modules that flax builds in a parent's scope and hands to a child
(MPNN's edge network, a HeteroGraphConv's per-relation GraphConvs) are
named in the parent's scope (``Dense_1``, ``GraphConv_0``); the port's
models hold them under those names, so the keys match without a
mapping.

A bipartite ``GATConv``'s ``fc_src`` and ``fc_dst`` are Denses like any
other, both ways; the port's ``GATConv`` takes that layout when it loads a
state dict holding ``fc_src`` (``nn/conv.py``).  A block-list
``GraphSAGE`` has the parameters of the full-graph one.
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

    def put(key: str, arr) -> None:
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                             order="C"))

    def walk(tree: Mapping, prefix: str, owner: str) -> None:
        if set(tree) in (_GRU, _LSTM):
            for key, arr in _recurrent(tree).items():
                put(f"{prefix}{key}", arr)
            return
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.", name)
                continue
            arr = np.array(leaf, dtype=np.float32)
            if name == "kernel":
                if arr.ndim == 3:           # attention: merge the heads
                    arr = arr.reshape(-1, arr.shape[-1]) if owner == "out" \
                        else arr.reshape(arr.shape[0], -1)
                put(f"{prefix}weight", arr.T)
            elif name == "bias" and arr.ndim == 2:
                put(f"{prefix}bias", arr.reshape(-1))
            elif name in ("scale", "embedding"):
                put(f"{prefix}weight", arr)
            else:
                put(f"{prefix}{name}", arr)

    walk(params, "", "")
    return out


_GRU = {"ir", "iz", "in", "hr", "hz", "hn"}
_LSTM = {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}


def _recurrent(cell: Mapping) -> Dict[str, np.ndarray]:
    """A flax GRU or LSTM cell's gate kernels as the torch cell's stacked
    weights and biases."""
    def kernels(names):
        return np.concatenate([np.asarray(cell[n]["kernel"]) for n in names],
                              axis=1).T

    def biases(names):
        return np.concatenate(
            [np.asarray(cell[n]["bias"]) if "bias" in cell[n]
             else np.zeros(np.asarray(cell[n]["kernel"]).shape[1])
             for n in names])
    ins, hid = (("ir", "iz", "in"), ("hr", "hz", "hn")) if set(cell) == _GRU \
        else (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"))
    return {"weight_ih": kernels(ins), "weight_hh": kernels(hid),
            "bias_ih": biases(ins), "bias_hh": biases(hid)}


_CELL_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _recurrent_to_flax(cell: Mapping[str, np.ndarray]) -> Dict:
    """Inverse of ``_recurrent``: a torch GRU or LSTM cell's stacked
    weights as flax's gate kernels (and the biases flax keeps)."""
    H = cell["weight_hh"].shape[1]
    if cell["weight_ih"].shape[0] == 4 * H:
        ins, hid = ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")
        in_bias, hid_bias = False, (True,) * 4
    else:
        ins, hid = ("ir", "iz", "in"), ("hr", "hz", "hn")
        in_bias, hid_bias = True, (False, False, True)
    out: Dict = {}
    for names, w, b, biased in ((ins, "weight_ih", "bias_ih",
                                 (in_bias,) * len(ins)),
                                (hid, "weight_hh", "bias_hh", hid_bias)):
        for k, (name, keep) in enumerate(zip(names, biased)):
            rows = slice(k * H, (k + 1) * H)
            out[name] = {"kernel": cell[w][rows].T.copy()}
            if keep:
                out[name]["bias"] = cell[b][rows].copy()
    return out


def state_dict_to_flax(state: Mapping[str, torch.Tensor],
                       dense_modules=(), embed_modules=(),
                       norm_modules=()) -> Dict:
    """Inverse of ``flax_to_state_dict``.  ``dense_modules`` names the
    sub-modules that are flax ``Dense`` layers (``nn.Linear`` here, e.g.
    ``"gat0.fc"``): their ``weight`` goes back to ``kernel (in, out)``;
    ``embed_modules`` those that are flax ``Embed`` layers
    (``nn.Embedding``): their ``weight`` goes back to ``embedding``;
    ``norm_modules`` those that are flax ``LayerNorm`` layers: their
    ``weight`` goes back to ``scale``.  A module holding a recurrent
    cell's four stacked tensors goes back to flax's gate kernels."""
    tree: Dict = {}
    dense = set(dense_modules)
    embed = set(embed_modules)
    norm = set(norm_modules)
    cells: Dict[tuple, Dict[str, np.ndarray]] = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf in _CELL_LEAVES:
            cells.setdefault(tuple(path), {})[leaf] = arr
            continue
        if leaf == "weight" and ".".join(path) in dense:
            leaf, arr = "kernel", arr.T.copy()
        elif leaf == "weight" and ".".join(path) in embed:
            leaf = "embedding"
        elif leaf == "weight" and ".".join(path) in norm:
            leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    for path, cell in cells.items():
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node.update(_recurrent_to_flax(cell))
    return {"params": tree}


def dense_module_names(model: torch.nn.Module):
    """Names of a model's ``nn.Linear`` sub-modules (flax ``Dense``)."""
    return [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)]


def embed_module_names(model: torch.nn.Module):
    """Names of a model's ``nn.Embedding`` sub-modules (flax ``Embed``)."""
    return [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.Embedding)]


def norm_module_names(model: torch.nn.Module):
    """Names of a model's ``nn.LayerNorm`` sub-modules (flax
    ``LayerNorm``)."""
    return [n for n, m in model.named_modules()
            if isinstance(m, torch.nn.LayerNorm)]
