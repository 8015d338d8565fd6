"""Checkpoint/resume, as ``dgl_hack_tpu.utils.checkpoint``: one
``{path}.step{step}.npz`` per save, with the leaves as ``leaf_0`` ... in
JAX's flatten order (dict keys sorted, lists and tuples in order, None no
leaf) and the step as ``__step__``, and a ``LATEST`` file beside it naming
the newest.

The JAX module pickles its treedef into ``__treedef__``; this one records
the structure as JSON in ``__structure__`` and loads with
``allow_pickle=False``.  A file the JAX package wrote holds a pickled JAX
object this package cannot rebuild, so loading one raises.  Tensors on
the card are saved from host copies (bf16 as float32, restored exactly);
loading gives host tensors.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_SCALARS = {bool: "bool", int: "int", float: "float", str: "str"}


def _flatten(state: Any, leaves: List[np.ndarray]):
    """The structure of ``state`` as JSON-ready data; its leaves appended
    to ``leaves`` in JAX's order."""
    if state is None:
        return {"none": None}
    if isinstance(state, dict):
        keys = sorted(state)
        return {"dict": [[k, _flatten(state[k], leaves)] for k in keys]}
    if isinstance(state, (list, tuple)):
        kind = "tuple" if isinstance(state, tuple) else "list"
        return {kind: [_flatten(v, leaves) for v in state]}
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        leaves.append(t.numpy())
        return {"tensor": dtype}
    leaves.append(np.asarray(state))
    return {"leaf": _SCALARS.get(type(state), "array")}


def _unflatten(node, leaves):
    (kind, val), = node.items()
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in val}
    if kind in ("list", "tuple"):
        out = [_unflatten(v, leaves) for v in val]
        return tuple(out) if kind == "tuple" else out
    leaf = next(leaves)
    if kind == "tensor":
        return torch.from_numpy(leaf).to(getattr(torch, val))
    return leaf if val == "array" else leaf.item()


def save_checkpoint(path: str, state: Any, step: int = 0) -> str:
    """Save a nested train state (dicts, lists, tuples of tensors, arrays
    and Python scalars: a model's and an optimizer's ``state_dict()``);
    returns the file written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves: List[np.ndarray] = []
    structure = _flatten(state, leaves)
    payload = {f"leaf_{i}": l for i, l in enumerate(leaves)}
    payload["__structure__"] = np.frombuffer(
        json.dumps(structure).encode(), dtype=np.uint8)
    payload["__step__"] = np.asarray(step)
    fname = f"{path}.step{step}.npz"
    np.savez(fname, **payload)
    latest = os.path.join(os.path.dirname(path) or ".", "LATEST")
    with open(latest, "w") as f:
        f.write(fname)
    return fname


def load_checkpoint(path_or_dir: str) -> Optional[Dict[str, Any]]:
    """Load the latest checkpoint of a directory (or the file given);
    returns {'state': the saved structure, 'step': int} or None."""
    if os.path.isdir(path_or_dir):
        latest = os.path.join(path_or_dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            fname = f.read().strip()
    else:
        fname = path_or_dir
    if not os.path.exists(fname):
        return None
    with np.load(fname, allow_pickle=False) as z:
        if "__structure__" not in z.files:
            raise ValueError(
                f"{fname} has no __structure__ entry: it was written by the "
                "JAX package, whose __treedef__ is a pickled JAX treedef; "
                "this package does not unpickle it (read the leaf_i arrays "
                "directly)")
        structure = json.loads(bytes(z["__structure__"]).decode())
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = iter([z[f"leaf_{i}"] for i in range(n)])
        step = int(z["__step__"])
    return {"state": _unflatten(structure, leaves), "step": step}
