"""HeteroGraphConv: one module per relation and a cross-type aggregation
per destination node type, as ``dgl_hack_tpu.nn.hetero``."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..core.heterograph import HeteroGraph, cross_reduce

Tensor = torch.Tensor


class HeteroGraphConv(nn.Module):
    """Apply the module of each relation's etype to (relation graph,
    (src_feat, dst_feat)) and aggregate the results per dst node type
    (``aggregate`` in sum, max, min, mean, stack; a single result is
    passed through, unless stacked).  The modules are named
    ``mods_<etype>``, as flax names the entries of the JAX module's
    ``mods`` dict, so a flax params tree converts key for key."""

    def __init__(self, mods: Dict[str, nn.Module], aggregate: str = "sum"):
        super().__init__()
        self.etype_names = tuple(mods)
        for et, mod in mods.items():
            self.add_module(f"mods_{et}", mod)
        self.aggregate = aggregate

    def forward(self, hg: HeteroGraph, inputs: Dict[str, Tensor],
                **kwargs) -> Dict[str, Tensor]:
        outputs: Dict[str, list] = {}
        for st, et, dt in hg.canonical_etypes:
            if et not in self.etype_names or st not in inputs:
                continue
            dst_in = inputs.get(dt, inputs[st])
            out = getattr(self, f"mods_{et}")(hg[(st, et, dt)],
                                              (inputs[st], dst_in), **kwargs)
            outputs.setdefault(dt, []).append(out)
        return {dt: outs[0] if len(outs) == 1 and self.aggregate != "stack"
                else cross_reduce(self.aggregate, outs)
                for dt, outs in outputs.items()}
