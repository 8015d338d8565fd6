"""The ``gat`` configuration in the port: ``models.GAT``."""
from __future__ import annotations


def build(cfg: dict, num_classes: int):
    from dgl_hack_tpu_torch.models.gnn_models import GAT
    return GAT(cfg["num_hidden"], num_classes, heads=tuple(cfg["heads"]),
               feat_drop=cfg["feat_drop"], attn_drop=cfg["attn_drop"],
               negative_slope=cfg["negative_slope"],
               residual=cfg["residual"])
