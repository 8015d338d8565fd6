"""The ``graphsage-mean`` configuration in the port: ``models.GraphSAGE``
with the mean aggregator over the whole graph."""
from __future__ import annotations


def build(cfg: dict, num_classes: int):
    from dgl_hack_tpu_torch.models.gnn_models import GraphSAGE
    return GraphSAGE(cfg["num_hidden"], num_classes,
                     num_layers=cfg["num_layers"],
                     aggregator_type=cfg["aggregator"],
                     dropout=cfg["dropout"])
