from .gnn_models import (APPNP, GAT, GCN, GIN, RGCN, SGC, TAGCN,
                         GraphSAGE, MLPPredictor)
from .transformer import GraphTransformer, build_graphs, copy_task_loss
