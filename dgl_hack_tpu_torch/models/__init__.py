from .gnn_models import (APPNP, GAT, GCN, GIN, RGCN, SGC, TAGCN,
                         GraphSAGE, MLPPredictor)
from .transformer import GraphTransformer, build_graphs, copy_task_loss
from . import chem
from .chem import (ACNN, MGCN, MPNN, AttentiveFP, GATClassifier,
                   GCNClassifier, SchNet, WeavePredictor, WLNPredictor)
