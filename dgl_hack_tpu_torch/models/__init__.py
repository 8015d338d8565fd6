from .gnn_models import GAT, GCN, GraphSAGE
from .transformer import GraphTransformer, build_graphs, copy_task_loss
