from .gnn_models import GAT, GCN, GraphSAGE
