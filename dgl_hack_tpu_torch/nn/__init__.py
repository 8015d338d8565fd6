from .conv import GATConv, GraphConv
