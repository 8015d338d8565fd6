from .conv import GATConv, GINConv, GraphConv, SAGEConv
