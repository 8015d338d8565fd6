from ..ops.edge_softmax import edge_softmax  # noqa: F401
from .conv import (AGNNConv, APPNPConv, ChebConv, DenseGraphConv,  # noqa: F401
                   EdgeConv, GATConv, GatedGraphConv, GINConv, GraphConv,
                   NNConv, RelGraphConv, SAGEConv, SGConv, TAGConv)
from .conv_extra import (AtomicConv, DenseChebConv,  # noqa: F401
                         DenseSAGEConv, GMMConv, KNNGraph,
                         SegmentedKNNGraph, WeaveGNN, WeaveLayer, WLN)
from .glob import (AvgPooling, GlobalAttentionPooling,  # noqa: F401
                   MaxPooling, Set2Set, SetTransformerDecoder,
                   SetTransformerEncoder, SortPooling, SumPooling,
                   WeightAndSum)
from .hetero import HeteroGraphConv  # noqa: F401
from .init import Dense  # noqa: F401
from .utils import Identity, Sequential, WeightBasis  # noqa: F401
