from .graph_classification import (GraphClassificationDataset,
                                   TUDatasetSynthetic, sbm_mixture)
from .synthetic import (NodeClassificationDataset, planted_partition,
                        random_power_law_graph, synthetic_citation,
                        synthetic_cora, synthetic_reddit)
