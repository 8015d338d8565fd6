from .chem import (MoleculeCSVDataset, PubChemBioAssayAromaticity,
                   TencentAlchemyDataset, Tox21, atom_featurizer,
                   bond_featurizer)
from .graph_classification import (GraphClassificationDataset,
                                   TUDatasetSynthetic, sbm_mixture)
from .rdf import (AIFBDataset, AMDataset, BGSDataset, MUTAGDataset,
                  RDFDataset, load_rdf_dataset, synthetic_rdf)
from .synthetic import (NodeClassificationDataset, planted_partition,
                        random_power_law_graph, synthetic_citation,
                        synthetic_cora, synthetic_reddit)
