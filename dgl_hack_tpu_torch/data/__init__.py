from .chem import (MoleculeCSVDataset, PubChemBioAssayAromaticity,
                   TencentAlchemyDataset, Tox21, atom_featurizer,
                   bond_featurizer)
from .citation import (CiteseerGraphDataset, CoraGraphDataset,
                       PubmedGraphDataset, RedditDataset)
from .extra import (AmazonCoBuyComputerDataset, AmazonCoBuyPhotoDataset,
                    BitcoinOTCDataset, CoauthorCSDataset,
                    CoauthorPhysicsDataset, CoraFullDataset, GDELTDataset,
                    GINDataset, ICEWS18Dataset, PPIDataset, QM7bDataset,
                    TemporalKGDataset, TUDataset, load_bitcoinotc, load_ppi,
                    load_qm7b)
from .graph_classification import (GraphClassificationDataset,
                                   TUDatasetSynthetic, sbm_mixture)
from .io import load_graphs, load_heterograph, save_graphs, save_heterograph
from .karate import KarateClubDataset
from .kg import KGDataset, load_kg_dataset, synthetic_kg
from .rdf import (AIFBDataset, AMDataset, BGSDataset, MUTAGDataset,
                  RDFDataset, load_rdf_dataset, synthetic_rdf)
from .synthetic import (NodeClassificationDataset, planted_partition,
                        random_power_law_graph, synthetic_cora,
                        synthetic_reddit)
