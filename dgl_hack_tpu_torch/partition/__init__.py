from .partition import (  # noqa: F401
    partition, random_partition, fennel_partition, range_partition,
    partition_graph_with_halo, Partition, save_partitions, load_partition,
    metis_partition,
)
