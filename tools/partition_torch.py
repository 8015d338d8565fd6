"""Graph partitioning CLI of the PyTorch port (twin of tools/partition.py).

python tools/partition_torch.py --dataset cora --num-parts 4 --num-hops 1 \
    --method fennel --output parts/cora

Partitions the dataset's graph (``dgl_hack_tpu_torch.partition``), adds
``--num-hops`` of halo to each part and writes one ``<output>.part<i>.npz``
a part, with the arrays tools/partition.py writes, then prints a ``part
i: ...`` line a part.  Partitioning is host numpy in both packages: the
tool touches no device, so it has no ``--device``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="cora")
    p.add_argument("--num-parts", type=int, default=4)
    p.add_argument("--num-hops", type=int, default=1)
    p.add_argument("--method", default="fennel",
                   choices=["fennel", "random", "range"])
    p.add_argument("--output", default="parts/graph")
    args = p.parse_args()

    from dgl_hack_tpu_torch import data
    from dgl_hack_tpu_torch.partition import (partition,
                                              partition_graph_with_halo,
                                              save_partitions)

    ds = {"cora": data.CoraGraphDataset,
          "citeseer": data.CiteseerGraphDataset,
          "pubmed": data.PubmedGraphDataset,
          "reddit": data.RedditDataset}[args.dataset]()
    parts = partition(ds.graph, args.num_parts, method=args.method)
    partitions = partition_graph_with_halo(ds.graph, parts,
                                           num_hops=args.num_hops)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    save_partitions(args.output, partitions)
    for part in partitions:
        inner = int(part.inner_node.sum())
        print(f"part {part.part_id}: {inner} owned nodes, "
              f"{part.graph.num_nodes() - inner} halo nodes, "
              f"{part.graph.num_edges()} edges")


if __name__ == "__main__":
    main()
