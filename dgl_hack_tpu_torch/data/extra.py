"""The remaining reference dataset families, as ``dgl_hack_tpu.data.extra``
(reference: python/dgl/data/{ppi.py,tu.py,gindt.py,gnn_benckmark.py,
bitcoinotc.py,qm7b.py,gdelt.py,icews18.py}).  When the raw files are under
``$DGL_DOWNLOAD_DIR`` they are parsed in the reference's on-disk formats;
otherwise deterministic synthetic stand-ins (the JAX module's generators,
drawing the same streams) keep every loader runnable offline, with a
warning.  Graphs are built on the host.
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import List

import numpy as np

from ..core.graph import Graph, _build
from .citation import _data_dir
from .graph_classification import GraphClassificationDataset, sbm_mixture
from .synthetic import NodeClassificationDataset, planted_partition


def _warn_synth(name: str, root: str) -> None:
    warnings.warn(
        f"raw {name} files not found under {root}; using the deterministic "
        f"synthetic stand-in (zero-egress container). Place the reference's "
        f"raw files there to use the real dataset.")


# ---------------------------------------------------------------------------
# PPI — inductive multi-label node classification over 24 graphs
# (reference: python/dgl/data/ppi.py: {mode}_graph.json node-link +
#  {mode}_feats.npy / {mode}_labels.npy / {mode}_graph_id.npy)
# ---------------------------------------------------------------------------
@dataclass
class PPIDataset:
    """One mode ('train'/'valid'/'test') of the PPI inductive split."""
    graphs: List[Graph]
    features: List[np.ndarray]
    labels: List[np.ndarray]           # (n_i, 121) multi-label per graph
    mode: str = "train"
    num_labels: int = 121

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i], self.features[i], self.labels[i]


def _ppi_synthetic(mode: str, seed: int) -> PPIDataset:
    rng = np.random.default_rng(seed + {"train": 0, "valid": 1, "test": 2}[mode])
    n_graphs = {"train": 20, "valid": 2, "test": 2}[mode]
    graphs, feats, labels = [], [], []
    # 121 labels correlated with 8 latent communities
    proto = rng.random((8, 121)) < 0.3
    for _ in range(n_graphs):
        n = int(rng.integers(300, 600))
        comm = rng.integers(0, 8, n)
        E = n * 12
        u = rng.integers(0, n, E).astype(np.int32)
        same = rng.random(E) < 0.7
        v = np.where(same,
                     np.take(np.argsort(comm, kind="stable"),
                             rng.integers(0, n, E) % n),
                     rng.integers(0, n, E)).astype(np.int32)
        graphs.append(_build(np.concatenate([u, v]), np.concatenate([v, u]),
                             n, n, is_block=False))
        feats.append(rng.normal(size=(n, 50)).astype(np.float32)
                     + comm[:, None])
        noise = rng.random((n, 121)) < 0.05
        labels.append((proto[comm] ^ noise).astype(np.float32))
    return PPIDataset(graphs, feats, labels, mode=mode)


def load_ppi(mode: str = "train", seed: int = 0) -> PPIDataset:
    root = os.path.join(_data_dir(), "ppi")
    gj = os.path.join(root, f"{mode}_graph.json")
    if not os.path.exists(gj):
        _warn_synth("ppi", root)
        return _ppi_synthetic(mode, seed)
    with open(gj) as f:
        nl = json.load(f)                     # networkx node-link format
    src = np.asarray([e["source"] for e in nl["links"]], np.int64)
    dst = np.asarray([e["target"] for e in nl["links"]], np.int64)
    feats = np.load(os.path.join(root, f"{mode}_feats.npy"))
    labels = np.load(os.path.join(root, f"{mode}_labels.npy"))
    gid = np.load(os.path.join(root, f"{mode}_graph_id.npy"))
    graphs, gfeats, glabels = [], [], []
    for g_id in np.unique(gid):
        nodes = np.nonzero(gid == g_id)[0]
        lo, hi = nodes.min(), nodes.max()
        m = (src >= lo) & (src <= hi)
        graphs.append(_build((src[m] - lo).astype(np.int32),
                             (dst[m] - lo).astype(np.int32),
                             len(nodes), len(nodes), is_block=False))
        gfeats.append(feats[nodes].astype(np.float32))
        glabels.append(labels[nodes].astype(np.float32))
    return PPIDataset(graphs, gfeats, glabels, mode=mode,
                      num_labels=labels.shape[1])


# ---------------------------------------------------------------------------
# TUDataset / GINDataset — graph classification from the TU text format
# (reference: python/dgl/data/tu.py: DS_A.txt edge list, DS_graph_indicator
#  .txt, DS_graph_labels.txt, optional DS_node_labels.txt /
#  DS_node_attributes.txt; gindt.py mirrors with degree-as-feature option)
# ---------------------------------------------------------------------------
def TUDataset(name: str = "synthetic", seed: int = 0,
              **synth_kw) -> GraphClassificationDataset:
    root = os.path.join(_data_dir(), "tu", name)
    a_file = os.path.join(root, f"{name}_A.txt")
    if not os.path.exists(a_file):
        _warn_synth(f"TU/{name}", root)
        return sbm_mixture(seed=seed, **synth_kw)
    edges = np.loadtxt(a_file, delimiter=",", dtype=np.int64) - 1  # 1-based
    gi = np.loadtxt(os.path.join(root, f"{name}_graph_indicator.txt"),
                    dtype=np.int64) - 1
    gl = np.loadtxt(os.path.join(root, f"{name}_graph_labels.txt"),
                    dtype=np.int64)
    _, gl = np.unique(gl, return_inverse=True)     # labels -> 0..k-1
    nl_file = os.path.join(root, f"{name}_node_labels.txt")
    na_file = os.path.join(root, f"{name}_node_attributes.txt")
    if os.path.exists(na_file):
        nfeat = np.loadtxt(na_file, delimiter=",", ndmin=2).astype(np.float32)
    elif os.path.exists(nl_file):
        nlab = np.loadtxt(nl_file, dtype=np.int64)
        k = int(nlab.max()) + 1
        nfeat = np.eye(k, dtype=np.float32)[nlab]
    else:
        nfeat = np.ones((gi.shape[0], 1), np.float32)
    graphs, feats = [], []
    node_off = np.searchsorted(gi, np.arange(gl.shape[0] + 1))
    g_of_edge = gi[edges[:, 0]]
    order = np.argsort(g_of_edge, kind="stable")
    edges, g_of_edge = edges[order], g_of_edge[order]
    edge_off = np.searchsorted(g_of_edge, np.arange(gl.shape[0] + 1))
    for i in range(gl.shape[0]):
        lo, hi = node_off[i], node_off[i + 1]
        e = edges[edge_off[i]:edge_off[i + 1]] - lo
        graphs.append(_build(e[:, 0].astype(np.int32),
                             e[:, 1].astype(np.int32),
                             hi - lo, hi - lo, is_block=False))
        feats.append(nfeat[lo:hi])
    return GraphClassificationDataset(graphs, feats, gl.astype(np.int32),
                                      int(gl.max()) + 1, name=f"tu-{name}")


def GINDataset(name: str = "synthetic", self_loop: bool = False,
               degree_as_nlabel: bool = False, seed: int = 0,
               **kw) -> GraphClassificationDataset:
    """GIN benchmark datasets share the TU on-disk format
    (reference: python/dgl/data/gindt.py)."""
    ds = TUDataset(name, seed=seed, **kw)
    if degree_as_nlabel:
        feats = []
        for g in ds.graphs:
            deg = g.in_degrees().numpy()
            k = max(int(deg.max()) + 1, 1)
            feats.append(np.eye(k, dtype=np.float32)[deg])
        ds = GraphClassificationDataset(ds.graphs, feats, ds.labels,
                                        ds.num_classes, name=ds.name)
    return ds


# ---------------------------------------------------------------------------
# gnn-benchmark npz graphs: AmazonCoBuy / Coauthor / CoraFull
# (reference: python/dgl/data/gnn_benckmark.py — scipy-CSR npz with
#  adj_{data,indices,indptr,shape} + attr_* + labels)
# ---------------------------------------------------------------------------
_GNN_BENCH_STATS = {  # name -> (nodes, classes, feat_dim, avg_deg)
    "amazon_co_buy_computer": (13752, 10, 767, 18.0),
    "amazon_co_buy_photo": (7650, 8, 745, 15.7),
    "coauthor_cs": (18333, 15, 6805, 4.4),
    "coauthor_physics": (34493, 5, 8415, 7.2),
    "cora_full": (19793, 70, 8710, 3.2),
}


def _load_gnn_benchmark(name: str, seed: int = 0,
                        scale: float = 1.0) -> NodeClassificationDataset:
    root = _data_dir()
    path = os.path.join(root, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=True) as z:
            import scipy.sparse as sp
            adj = sp.csr_matrix((z["adj_data"], z["adj_indices"],
                                 z["adj_indptr"]), shape=z["adj_shape"])
            if "attr_data" in z:
                attr = sp.csr_matrix((z["attr_data"], z["attr_indices"],
                                      z["attr_indptr"]),
                                     shape=z["attr_shape"]).toarray()
            else:
                attr = z["attr_matrix"]
            labels = z["labels"].astype(np.int32)
        coo = adj.tocoo()
        g = _build(coo.row.astype(np.int32), coo.col.astype(np.int32),
                   adj.shape[0], adj.shape[0], is_block=False)
        n = adj.shape[0]
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        train = np.zeros(n, bool); train[perm[:n // 10]] = True
        val = np.zeros(n, bool); val[perm[n // 10:n // 5]] = True
        test = np.zeros(n, bool); test[perm[n // 5:]] = True
        return NodeClassificationDataset(
            g, attr.astype(np.float32), labels, train, val, test,
            int(labels.max()) + 1, name=name)
    _warn_synth(name, root)
    n, k, f, d = _GNN_BENCH_STATS[name]
    n = max(int(n * scale), 50 * k)
    return planted_partition(n, k, min(f, 512), avg_degree=d,
                             homophily=0.8, feat_noise=1.5, seed=seed,
                             name=f"{name}-synth")


def AmazonCoBuyComputerDataset(**kw):
    return _load_gnn_benchmark("amazon_co_buy_computer", **kw)


def AmazonCoBuyPhotoDataset(**kw):
    return _load_gnn_benchmark("amazon_co_buy_photo", **kw)


def CoauthorCSDataset(**kw):
    return _load_gnn_benchmark("coauthor_cs", **kw)


def CoauthorPhysicsDataset(**kw):
    return _load_gnn_benchmark("coauthor_physics", **kw)


def CoraFullDataset(**kw):
    return _load_gnn_benchmark("cora_full", **kw)


# ---------------------------------------------------------------------------
# BitcoinOTC — temporal sequence of signed trust graphs
# (reference: python/dgl/data/bitcoinotc.py — csv rows src,dst,rating,time,
#  one graph per 2-week span, rating on edata)
# ---------------------------------------------------------------------------
@dataclass
class BitcoinOTCDataset:
    graphs: List[Graph]                 # edata['h'] = rating
    name: str = "bitcoinotc"
    is_temporal: bool = True

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]


def load_bitcoinotc(seed: int = 0, num_spans: int = 10,
                    synth_nodes: int = 500) -> BitcoinOTCDataset:
    root = _data_dir()
    path = os.path.join(root, "soc-sign-bitcoinotc.csv")
    if os.path.exists(path):
        raw = np.loadtxt(path, delimiter=",")
        src, dst = raw[:, 0].astype(np.int64), raw[:, 1].astype(np.int64)
        rating, t = raw[:, 2].astype(np.float32), raw[:, 3]
        n = int(max(src.max(), dst.max())) + 1
        span = 14 * 24 * 3600.0
        bins = ((t - t.min()) // span).astype(np.int64)
    else:
        _warn_synth("bitcoinotc", root)
        rng = np.random.default_rng(seed)
        n, E = synth_nodes, synth_nodes * 20
        src = rng.integers(0, n, E)
        dst = rng.integers(0, n, E)
        rating = rng.integers(-10, 11, E).astype(np.float32)
        bins = np.sort(rng.integers(0, num_spans, E))
    graphs = []
    for b in np.unique(bins):
        m = bins == b
        g = _build(src[m].astype(np.int32), dst[m].astype(np.int32),
                   n, n, is_block=False)
        g.edata["h"] = rating[m][:, None]
        graphs.append(g)
    return BitcoinOTCDataset(graphs)


# ---------------------------------------------------------------------------
# QM7b — multitask molecular regression from Coulomb matrices
# (reference: python/dgl/data/qm7b.py — .mat with X (7211,23,23), T (7211,14);
#  graphs are complete graphs with the Coulomb entry as edge feature)
# ---------------------------------------------------------------------------
@dataclass
class QM7bDataset:
    graphs: List[Graph]                 # edata['h'] = coulomb entry
    labels: np.ndarray                  # (n_graphs, 14)
    name: str = "qm7b"


def load_qm7b(seed: int = 0, num_synth: int = 100) -> QM7bDataset:
    root = _data_dir()
    path = os.path.join(root, "qm7b.mat")
    if os.path.exists(path):
        import scipy.io as sio
        mat = sio.loadmat(path)
        X, T = mat["X"], mat["T"].astype(np.float32)
    else:
        _warn_synth("qm7b", root)
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(num_synth, 23, 23)).astype(np.float32)
        X = np.abs(X + X.transpose(0, 2, 1)) * (rng.random((num_synth, 23, 23)) < 0.4)
        T = np.stack([X.sum((1, 2)) * w for w in
                      np.linspace(0.5, 2.0, 14)], 1).astype(np.float32)
    graphs = []
    for i in range(X.shape[0]):
        s, d = np.nonzero(X[i])
        g = _build(s.astype(np.int32), d.astype(np.int32), X.shape[1],
                   X.shape[1], is_block=False)
        g.edata["h"] = X[i][s, d].astype(np.float32)[:, None]
        graphs.append(g)
    return QM7bDataset(graphs, T)


# ---------------------------------------------------------------------------
# GDELT / ICEWS18 — temporal knowledge-graph event streams
# (reference: python/dgl/data/gdelt.py, icews18.py — TSV quadruples
#  (head, rel, tail, time) per train/valid/test split)
# ---------------------------------------------------------------------------
@dataclass
class TemporalKGDataset:
    triplets: np.ndarray                # (n, 4) head, rel, tail, time
    num_entities: int
    num_relations: int
    mode: str
    name: str


def _load_temporal_kg(name: str, mode: str, seed: int,
                      synth_entities: int, synth_rels: int,
                      synth_events: int) -> TemporalKGDataset:
    root = os.path.join(_data_dir(), name)
    path = os.path.join(root, f"{mode}.txt")
    if os.path.exists(path):
        quads = np.loadtxt(path, dtype=np.int64, ndmin=2)[:, :4]
        return TemporalKGDataset(quads, int(quads[:, [0, 2]].max()) + 1,
                                 int(quads[:, 1].max()) + 1, mode, name)
    _warn_synth(name, root)
    rng = np.random.default_rng(seed + hash(mode) % 97)
    h = rng.integers(0, synth_entities, synth_events)
    r = rng.integers(0, synth_rels, synth_events)
    t = (h + r * 7 + rng.integers(0, 5, synth_events)) % synth_entities
    tm = np.sort(rng.integers(0, 300, synth_events))
    quads = np.stack([h, r, t, tm], 1).astype(np.int64)
    return TemporalKGDataset(quads, synth_entities, synth_rels, mode,
                             f"{name}-synth")


def GDELTDataset(mode: str = "train", seed: int = 0):
    return _load_temporal_kg("GDELT", mode, seed, 500, 20, 20000)


def ICEWS18Dataset(mode: str = "train", seed: int = 0):
    return _load_temporal_kg("ICEWS18", mode, seed, 2000, 50, 40000)
