"""The port's datasets (``data/{citation,karate,extra}``), graph files
(``data/io``) and ``ops.segment.bincount`` against the JAX package's.

Every parser reads the byte-accurate fixtures of ``tests/fixtures/data``
(the files ``tests/test_real_parsers.py`` reads) with no synthetic
warning, and gives the JAX package's arrays exactly: graph edges in CSC
order (src, dst, indptrs, the CSR permutation), features, labels and
masks.  Every synthetic stand-in (an empty ``$DGL_DOWNLOAD_DIR``) equals
the JAX one with the same warning.  Graph and heterograph files written
by either package are read by the other.  ``bincount``'s float32 counts
and sums equal ``jax.ops.segment_sum``'s."""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_hack_tpu as dgl
from dgl_hack_tpu import data as jdata
from dgl_hack_tpu.data import io as jio
from dgl_hack_tpu.ops import segment as jseg

import dgl_hack_tpu_torch as dt
from dgl_hack_tpu_torch import data as tdata
from dgl_hack_tpu_torch.data import io as tio
from dgl_hack_tpu_torch.ops import segment as tseg

torch.set_num_threads(2)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "data")
STRUCT = ("src", "dst", "csc_indptr", "csr_indptr", "csr_eids")


def same_graph(gj, gt):
    """Equal node counts, edges in CSC order and CSR permutation, and the
    same user order."""
    assert (gj.num_src_nodes, gj.num_dst_nodes, gj.is_block) == \
        (gt.num_src_nodes, gt.num_dst_nodes, gt.is_block)
    for name in STRUCT:
        np.testing.assert_array_equal(gj.host(name), gt.host(name), name)
    for a, b in zip(gj.host_edges(), gt.host_edges()):
        np.testing.assert_array_equal(a, b)


def _arr(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def same_value(a, b):
    """Dataclasses field by field (graphs as graphs), lists item by item,
    arrays exactly (dtype too)."""
    if hasattr(a, "host_edges"):
        same_graph(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_value(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            same_value(getattr(a, f), getattr(b, f))
    elif isinstance(a, (str, int, float, bool)):
        assert a == b
    else:
        x, y = np.asarray(a), _arr(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def load_both(fn_j, fn_t):
    """Each package's loader, with the warnings each raised."""
    out = []
    for fn in (fn_j, fn_t):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ds = fn()
        out.append((ds, [str(w.message) for w in rec
                         if issubclass(w.category, UserWarning)]))
    return out


# ---------------------------------------------------------------------------
# the real parsers on the fixtures
# ---------------------------------------------------------------------------
PARSERS = {
    "cora": lambda d: d.CoraGraphDataset(),
    "citeseer": lambda d: d.CiteseerGraphDataset(),
    "reddit": lambda d: d.RedditDataset(),
    "amazon_co_buy_computer": lambda d: d.AmazonCoBuyComputerDataset(),
    "tu": lambda d: d.TUDataset("MINI"),
    "gin_degree": lambda d: d.GINDataset("MINI", degree_as_nlabel=True),
    "ppi_train": lambda d: d.load_ppi("train"),
    "ppi_valid": lambda d: d.load_ppi("valid"),
    "ppi_test": lambda d: d.load_ppi("test"),
    "bitcoinotc": lambda d: d.load_bitcoinotc(),
    "qm7b": lambda d: d.load_qm7b(),
    "gdelt_train": lambda d: d.GDELTDataset("train"),
    "gdelt_test": lambda d: d.GDELTDataset("test"),
    "icews18_valid": lambda d: d.ICEWS18Dataset("valid"),
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_jax(monkeypatch, name):
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", FIXDIR)
    (dj, wj), (dtt, wt) = load_both(lambda: PARSERS[name](jdata),
                                    lambda: PARSERS[name](tdata))
    assert not [w for w in wj + wt if "synthetic" in w], (wj, wt)
    same_value(dj, dtt)
    if name == "bitcoinotc":            # ratings on the edges, user order
        for gj, gt in zip(dj.graphs, dtt.graphs):
            np.testing.assert_array_equal(np.asarray(gj.edata["h"]),
                                          gt.edata["h"].numpy())


# ---------------------------------------------------------------------------
# the synthetic stand-ins
# ---------------------------------------------------------------------------
STANDINS = {
    "cora": lambda d: d.CoraGraphDataset(),
    "citeseer": lambda d: d.CiteseerGraphDataset(),
    "pubmed": lambda d: d.PubmedGraphDataset(synthetic_seed=1),
    "reddit": lambda d: d.RedditDataset(scale=0.01),
    "ppi": lambda d: d.load_ppi("valid", seed=3),
    "tu": lambda d: d.TUDataset("NOPE", num_graphs=20),
    "gin": lambda d: d.GINDataset("NOPE", degree_as_nlabel=True,
                                  num_graphs=20),
    "amazon_photo": lambda d: d.AmazonCoBuyPhotoDataset(scale=0.1),
    "coauthor_cs": lambda d: d.CoauthorCSDataset(scale=0.05),
    "coauthor_physics": lambda d: d.CoauthorPhysicsDataset(scale=0.02),
    "cora_full": lambda d: d.CoraFullDataset(scale=0.1),
    "bitcoinotc": lambda d: d.load_bitcoinotc(seed=2, synth_nodes=200),
    "qm7b": lambda d: d.load_qm7b(num_synth=20),
    "gdelt": lambda d: d.GDELTDataset("valid"),
    "icews18": lambda d: d.ICEWS18Dataset("test", seed=1),
}


@pytest.mark.parametrize("name", sorted(STANDINS))
def test_standin_matches_jax(monkeypatch, tmp_path, name):
    """An empty download directory: both packages warn the same words and
    return the same stand-in (GDELT/ICEWS18 seed with hash(mode), equal
    within one process)."""
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    (dj, wj), (dtt, wt) = load_both(lambda: STANDINS[name](jdata),
                                    lambda: STANDINS[name](tdata))
    assert wj and wj == wt, (wj, wt)
    assert all("synthetic" in w or "stand-in" in w for w in wt)
    same_value(dj, dtt)


def test_chem_loaders_warn_as_jax(monkeypatch, tmp_path):
    """data/chem takes _data_dir and _warn_synth from citation and extra,
    as the JAX module does: the same directory and words."""
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    from dgl_hack_tpu.data import chem as jchem
    from dgl_hack_tpu_torch.data import chem as tchem
    assert tchem._data_dir() == jchem._data_dir() == str(tmp_path)
    (_, wj), (_, wt) = load_both(lambda: jchem.Tox21(n_mols=4),
                                 lambda: tchem.Tox21(n_mols=4))
    assert wj and wj == wt


def test_karate_matches_jax():
    dj, dtt = jdata.KarateClubDataset(), tdata.KarateClubDataset()
    same_value(dj, dtt)
    assert dtt.graph.num_edges() == 156 and dtt.num_classes == 2


# ---------------------------------------------------------------------------
# data/io: files read across in both directions
# ---------------------------------------------------------------------------
def _graphs(pkg, rng_seed=0):
    """Two graphs (a graph with node and edge features, user order not
    dst-sorted, and a block) built in ``pkg`` from one numpy seed."""
    rng = np.random.default_rng(rng_seed)
    s, d = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
    feat = rng.normal(size=(30, 5)).astype(np.float32)
    w = rng.normal(size=(90, 2)).astype(np.float32)
    bs, bd = rng.integers(0, 12, 20), rng.integers(0, 4, 20)
    if pkg is dgl:
        g = dgl.graph((s, d), num_nodes=30)
        g.ndata["h"] = jnp.asarray(feat)
        g.edata["w"] = jnp.asarray(w)
    else:
        g = dt.graph((s, d), num_nodes=30)
        g.ndata["h"] = torch.from_numpy(feat)
        g.edata["w"] = torch.from_numpy(w)
    blk = pkg.block((bs, bd), 12, 4)
    return [g, blk], {"y": np.arange(2, dtype=np.int64)}


def _same_files(gsj, gst):
    for gj, gt in zip(gsj, gst):
        same_graph(gj, gt)
        assert sorted(gj._node_frames[0]) == sorted(gt._node_frames[0])
        for k in gj._node_frames[0]:
            np.testing.assert_array_equal(np.asarray(gj._node_frames[0][k]),
                                          gt._node_frames[0][k].numpy())
        assert sorted(gj._edge_frame) == sorted(gt._edge_frame)
        for k in gj._edge_frame:
            np.testing.assert_array_equal(np.asarray(gj.edata[k]),
                                          gt.edata[k].numpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_files_read_across(tmp_path, writer):
    gj, lab = _graphs(dgl)
    gt, _ = _graphs(dt)
    path = str(tmp_path / "g.npz")
    if writer == "jax":
        jio.save_graphs(path, gj, lab)
    else:
        tio.save_graphs(path, gt, lab)
    (lj, labj), (lt, labt) = jio.load_graphs(path), tio.load_graphs(path)
    _same_files(gj, lt)
    _same_files(lj, gt)
    for labs in (labj, labt):
        np.testing.assert_array_equal(labs["y"], lab["y"])
    assert all(g.device.type == "cpu" for g in lt)


def test_graph_files_identical_arrays(tmp_path):
    """Each entry of the two packages' files of the same graphs is equal:
    the same layout, not only the same graphs after loading."""
    gj, lab = _graphs(dgl)
    gt, _ = _graphs(dt)
    jio.save_graphs(str(tmp_path / "j.npz"), gj, lab)
    tio.save_graphs(str(tmp_path / "t.npz"), gt, lab)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k], k)


def _hetero(pkg):
    rng = np.random.default_rng(5)
    data = {("user", "follows", "user"): (rng.integers(0, 9, 20),
                                          rng.integers(0, 9, 20)),
            ("user", "plays", "game"): (rng.integers(0, 9, 15),
                                        rng.integers(0, 4, 15))}
    hg = pkg.heterograph(data, num_nodes_dict={"user": 9, "game": 4})
    x = rng.normal(size=(9, 3)).astype(np.float32)
    hg.nodes_data("user")["x"] = jnp.asarray(x) if pkg is dgl else \
        torch.from_numpy(x)
    return hg


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heterograph_files_read_across(tmp_path, writer):
    hj, ht = _hetero(dgl), _hetero(dt)
    path = str(tmp_path / "h.npz")
    (jio.save_heterograph if writer == "jax" else tio.save_heterograph)(
        path, hj if writer == "jax" else ht)
    lj, lt = jio.load_heterograph(path), tio.load_heterograph(path)
    for a, b in ((hj, lt), (lj, ht)):
        assert sorted(a.canonical_etypes) == sorted(b.canonical_etypes)
        for c in a.canonical_etypes:
            same_graph(a.relations[c], b.relations[c])
        for nt in ("user", "game"):
            assert a.num_nodes(nt) == b.num_nodes(nt)
        np.testing.assert_array_equal(np.asarray(a.nodes_data("user")["x"]),
                                      _arr(b.nodes_data("user")["x"]))


# ---------------------------------------------------------------------------
# ops.segment.bincount
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weighted", [False, True])
def test_bincount_matches_jax(weighted):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 50, 400).astype(np.int32)
    w = rng.normal(size=400).astype(np.float32) if weighted else None
    ref = np.asarray(jseg.bincount(jnp.asarray(ids),
                                   None if w is None else jnp.asarray(w),
                                   60))
    out = tseg.bincount(torch.from_numpy(ids),
                        None if w is None else torch.from_numpy(w), 60)
    assert out.dtype == torch.float32 and out.shape == (60,)
    if weighted:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(out.numpy(), ref)
        assert float(out.sum()) == 400
