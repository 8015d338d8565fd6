"""The port's molecular datasets (``dgl_hack_tpu_torch.data.chem``) against
the JAX package's: from one seed, the same synthetic molecules (atoms,
bonds, coordinates, ring count), graphs (edges in both orders, node and
edge features), labels, masks and task weights; and the CSV path (pandas +
rdkit), on a file the test writes, read through a stand-in ``rdkit`` that
parses a chain notation, gives the same dataset in both packages.
``TencentAlchemyDataset`` seeds with ``hash(mode)``, which Python salts
per process, so both sides are built here in one process."""
import sys
import types

import numpy as np
import pytest
import torch

from dgl_hack_tpu.data import chem as jdata

from dgl_hack_tpu_torch.data import chem as tdata

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings("ignore:raw .* files not found")


@pytest.fixture(autouse=True)
def data_dir(monkeypatch, tmp_path):
    """An empty download directory: no raw files, the synthetic path."""
    monkeypatch.setenv("DGL_DOWNLOAD_DIR", str(tmp_path))
    return tmp_path


def assert_same_graph(gj, gt):
    for order in ("eid", "internal"):
        for a, b in zip(gj.edges(order=order), gt.edges(order=order)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert set(gj.ndata.keys()) == set(gt.ndata.keys())
    assert set(gj.edata.keys()) == set(gt.edata.keys())
    for k in gj.ndata.keys():
        np.testing.assert_array_equal(np.asarray(gj.ndata[k]),
                                      gt.ndata[k].numpy(), err_msg=k)
    for k in gj.edata.keys():
        np.testing.assert_array_equal(np.asarray(gj.edata[k]),
                                      gt.edata[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(gj.edata_internal[k]),
                                      gt.edata_internal[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_molecules_match_jax(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(10):
        mj, mt = jdata._synthetic_molecule(rj), tdata._synthetic_molecule(rt)
        for f in ("atomic_nums", "src", "dst", "bond_order", "coords"):
            np.testing.assert_array_equal(getattr(mj, f), getattr(mt, f))
        assert mj.n_rings == mt.n_rings
        assert_same_graph(jdata._mol_to_graph(mj), tdata._mol_to_graph(mt))
        for kind, n in (("binary", 12), ("reg", 5)):
            np.testing.assert_array_equal(
                jdata._structure_labels(mj, n, kind, rj),
                tdata._structure_labels(mt, n, kind, rt))


def test_featurizers_match_jax():
    rng = np.random.default_rng(1)
    z = rng.choice(jdata.ATOM_TYPES + [5, 53], size=40)
    deg = rng.integers(0, 8, 40)
    np.testing.assert_array_equal(jdata.atom_featurizer(z, deg),
                                  tdata.atom_featurizer(z, deg))
    order = rng.integers(0, 5, 30)
    np.testing.assert_array_equal(jdata.bond_featurizer(order),
                                  tdata.bond_featurizer(order))
    assert tdata.ATOM_TYPES == jdata.ATOM_TYPES


def _same_csv_dataset(dj, dt_):
    assert dj.smiles == dt_.smiles and dj.task_names == dt_.task_names
    assert len(dj) == len(dt_)
    np.testing.assert_array_equal(dj.labels, dt_.labels)
    np.testing.assert_array_equal(dj.mask, dt_.mask)
    for gj, gt in zip(dj.graphs, dt_.graphs):
        assert_same_graph(gj, gt)


@pytest.mark.parametrize("seed", [0, 2])
def test_tox21_and_aromaticity_match_jax(seed):
    dj, dt_ = jdata.Tox21(n_mols=16, seed=seed), tdata.Tox21(n_mols=16,
                                                            seed=seed)
    _same_csv_dataset(dj, dt_)
    np.testing.assert_array_equal(dj.task_pos_weights, dt_.task_pos_weights)
    assert 0.0 < dt_.mask.mean() < 1.0            # missing labels drawn
    _same_csv_dataset(jdata.PubChemBioAssayAromaticity(n_mols=12, seed=seed),
                      tdata.PubChemBioAssayAromaticity(n_mols=12, seed=seed))
    s, g, y, m = dt_[3]
    assert s == dj[3][0] and y.shape == m.shape == (12,)


@pytest.mark.parametrize("mode", ["dev", "valid"])
def test_alchemy_matches_jax_in_one_process(mode):
    dj = jdata.TencentAlchemyDataset(mode=mode, n_mols=12, seed=1)
    dt_ = tdata.TencentAlchemyDataset(mode=mode, n_mols=12, seed=1)
    np.testing.assert_array_equal(dj.labels, dt_.labels)
    np.testing.assert_array_equal(dj.mean, dt_.mean)
    np.testing.assert_array_equal(dj.std, dt_.std)
    assert dj.task_names == dt_.task_names and len(dt_) == 12
    for gj, gt in zip(dj.graphs, dt_.graphs):
        assert_same_graph(gj, gt)
    dt_.set_mean_and_std(mean=np.zeros(12))
    assert (dt_.mean == 0).all() and dt_[0][1].shape == (12,)


_SYMBOLS = {"C": 6, "N": 7, "O": 8, "F": 9, "S": 16, "Cl": 17, "Br": 35}
_BONDS = {"-": 1.0, "=": 2.0, "#": 3.0}


def _fake_rdkit():
    """A stand-in ``rdkit`` whose ``Chem.MolFromSmiles`` reads a chain of
    element symbols joined by bond characters ("C-C=O"); anything else is
    not a molecule (None)."""
    import re

    class Atom:
        def __init__(self, z):
            self.z = z

        def GetAtomicNum(self):
            return self.z

    class Bond:
        def __init__(self, i, order):
            self.i, self.order = i, order

        def GetBeginAtomIdx(self):
            return self.i

        def GetEndAtomIdx(self):
            return self.i + 1

        def GetBondTypeAsDouble(self):
            return self.order

    class Mol:
        def __init__(self, atoms, bonds):
            self.atoms, self.bonds = atoms, bonds

        def GetNumAtoms(self):
            return len(self.atoms)

        def GetAtoms(self):
            return self.atoms

        def GetBonds(self):
            return self.bonds

    def mol_from_smiles(s):
        parts = re.split(r"([-=#])", s)
        if any(p not in _SYMBOLS for p in parts[::2]):
            return None
        atoms = [Atom(_SYMBOLS[p]) for p in parts[::2]]
        bonds = [Bond(i, _BONDS[b]) for i, b in enumerate(parts[1::2])]
        return Mol(atoms, bonds)

    rdkit = types.ModuleType("rdkit")
    rdkit.Chem = types.SimpleNamespace(MolFromSmiles=mol_from_smiles)
    return rdkit


def test_csv_path_matches_jax(monkeypatch, data_dir):
    """Tox21's real path and the general CSV reader on a written file:
    rows that do not parse are dropped, missing labels are 0 with mask 0,
    the task columns default to all but the SMILES and mol_id ones."""
    monkeypatch.setitem(sys.modules, "rdkit", _fake_rdkit())
    rng = np.random.default_rng(4)
    smiles = ["C-C=O", "N#C-C", "not a molecule", "C-Cl", "O=C-N-C=O",
              "C-S-Br", "F-C-F"]
    lines = ["smiles,mol_id," + ",".join(tdata._TOX21_TASKS)]
    for i, s in enumerate(smiles):
        vals = ["" if rng.random() < 0.3 else str(int(rng.integers(0, 2)))
                for _ in tdata._TOX21_TASKS]
        lines.append(f"{s},m{i}," + ",".join(vals))
    (data_dir / "tox21.csv").write_text("\n".join(lines) + "\n")
    dj, dt_ = jdata.Tox21(), tdata.Tox21()
    assert len(dt_) == len(smiles) - 1 and "not a molecule" not in dt_.smiles
    _same_csv_dataset(dj, dt_)
    np.testing.assert_array_equal(dj.task_pos_weights, dt_.task_pos_weights)
    path = str(data_dir / "tox21.csv")
    _same_csv_dataset(jdata._try_load_csv(path, "smiles"),
                      tdata._try_load_csv(path, "smiles"))
    assert tdata._try_load_csv(path, "smiles").task_names == \
        tdata._TOX21_TASKS
    assert tdata._try_load_csv(str(data_dir / "none.csv"), "smiles") is None
