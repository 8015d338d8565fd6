"""Molecular datasets, as ``dgl_hack_tpu.data.chem`` (reference:
python/dgl/data/chem/datasets/ — csv_dataset.py, tox21.py, alchemy.py,
pubchem_aromaticity.py, and the featurizers of data/chem/utils/
featurizers.py).

The same generator draws the same ``default_rng`` stream, so a seed gives
the same molecules, features and labels in both packages.  Nothing is
downloaded: ``MoleculeCSVDataset`` parses a CSV of SMILES and task columns
when pandas and rdkit import and the file is under ``$DGL_DOWNLOAD_DIR``;
otherwise every loader falls back to the synthetic molecule generator
(random trees plus ring closures with organic atom-type marginals and 3D
conformers), whose labels are functions of the structure.

``TencentAlchemyDataset`` seeds with ``seed + hash(mode) % 1000``, as the
JAX module does.  Python salts ``str`` hashes per process, so its molecules
agree with the JAX package's only within one process (or under one
``PYTHONHASHSEED``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..core.graph import Graph, _build
from .citation import _data_dir
from .extra import _warn_synth

# atomic numbers and sampling weights approximating organic chemistry
_ATOMS = np.array([6, 7, 8, 9, 16, 17, 35])          # C N O F S Cl Br
_ATOM_P = np.array([0.62, 0.11, 0.14, 0.04, 0.04, 0.04, 0.01])
ATOM_TYPES = _ATOMS.tolist()


def atom_featurizer(atomic_nums: np.ndarray, degrees: np.ndarray) -> np.ndarray:
    """Simplified CanonicalAtomFeaturizer: one-hot atom type (7) ++ one-hot
    degree 0..5 (6) ++ [is_heteroatom] -> (N, 14) float32."""
    n = atomic_nums.shape[0]
    type_idx = np.searchsorted(_ATOMS, atomic_nums)
    one_hot_t = np.zeros((n, len(_ATOMS)), np.float32)
    one_hot_t[np.arange(n), np.clip(type_idx, 0, len(_ATOMS) - 1)] = 1.0
    one_hot_d = np.zeros((n, 6), np.float32)
    one_hot_d[np.arange(n), np.clip(degrees, 0, 5)] = 1.0
    hetero = (atomic_nums != 6).astype(np.float32)[:, None]
    return np.concatenate([one_hot_t, one_hot_d, hetero], axis=1)


def bond_featurizer(order: np.ndarray) -> np.ndarray:
    """One-hot bond order 1/2/3 + in-ring flag -> (E, 4) float32."""
    e = order.shape[0]
    out = np.zeros((e, 4), np.float32)
    out[np.arange(e), np.clip(order.astype(int) - 1, 0, 2)] = 1.0
    return out


@dataclass
class _Mol:
    atomic_nums: np.ndarray      # (n,) int
    src: np.ndarray              # (e,) directed both ways
    dst: np.ndarray
    bond_order: np.ndarray       # (e,)
    coords: np.ndarray           # (n, 3)
    n_rings: int


def _synthetic_molecule(rng: np.random.Generator,
                        n_min: int = 8, n_max: int = 24) -> _Mol:
    """Random tree + ring closures with a crude 3D embedding."""
    n = int(rng.integers(n_min, n_max + 1))
    parents = np.array([int(rng.integers(0, i)) for i in range(1, n)])
    u = np.arange(1, n)
    v = parents
    n_rings = int(rng.integers(0, max(2, n // 8) + 1))
    extra_u, extra_v = [], []
    for _ in range(n_rings):
        a, b = rng.integers(0, n, 2)
        if a != b:
            extra_u.append(a)
            extra_v.append(b)
    su = np.concatenate([u, np.asarray(extra_u, np.int64)])
    sv = np.concatenate([v, np.asarray(extra_v, np.int64)])
    order = rng.choice([1, 1, 1, 2, 3], size=su.shape[0])
    atomic = rng.choice(_ATOMS, size=n, p=_ATOM_P)
    # 3D: place each atom near its tree parent at ~1.5 A
    coords = np.zeros((n, 3))
    for i in range(1, n):
        step = rng.normal(size=3)
        coords[i] = coords[parents[i - 1]] + 1.5 * step / np.linalg.norm(step)
    src = np.concatenate([su, sv]).astype(np.int32)
    dst = np.concatenate([sv, su]).astype(np.int32)
    return _Mol(atomic, src, dst,
                np.concatenate([order, order]).astype(np.int32),
                coords, len(extra_u))


def _mol_to_graph(m: _Mol) -> Graph:
    n = m.atomic_nums.shape[0]
    g = _build(m.src, m.dst, n, n, is_block=False)
    deg = np.bincount(m.dst, minlength=n)
    g.ndata["h"] = atom_featurizer(m.atomic_nums, deg)
    g.ndata["atomic_number"] = m.atomic_nums.astype(np.int32)
    g.ndata["coords"] = m.coords.astype(np.float32)
    g.edata["e"] = bond_featurizer(m.bond_order)
    g.edata["distance"] = np.linalg.norm(
        m.coords[m.src] - m.coords[m.dst], axis=1).astype(np.float32)[:, None]
    return g


def _structure_labels(m: _Mol, n_tasks: int, kind: str,
                      rng: np.random.Generator) -> np.ndarray:
    """Deterministic structural descriptors so synthetic labels are
    learnable: atom-type fractions, ring count, mean degree, size."""
    n = m.atomic_nums.shape[0]
    fracs = [(m.atomic_nums == a).mean() for a in _ATOMS]
    deg = np.bincount(m.dst, minlength=n)
    desc = np.array(fracs + [m.n_rings / 4.0, deg.mean() / 4.0, n / 24.0,
                             (m.bond_order > 1).mean(),
                             m.coords.std()])
    w = np.random.default_rng(7).normal(size=(desc.shape[0], n_tasks))
    y = desc @ w
    if kind == "binary":
        return (y > np.median(y)).astype(np.float32)
    return y.astype(np.float32)


@dataclass
class MoleculeCSVDataset:
    """General SMILES-CSV molecular dataset (reference: csv_dataset.py).

    __getitem__ -> (smiles, Graph, label (T,), mask (T,)); missing labels
    are 0 with mask 0."""
    smiles: List[str]
    graphs: List[Graph]
    labels: np.ndarray
    mask: np.ndarray
    task_names: List[str]

    @property
    def n_tasks(self) -> int:
        return len(self.task_names)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.smiles[i], self.graphs[i], self.labels[i], self.mask[i]


def _synthetic_csv_dataset(name: str, n_mols: int, task_names: List[str],
                           kind: str, seed: int,
                           missing_frac: float = 0.0) -> MoleculeCSVDataset:
    rng = np.random.default_rng(seed)
    graphs, labels, smiles = [], [], []
    for i in range(n_mols):
        m = _synthetic_molecule(rng)
        graphs.append(_mol_to_graph(m))
        labels.append(_structure_labels(m, len(task_names), kind, rng))
        smiles.append(f"SYN[{name}:{i}]")
    labels = np.stack(labels)
    mask = (rng.random(labels.shape) >= missing_frac).astype(np.float32)
    labels = labels * mask
    return MoleculeCSVDataset(smiles, graphs, labels, mask, list(task_names))


def _try_load_csv(path: str, smiles_column: str,
                  task_names: Optional[Sequence[str]] = None
                  ) -> Optional[MoleculeCSVDataset]:
    """Real path: pandas CSV + rdkit SMILES parsing, when both import and
    the file exists."""
    if not os.path.exists(path):
        return None
    try:
        import pandas as pd
        from rdkit import Chem
    except ImportError:
        return None
    df = pd.read_csv(path)
    names = list(task_names) if task_names is not None else \
        [c for c in df.columns if c not in (smiles_column, "mol_id")]
    graphs, labels, mask, smiles = [], [], [], []
    for _, row in df.iterrows():
        mol = Chem.MolFromSmiles(row[smiles_column])
        if mol is None:
            continue
        n = mol.GetNumAtoms()
        atomic = np.array([a.GetAtomicNum() for a in mol.GetAtoms()])
        us = np.array([b.GetBeginAtomIdx() for b in mol.GetBonds()])
        vs = np.array([b.GetEndAtomIdx() for b in mol.GetBonds()])
        order = np.array([int(b.GetBondTypeAsDouble()) for b in mol.GetBonds()])
        m = _Mol(atomic, np.concatenate([us, vs]).astype(np.int32),
                 np.concatenate([vs, us]).astype(np.int32),
                 np.concatenate([order, order]).astype(np.int32),
                 np.zeros((n, 3)), 0)
        graphs.append(_mol_to_graph(m))
        vals = row[names].to_numpy(dtype=np.float64)
        mask.append(~np.isnan(vals))
        labels.append(np.nan_to_num(vals))
        smiles.append(row[smiles_column])
    return MoleculeCSVDataset(smiles, graphs,
                              np.asarray(labels, np.float32),
                              np.asarray(mask, np.float32), names)


_TOX21_TASKS = ["NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER",
                "NR-ER-LBD", "NR-PPAR-gamma", "SR-ARE", "SR-ATAD5",
                "SR-HSE", "SR-MMP", "SR-p53"]


class Tox21(MoleculeCSVDataset):
    """Tox21 12-task toxicity classification (reference: tox21.py), with
    per-task positive-sample weights for the class imbalance."""

    def __init__(self, n_mols: int = 512, seed: int = 0):
        root = _data_dir()
        real = _try_load_csv(os.path.join(root, "tox21.csv"), "smiles",
                             _TOX21_TASKS)
        if real is None:
            _warn_synth("tox21", root)
            real = _synthetic_csv_dataset("tox21", n_mols, _TOX21_TASKS,
                                          "binary", seed, missing_frac=0.15)
        super().__init__(real.smiles, real.graphs, real.labels, real.mask,
                         real.task_names)
        num_pos = (self.labels * self.mask).sum(0)
        num_ind = self.mask.sum(0)
        self._task_pos_weights = (num_ind - num_pos) / np.maximum(num_pos, 1)

    @property
    def task_pos_weights(self) -> np.ndarray:
        return self._task_pos_weights


class PubChemBioAssayAromaticity(MoleculeCSVDataset):
    """Aromatic-atom-count regression (reference:
    pubchem_aromaticity.py)."""

    def __init__(self, n_mols: int = 256, seed: int = 0):
        root = _data_dir()
        real = _try_load_csv(
            os.path.join(root, "pubchem_aromaticity.csv"), "cano_smiles")
        if real is None:
            _warn_synth("pubchem_aromaticity", root)
            rng = np.random.default_rng(seed)
            graphs, labels, smiles = [], [], []
            for i in range(n_mols):
                m = _synthetic_molecule(rng)
                graphs.append(_mol_to_graph(m))
                # stand-in aromaticity: ring-closure edges x 6
                labels.append([float(m.n_rings * 6)])
                smiles.append(f"SYN[arom:{i}]")
            real = MoleculeCSVDataset(
                smiles, graphs, np.asarray(labels, np.float32),
                np.ones((n_mols, 1), np.float32), ["aromaticity"])
        super().__init__(real.smiles, real.graphs, real.labels, real.mask,
                         real.task_names)


_ALCHEMY_TASKS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
                  "u0", "u298", "h298", "g298", "cv"]


@dataclass
class TencentAlchemyDataset:
    """Quantum-property regression with 3D geometry (reference:
    alchemy.py): graphs carry ``atomic_number`` node data and per-edge
    ``distance``, the inputs of SchNet and MGCN.
    __getitem__ -> (Graph, label (12,))."""
    graphs: List[Graph] = field(default_factory=list)
    labels: np.ndarray = field(default=None)
    task_names: List[str] = field(default_factory=lambda: list(_ALCHEMY_TASKS))
    mean: np.ndarray = field(default=None)
    std: np.ndarray = field(default=None)

    def __init__(self, mode: str = "dev", n_mols: int = 256, seed: int = 0):
        root = _data_dir()
        sdf_dir = os.path.join(root, f"Alchemy_data/{mode}")
        if os.path.isdir(sdf_dir):
            raise NotImplementedError(
                "real Alchemy SDF parsing requires rdkit, which this package "
                "does not use")
        _warn_synth("alchemy", root)
        rng = np.random.default_rng(seed + hash(mode) % 1000)
        self.graphs, labels = [], []
        for _ in range(n_mols):
            m = _synthetic_molecule(rng)
            self.graphs.append(_mol_to_graph(m))
            labels.append(_structure_labels(m, 12, "reg", rng))
        self.labels = np.stack(labels).astype(np.float32)
        self.task_names = list(_ALCHEMY_TASKS)
        self.mean = self.labels.mean(0)
        self.std = self.labels.std(0) + 1e-8

    def set_mean_and_std(self, mean=None, std=None):
        """Reference: alchemy.py set_mean_and_std."""
        if mean is not None:
            self.mean = np.asarray(mean)
        if std is not None:
            self.std = np.asarray(std)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i], self.labels[i]
