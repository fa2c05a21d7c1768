"""Molecular regression datasets: QM7b and QM9 (the port's
``dgl1_tpu/data/qm.py``).

The upstream files (``qm7b.mat``, ``qm9_eV.npz``) are parsed when
present; otherwise flagged synthetic molecules from the reference's
seeds: random 3-D conformers as distance-weighted complete graphs, with
targets that are smooth functions of the structure.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from dgl1_tpu_torch.data.base import data_dir, to_tensor
from dgl1_tpu_torch.graph import Graph, graph, resolve_device

__all__ = ["QM7bDataset", "QM9Dataset", "load_qm7b_raw", "load_qm9_raw"]


def _conformer_graph(n_atoms: int, rng, device):
    """The complete graph of a random 3-D conformer: ``edata['w']`` the
    Coulomb off-diagonal z_i z_j / r, ``edata['dist']`` r,
    ``ndata['charge']`` and ``ndata['pos']``."""
    pos = rng.normal(size=(n_atoms, 3)).astype(np.float32)
    z = rng.integers(1, 10, size=n_atoms).astype(np.float32)
    us, vs = np.meshgrid(np.arange(n_atoms), np.arange(n_atoms))
    mask = us != vs
    s, d = us[mask].astype(np.int64), vs[mask].astype(np.int64)
    r = np.linalg.norm(pos[s] - pos[d], axis=1)
    w = (z[s] * z[d] / np.maximum(r, 1e-3)).astype(np.float32)
    g = graph((s, d), num_nodes=n_atoms, device=device)
    g.ndata["pos"] = to_tensor(pos, device)
    g.ndata["charge"] = to_tensor(z[:, None], device)
    g.edata["dist"] = to_tensor(r.astype(np.float32)[:, None], device)
    g.edata["w"] = to_tensor(w[:, None], device)
    return g, pos, z, w


def load_qm7b_raw(path, num_molecules=None, device=None):
    """``qm7b.mat`` (``python/dgl/data/qm7b.py``): ``X`` (M, 23, 23)
    Coulomb matrices and ``T`` (M, 14) targets; edges at the nonzero
    off-diagonal entries (``edata['w']``), the charge from the diagonal
    0.5 Z^2.4, zero rows absent atoms."""
    from scipy.io import loadmat

    dev = resolve_device(device)
    mat = loadmat(path)
    X = np.asarray(mat["X"], np.float32)
    T = np.asarray(mat["T"], np.float32)
    m = len(X) if num_molecules is None else min(len(X), num_molecules)
    graphs = []
    for i in range(m):
        cm = X[i]
        diag = np.diag(cm)
        n = int(np.count_nonzero(diag))
        cm = cm[:n, :n]
        z = (2.0 * diag[:n]) ** (1.0 / 2.4)
        s, d = np.nonzero(cm - np.diag(np.diag(cm)))
        g = graph((s.astype(np.int64), d.astype(np.int64)), num_nodes=n,
                  device=dev)
        g.ndata["charge"] = to_tensor(z.astype(np.float32)[:, None], dev)
        g.edata["w"] = to_tensor(cm[s, d][:, None], dev)
        graphs.append(g)
    return graphs, T[:m]


class QM7bDataset:
    """Coulomb-matrix molecule regression, 14 targets
    (``dgl.data.QM7bDataset``)."""

    num_tasks = 14

    def __init__(self, num_molecules: int = 512, seed: int = 0,
                 raw_dir=None, device=None):
        dev = resolve_device(device)
        rd = Path(raw_dir) if raw_dir else data_dir() / "qm7b"
        if (rd / "qm7b.mat").exists():
            self.is_synthetic = False
            self.graphs, self.labels = load_qm7b_raw(
                rd / "qm7b.mat", num_molecules=num_molecules, device=dev)
            return
        self.is_synthetic = True
        rng = np.random.default_rng(seed)
        self.graphs: List[Graph] = []
        labels = []
        for _ in range(num_molecules):
            n = int(rng.integers(4, 24))
            g, pos, z, w = _conformer_graph(n, rng, dev)
            base = np.array([
                z.sum(), (z ** 2).sum(), w.sum(), w.mean(), n,
                pos.std(), z.mean(), w.max(),
                np.sort(w)[-min(5, len(w)):].sum(), z.max(), z.min(),
                w.std(), (1 / np.maximum(w, 1e-2)).mean(), float(n) ** 1.5,
            ], np.float32)
            labels.append(base + rng.normal(scale=0.01, size=14))
            self.graphs.append(g)
        self.labels = np.asarray(labels, np.float32)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Tuple[Graph, np.ndarray]:
        return self.graphs[i], self.labels[i]


_QM9_KEYS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0",
             "U", "H", "G", "Cv"]


def load_qm9_raw(path, label_keys: Sequence[str], cutoff: float = 5.0,
                 num_molecules=None, device=None):
    """``qm9_eV.npz`` (``python/dgl/data/qm9.py``): ``N`` atoms a
    molecule, ``R`` positions, ``Z`` atomic numbers and one (M,) array a
    property; graphs complete within ``cutoff``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        counts = z["N"].astype(np.int64)
        R = z["R"].astype(np.float32)
        Z = z["Z"].astype(np.float32)
        targets = np.stack([z[k].astype(np.float32) for k in label_keys],
                           axis=1)
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    m = len(counts) if num_molecules is None else min(len(counts),
                                                       num_molecules)
    graphs, labels = [], []
    for i in range(m):
        lo, n = offsets[i], int(counts[i])
        pos = R[lo: lo + n]
        zch = Z[lo: lo + n]
        us, vs = np.meshgrid(np.arange(n), np.arange(n))
        mask = us != vs
        s, d = us[mask].astype(np.int64), vs[mask].astype(np.int64)
        r = np.linalg.norm(pos[s] - pos[d], axis=1)
        keep = r < cutoff
        s, d, r = s[keep], d[keep], r[keep]
        g = graph((s, d), num_nodes=n, device=dev)
        g.ndata["pos"] = to_tensor(pos, dev)
        g.ndata["charge"] = to_tensor(zch[:, None], dev)
        g.edata["dist"] = to_tensor(r.astype(np.float32)[:, None], dev)
        graphs.append(g)
        labels.append(targets[i])
    return graphs, np.asarray(labels, np.float32)


class QM9Dataset:
    """QM9 molecule regression (``dgl.data.QM9Dataset``): the targets
    ``label_keys`` of the standard 12."""

    def __init__(self, label_keys: Sequence[str] = ("mu",),
                 num_molecules: int = 512, cutoff: float = 5.0,
                 seed: int = 0, raw_dir=None, device=None):
        dev = resolve_device(device)
        unknown = set(label_keys) - set(_QM9_KEYS)
        if unknown:
            raise ValueError(f"unknown QM9 label keys {sorted(unknown)}")
        self.label_keys = list(label_keys)
        rd = Path(raw_dir) if raw_dir else data_dir() / "qm9"
        if (rd / "qm9_eV.npz").exists():
            self.is_synthetic = False
            self.graphs, self.labels = load_qm9_raw(
                rd / "qm9_eV.npz", self.label_keys, cutoff=cutoff,
                num_molecules=num_molecules, device=dev)
            return
        self.is_synthetic = True
        rng = np.random.default_rng(seed)
        self.graphs: List[Graph] = []
        labels = []
        for _ in range(num_molecules):
            n = int(rng.integers(3, 29))
            g, pos, z, w = _conformer_graph(n, rng, dev)
            all_targets = {
                "mu": float(np.linalg.norm((pos * z[:, None]).sum(0))),
                "alpha": float((z ** 1.5).sum()),
                "homo": float(-w.mean()),
                "lumo": float(w.std()),
                "gap": float(w.std() + w.mean()),
                "r2": float((pos ** 2).sum()),
                "zpve": float(n * 0.01),
                "U0": float(-(z ** 2).sum()),
                "U": float(-(z ** 2).sum() + 0.1 * n),
                "H": float(-(z ** 2).sum() + 0.2 * n),
                "G": float(-(z ** 2).sum() + 0.3 * n),
                "Cv": float(z.sum() * 0.05),
            }
            labels.append([all_targets[k] for k in self.label_keys])
            self.graphs.append(g)
        self.labels = np.asarray(labels, np.float32)

    @property
    def num_tasks(self):
        return len(self.label_keys)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i) -> Tuple[Graph, np.ndarray]:
        return self.graphs[i], self.labels[i]
