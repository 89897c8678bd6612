"""Synthetic molecule-like datasets (port of
``pretrain_gnns_tpu.data.synthetic.molecule_dataset``; the same seed gives
the same graphs).

Graphs follow the reference featurization schema: int64 ``x[N, 2]``
(atom type, chirality), both directions of every bond, int64
``edge_attr[E, 2]`` (bond type, direction)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import Graph


def random_molecule(
    rng: np.random.Generator, n_atoms: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random connected chain-plus-chords graph."""
    bonds = [(i, i + 1) for i in range(n_atoms - 1)]
    seen = set(bonds)
    for _ in range(max(0, n_atoms // 3 - 1)):
        a, b = (int(v) for v in rng.integers(0, n_atoms, 2))
        if a != b and (a, b) not in seen and (b, a) not in seen:
            bonds.append((a, b))
            seen.add((a, b))
    ei, ea = [], []
    for a, b in bonds:
        t, d = int(rng.integers(0, 4)), int(rng.integers(0, 3))
        ei += [(a, b), (b, a)]
        ea += [(t, d), (t, d)]
    x = np.stack(
        [rng.integers(0, 119, n_atoms), rng.integers(0, 3, n_atoms)], axis=1
    ).astype(np.int64)
    edge_index = (
        np.array(ei, np.int64).T if ei else np.zeros((2, 0), np.int64)
    )
    edge_attr = np.array(ea, np.int64) if ea else np.zeros((0, 2), np.int64)
    return x, edge_index, edge_attr


def molecule_dataset(
    n_graphs: int,
    num_tasks: int = 1,
    seed: int = 0,
    mean_atoms: int = 23,
    missing_frac: float = 0.0,
) -> Tuple[List[Graph], List[str]]:
    """Labeled synthetic molecules in {-1, 0, +1} label coding; task t is
    positive iff the count of atoms with (type % 7 == t % 7) exceeds its
    median. Returns (graphs, pseudo-scaffold strings)."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n_graphs):
        n = max(4, int(rng.normal(mean_atoms, 6)))
        raw.append(random_molecule(rng, min(n, 60)))

    counts = np.stack(
        [
            [(x[:, 0] % 7 == t % 7).sum() for t in range(num_tasks)]
            for (x, _, _) in raw
        ]
    )
    med = np.median(counts, axis=0)
    labels = np.where(counts > med, 1.0, -1.0)
    if missing_frac > 0:
        drop = rng.random(labels.shape) < missing_frac
        labels = np.where(drop, 0.0, labels)

    graphs, scaffolds = [], []
    for (x, ei, ea), y in zip(raw, labels):
        graphs.append(Graph(x, ei, ea, y=y.astype(np.float32)))
        n_extra = ei.shape[1] // 2 - (x.shape[0] - 1)
        scaffolds.append(f"s{x.shape[0] // 6}_{n_extra // 2}")
    return graphs, scaffolds
