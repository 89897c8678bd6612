"""Synthetic datasets (port of ``molecule_dataset`` and ``bio_dataset`` of
``pretrain_gnns_tpu.data.synthetic``; the same seed gives the same graphs
and extras). ``data.datasets.load_dataset`` serves them to the CLIs as
``synthetic`` and ``synthetic_bio``.

Molecules follow the chem featurization schema: int64 ``x[N, 2]`` (atom
type, chirality), both directions of every bond, int64 ``edge_attr[E, 2]``
(bond type, direction). Ego-networks follow the bio schema: float32
``x = ones(N, 1)``, both directions of every edge, float32 9-dim edge
features ``[w1..w7, self_loop, mask]``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import GRAPH, NODE_IDX, Graph


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

    # task t counts the atoms of type t % 7: seven distinct columns at most
    residues = np.stack(
        [np.bincount(x[:, 0] % 7, minlength=7) for (x, _, _) in raw])
    counts = residues[:, np.arange(num_tasks) % 7]
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


def random_ego_network(
    rng: np.random.Generator, n_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Random ego-network: node 0 is the center and every node is
    reachable from it; edge features are 7 binary evidence channels then
    ``self_loop = mask = 0``."""
    center = 0
    edges = set()
    for v in range(1, n_nodes):
        # attach to a random earlier node: connected, scale-free-ish
        u = int(rng.integers(0, v))
        edges.add((u, v))
    for _ in range(n_nodes // 2):
        a, b = (int(z) for z in rng.integers(0, n_nodes, 2))
        if a != b and (a, b) not in edges and (b, a) not in edges:
            edges.add((a, b))
    ei, ea = [], []
    for a, b in sorted(edges):
        w = (rng.random(7) < 0.3).astype(np.float32)
        feat = np.concatenate([w, [0.0, 0.0]]).astype(np.float32)
        ei += [(a, b), (b, a)]
        ea += [feat, feat]
    x = np.ones((n_nodes, 1), np.float32)
    return x, np.array(ei, np.int64).T, np.stack(ea), center


def bio_dataset(
    n_graphs: int,
    num_downstream: int = 40,
    num_pretrain: int = 60,
    seed: int = 0,
    mean_nodes: int = 60,
    species_pool=(3702, 6239, 511145, 7227, 10090, 4932, 7955, 9606),
) -> List[Graph]:
    """Synthetic protein ego-networks (at most 400 nodes) with the extras
    ``center_node_idx`` (a node index), ``species_id`` and
    ``go_target_pretrain`` (per graph); ``y`` is the {0, 1} downstream
    target, positive iff an evidence channel's share exceeds its median."""
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(n_graphs):
        n = max(8, int(rng.normal(mean_nodes, mean_nodes // 4)))
        raw.append(random_ego_network(rng, min(n, 400)))

    ev_counts = np.stack([
        [ea[:, t % 7].sum() / max(ea.shape[0], 1)
         for t in range(num_downstream)]
        for (_, _, ea, _) in raw
    ])
    med = np.median(ev_counts, axis=0)
    y_down = (ev_counts > med).astype(np.float32)

    graphs = []
    for i, (x, ei, ea, center) in enumerate(raw):
        g = Graph(x, ei, ea, y=y_down[i])
        g.extras["center_node_idx"] = (np.array([center], np.int64),
                                       NODE_IDX)
        g.extras["species_id"] = (
            np.array([species_pool[i % len(species_pool)]], np.int64), GRAPH)
        g.extras["go_target_pretrain"] = (
            (rng.random(num_pretrain) < 0.1).astype(np.float32), GRAPH)
        graphs.append(g)
    return graphs

