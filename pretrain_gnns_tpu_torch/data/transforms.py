"""The per-graph transforms of self-supervised pretraining (port of
``pretrain_gnns_tpu.data.transforms``): attribute masking (``MaskAtom``
for chem, ``MaskEdge`` for bio), negative sampling (``NegativeEdge``) and
context extraction (``k_hop_nodes``, ``induced_subgraph``,
``SubstructContextPair``, ``ExtractSubstructureContextPair`` and
``BioExtractSubstructureContextPair``).

Each transform takes ``(Graph, np.random.Generator)`` and returns a new
graph or pair of graphs (its input is never changed), or, for a context
extraction, None when the sample has no context. It draws from the
generator exactly as the JAX version does, so that the same seed gives
the same output: ``MaskAtom`` one ``choice`` of the atoms, ``MaskEdge``
one ``choice`` of the bonds, ``NegativeEdge`` one ``integers`` block of
``5 * E`` candidate pairs, a context extraction one ``integers(0, n)`` for
the root when none is given (in bio only without ``center``). The
masking and negative transforms run per graph in the loader
(``data.packing.PackedLoader(transform=...)``), the reference's
placement, under ``transform_device="host"``; ``data.batch_transforms``
holds their one-pass-a-batch forms, which emit the same extras.

The k-hop balls come from one breadth-first walk over a boolean frontier
(:func:`hop_distances`): the same nodes as the JAX package's CSR frontier
expansion, a hop costing one gather over the edges instead of an
``np.isin``, and one walk for all of a sample's radii."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import EDGE_IDX, NODE_IDX, RAW, Graph


class MaskAtom:
    """chem/util.py:189-277: ``int(N * rate + 1)`` distinct atoms drawn
    (at most N), their features kept as labels (``mask_node_label``) and
    overwritten with the mask token ``[num_atom_type, 0]``; with
    ``mask_edge`` every bond touching a masked atom is overwritten with
    ``[num_edge_type, 0]`` in both directions, and every second incident
    edge (one direction of each bond) gives ``connected_edge_indices`` and
    ``mask_edge_label``."""

    def __init__(self, num_atom_type: int = 119, num_edge_type: int = 5,
                 mask_rate: float = 0.15, mask_edge: bool = True):
        self.num_atom_type = num_atom_type
        self.num_edge_type = num_edge_type
        self.mask_rate = mask_rate
        self.mask_edge = mask_edge

    def __call__(self, g: Graph, rng: np.random.Generator,
                 masked_atom_indices: Optional[np.ndarray] = None) -> Graph:
        n = g.num_nodes
        if masked_atom_indices is None:
            k = int(n * self.mask_rate + 1)
            masked_atom_indices = rng.choice(n, size=min(k, n),
                                             replace=False)
        masked_atom_indices = np.asarray(masked_atom_indices, np.int64)

        x = g.node_feat.copy()
        labels = x[masked_atom_indices].copy()
        x[masked_atom_indices] = [self.num_atom_type, 0]

        extras = dict(g.extras)
        extras["masked_atom_indices"] = (masked_atom_indices, NODE_IDX)
        extras["mask_node_label"] = (labels, RAW)

        ea = g.edge_feat
        if self.mask_edge:
            ea = ea.copy()
            inc = (np.isin(g.edge_index[0], masked_atom_indices)
                   | np.isin(g.edge_index[1], masked_atom_indices))
            connected = np.where(inc)[0]  # in edge order
            extras["mask_edge_label"] = (ea[connected[::2]].copy(), RAW)
            ea[connected] = [self.num_edge_type, 0]
            extras["connected_edge_indices"] = (
                connected[::2].astype(np.int64), EDGE_IDX)
        return dataclasses.replace(g, node_feat=x, edge_feat=ea,
                                   extras=extras)


class NegativeEdge:
    """chem/util.py:22-52 (bio/util.py:16-44 the same): ``5 * E`` uniform
    node pairs drawn, the first ``E // 2`` kept that are no self-loop, no
    existing directed edge and no repeat, as ``negative_edges`` ``[K, 2]``
    (a node index a column, so that packing offsets them)."""

    def __call__(self, g: Graph, rng: np.random.Generator) -> Graph:
        n, e = g.num_nodes, g.num_edges
        existing = set(zip(g.edge_index[0].tolist(),
                           g.edge_index[1].tolist()))
        cand = rng.integers(0, n, size=(5 * e, 2))
        picked: List[Tuple[int, int]] = []
        seen = set()
        want = e // 2
        for a, b in cand.tolist():
            if a == b or (a, b) in existing or (a, b) in seen:
                continue
            seen.add((a, b))
            picked.append((a, b))
            # checked after a pick, as the reference does: a graph of one
            # directed edge (want 0) keeps every valid candidate
            if len(picked) == want:
                break
        neg = (np.array(picked, np.int64) if picked
               else np.zeros((0, 2), np.int64))
        extras = dict(g.extras)
        extras["negative_edges"] = (neg, NODE_IDX)
        return dataclasses.replace(g, extras=extras)


class MaskEdge:
    """bio/util.py:46-104: ``int(E / 2 * rate + 1)`` distinct bonds drawn
    (at most E / 2; a bond is its even slot, ``masked_edge_idx``), their
    features kept as labels (``mask_edge_label``) and both directions
    overwritten with the mask feature ``[0, ..., 0, 1]``."""

    def __init__(self, mask_rate: float = 0.15):
        self.mask_rate = mask_rate

    def __call__(self, g: Graph, rng: np.random.Generator,
                 masked_edge_indices: Optional[np.ndarray] = None) -> Graph:
        if masked_edge_indices is None:
            num_undirected = g.num_edges // 2
            k = int(num_undirected * self.mask_rate + 1)
            picks = rng.choice(num_undirected, size=min(k, num_undirected),
                               replace=False)
            masked_edge_indices = 2 * picks
        masked_edge_indices = np.asarray(masked_edge_indices, np.int64)

        ea = g.edge_feat.copy()
        labels = ea[masked_edge_indices].copy()
        mask_feat = np.zeros(ea.shape[1], ea.dtype)
        mask_feat[-1] = 1
        ea[masked_edge_indices] = mask_feat
        ea[masked_edge_indices + 1] = mask_feat

        extras = dict(g.extras)
        extras["masked_edge_idx"] = (masked_edge_indices, EDGE_IDX)
        extras["mask_edge_label"] = (labels, RAW)
        return dataclasses.replace(g, edge_feat=ea, extras=extras)


def hop_distances(edge_index: np.ndarray, num_nodes: int, root: int,
                  k: int) -> np.ndarray:
    """``[num_nodes]`` int64: each node's hop count from ``root`` along
    the edges (sender ``edge_index[1]`` to receiver ``edge_index[0]``) up
    to ``k`` hops, -1 for the nodes further away or not reached."""
    dist = np.full(num_nodes, -1, np.int64)
    if k < 0:
        return dist
    dist[root] = 0
    frontier = np.zeros(num_nodes, bool)
    frontier[root] = True
    recv, send = edge_index[0], edge_index[1]
    for hop in range(1, k + 1):
        nxt = np.zeros(num_nodes, bool)
        nxt[recv[frontier[send]]] = True
        nxt &= dist < 0
        if not nxt.any():
            break
        dist[nxt] = hop
        frontier = nxt
    return dist


def _ball(dist: np.ndarray, k: int) -> np.ndarray:
    """The mask of the nodes within ``k`` hops (none for ``k < 0``)."""
    return (dist >= 0) & (dist <= k)


def k_hop_nodes(edge_index: np.ndarray, num_nodes: int, root: int,
                k: int) -> np.ndarray:
    """Nodes within k hops of root (inclusive), ascending, as int64;
    ``k < 0`` gives none (the reference's k = 0 -> -1 quirk)."""
    return np.flatnonzero(
        _ball(hop_distances(edge_index, num_nodes, root, k), k))


def induced_subgraph(g: Graph, nodes: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """The subgraph induced by ``nodes``, kept in ascending order (the
    reference's subgraph relabelling), and the old -> new map (-1 for the
    nodes left out)."""
    nodes = np.sort(np.asarray(nodes, np.int64))
    remap = np.full(g.num_nodes, -1, np.int64)
    remap[nodes] = np.arange(nodes.size)
    keep = (remap[g.edge_index[0]] >= 0) & (remap[g.edge_index[1]] >= 0)
    ei = remap[g.edge_index[:, keep]]
    return (
        Graph(node_feat=g.node_feat[nodes].copy(), edge_index=ei,
              edge_feat=g.edge_feat[keep].copy()),
        remap,
    )


@dataclasses.dataclass
class SubstructContextPair:
    """Two independent graphs: the substructure, with the extra
    ``center_substruct_idx`` (its root, a node index), and the context,
    with ``overlap_context_substruct_idx`` (its nodes that also lie in the
    substructure, in context-local indices)."""

    substruct: Graph
    context: Graph


class ExtractSubstructureContextPair:
    """Chem: the substructure is the ``k``-hop ball around a random root,
    the context the ring between ``l1`` and ``l2`` hops, and the overlap
    the context's nodes inside the substructure. None when the context or
    the overlap is empty."""

    def __init__(self, k: int, l1: int, l2: int):
        self.k, self.l1, self.l2 = k, l1, l2

    def __call__(self, g: Graph, rng: np.random.Generator,
                 root_idx: Optional[int] = None
                 ) -> Optional[SubstructContextPair]:
        n = g.num_nodes
        if root_idx is None:
            root_idx = int(rng.integers(0, n))
        dist = hop_distances(g.edge_index, n, root_idx,
                             max(self.k, self.l1, self.l2))
        sub = _ball(dist, self.k)
        ctx = _ball(dist, self.l1) ^ _ball(dist, self.l2)
        sub_nodes, ctx_nodes = np.flatnonzero(sub), np.flatnonzero(ctx)
        if sub_nodes.size == 0 or ctx_nodes.size == 0:
            return None
        substruct, sub_map = induced_subgraph(g, sub_nodes)
        substruct.extras["center_substruct_idx"] = (
            np.array([sub_map[root_idx]], np.int64), NODE_IDX)
        overlap = np.flatnonzero(ctx & sub)
        if overlap.size == 0:
            return None
        context, ctx_map = induced_subgraph(g, ctx_nodes)
        context.extras["overlap_context_substruct_idx"] = (
            ctx_map[overlap].astype(np.int64), NODE_IDX)
        return SubstructContextPair(substruct, context)


class BioExtractSubstructureContextPair:
    """Bio: the substructure is the whole ego-network, centred on its
    ``center_node_idx`` extra; the context is the nodes outside the
    ``l1``-hop ball around the root (that centre, or a random node when
    ``center`` is False), all of them overlap. ``l1 = 0`` counts as -1,
    an empty ball (the reference's quirk). None when the context is
    empty."""

    def __init__(self, l1: int, center: bool = True):
        self.l1 = -1 if l1 == 0 else l1
        self.center = center

    def __call__(self, g: Graph, rng: np.random.Generator,
                 root_idx: Optional[int] = None
                 ) -> Optional[SubstructContextPair]:
        n = g.num_nodes
        center = np.asarray(g.extras["center_node_idx"][0], np.int64)
        if root_idx is None:
            root_idx = (int(center.reshape(-1)[0]) if self.center
                        else int(rng.integers(0, n)))
        substruct = Graph(node_feat=g.node_feat.copy(),
                          edge_index=g.edge_index.copy(),
                          edge_feat=g.edge_feat.copy())
        substruct.extras["center_substruct_idx"] = (center.reshape(1),
                                                    NODE_IDX)
        ctx_nodes = np.flatnonzero(~_ball(
            hop_distances(g.edge_index, n, root_idx, self.l1), self.l1))
        if ctx_nodes.size == 0:
            return None
        context, ctx_map = induced_subgraph(g, ctx_nodes)
        context.extras["overlap_context_substruct_idx"] = (
            ctx_map[ctx_nodes].astype(np.int64), NODE_IDX)
        return SubstructContextPair(substruct, context)
