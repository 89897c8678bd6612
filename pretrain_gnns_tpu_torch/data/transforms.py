"""Context extraction for context-prediction pretraining (port of
``k_hop_nodes``, ``induced_subgraph``, ``SubstructContextPair``,
``ExtractSubstructureContextPair`` and ``BioExtractSubstructureContextPair``
of ``pretrain_gnns_tpu.data.transforms``).

Each transform takes ``(Graph, np.random.Generator)`` and returns a new
pair of graphs (its input is never changed), or None when the sample has
no context. It draws from the generator exactly as the JAX version does,
so that the same seed gives the same pairs: one ``integers(0, n)`` for the
root when none is given (in bio only without ``center``), nothing else.

The k-hop balls come from one breadth-first walk over a boolean frontier
(:func:`hop_distances`): the same nodes as the JAX package's CSR frontier
expansion, a hop costing one gather over the edges instead of an
``np.isin``, and one walk for all of a sample's radii."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import NODE_IDX, Graph


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
