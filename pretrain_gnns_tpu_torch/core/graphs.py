"""Static-shape packed graph batches (port of
``pretrain_gnns_tpu.core.graphs``).

The packers run on the host in numpy and return a :class:`PackedGraphs`
whose leaves are numpy arrays; ``PackedGraphs.to(device)`` turns every
leaf into a torch tensor on that device.

Padding convention (every kernel relies on it):
- padded node rows have ``node_graph == 0`` and ``node_mask == False``;
- padded edge rows have ``senders == receivers == 0`` and
  ``edge_mask == False``.

Edge direction: a message flows from ``senders`` (= reference
``edge_index[1]``) into ``receivers`` (= reference ``edge_index[0]``).
Self-loops are not materialized; the convs add them analytically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# how packing treats auxiliary per-graph arrays
NODE_IDX = "node_idx"  # node indices -> offset by the node cursor
EDGE_IDX = "edge_idx"  # edge indices -> offset by the edge cursor
NODE_ROW = "node_row"  # one row per node
EDGE_ROW = "edge_row"  # one row per edge
GRAPH = "graph"  # one row per graph
RAW = "raw"  # concatenated without offsets


@dataclasses.dataclass
class Graph:
    """One host graph. ``edge_index`` is ``[2, E]``: row 0 receivers,
    row 1 senders."""

    node_feat: np.ndarray  # [N, Fn]
    edge_index: np.ndarray  # [2, E] int
    edge_feat: np.ndarray  # [E, Fe]
    y: Optional[np.ndarray] = None  # [T]
    extras: Dict[str, Tuple[np.ndarray, str]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


_LEAVES = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
           "node_mask", "edge_mask", "graph_mask", "y")


@dataclasses.dataclass
class PackedGraphs:
    """Fixed-shape batch of graphs; leaves are numpy arrays on the host and
    torch tensors after :meth:`to`.

    With ``block_nodes > 0`` the batch has the block-diagonal layout of
    :func:`pack_graphs_blocked`: every edge in edge block ``b`` has both
    endpoints in node block ``b``. The CUDA kernels require it."""

    node_feat: Any  # [N_pad, Fn]
    edge_feat: Any  # [E_pad, Fe]
    senders: Any  # [E_pad] int32
    receivers: Any  # [E_pad] int32
    node_graph: Any  # [N_pad] int32
    node_mask: Any  # [N_pad] bool
    edge_mask: Any  # [E_pad] bool
    graph_mask: Any  # [G_pad] bool
    y: Any = None  # [G_pad, T]
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    block_nodes: int = 0
    block_edges: int = 0

    @property
    def max_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def max_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def max_graphs(self) -> int:
        return int(self.graph_mask.shape[0])

    def replace(self, **changes) -> "PackedGraphs":
        return dataclasses.replace(self, **changes)

    def nodes_per_graph(self) -> torch.Tensor:
        """[G_pad] int32 number of valid nodes per graph slot (tensor
        leaves, i.e. after :meth:`to`)."""
        out = torch.zeros(self.max_graphs, dtype=torch.int32,
                          device=self.node_mask.device)
        return out.index_add(0, self.node_graph.long(),
                             self.node_mask.to(torch.int32))

    def in_degree(self, include_self_loop: bool = False) -> torch.Tensor:
        """[N_pad] int32 count of valid incoming edges per node, on the
        receiver side (tensor leaves, i.e. after :meth:`to`)."""
        out = torch.zeros(self.max_nodes, dtype=torch.int32,
                          device=self.edge_mask.device)
        deg = out.index_add(0, self.receivers.long(),
                            self.edge_mask.to(torch.int32))
        if include_self_loop:
            deg = deg + self.node_mask.to(torch.int32)
        return deg

    def leaves(self) -> Dict[str, Any]:
        """Every array leaf by name, the extras as ``extras/<key>``; the
        leaves that are ``None`` are left out."""
        out = {f: getattr(self, f) for f in _LEAVES
               if getattr(self, f) is not None}
        out.update((f"extras/{k}", v) for k, v in self.extras.items())
        return out

    def _map(self, fn) -> "PackedGraphs":
        """Apply ``fn`` to every array leaf, as a torch tensor."""

        def put(a):
            if a is None:
                return None
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a)
            )
            return fn(t)

        return dataclasses.replace(
            self, **{f: put(getattr(self, f)) for f in _LEAVES},
            extras={k: put(v) for k, v in self.extras.items()})

    def to(self, device, non_blocking: bool = False) -> "PackedGraphs":
        """Every array leaf as a torch tensor on ``device``. With
        ``non_blocking``, copies from pinned leaves do not wait for the
        device."""
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "PackedGraphs":
        """Every array leaf as a page-locked host tensor (needs CUDA)."""
        return self._map(lambda t: t.pin_memory())

    @property
    def layout(self) -> tuple:
        """The block layout of each stream: ``((block_nodes,
        block_edges),)``."""
        return ((self.block_nodes, self.block_edges),)


@dataclasses.dataclass
class PackedPair:
    """Context prediction's batch: two independent streams aligned by
    graph slot, each a :class:`PackedGraphs` with its own buffers and
    block layout. ``substruct`` carries ``center_substruct_idx`` [G] (a
    node row of its stream), ``context`` the overlap rows
    ``overlap_context_substruct_idx`` and their mask."""

    substruct: PackedGraphs
    context: PackedGraphs

    def leaves(self) -> Dict[str, Any]:
        """Both streams' leaves, named ``substruct/<leaf>`` and
        ``context/<leaf>``."""
        return {f"{name}/{k}": v for name in ("substruct", "context")
                for k, v in getattr(self, name).leaves().items()}

    def _map(self, fn) -> "PackedPair":
        return PackedPair(self.substruct._map(fn), self.context._map(fn))

    def to(self, device, non_blocking: bool = False) -> "PackedPair":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "PackedPair":
        return self._map(lambda t: t.pin_memory())

    @property
    def layout(self) -> tuple:
        return self.substruct.layout + self.context.layout


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] > n:
        raise ValueError(f"cannot pack {a.shape[0]} rows into {n}")
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def pack_graphs(
    graphs: Sequence[Graph],
    max_nodes: int,
    max_edges: int,
    max_graphs: Optional[int] = None,
    extra_pad: Optional[Mapping[str, int]] = None,
) -> PackedGraphs:
    """Pack host graphs contiguously into fixed-size buffers. Each extra
    key ``k`` yields ``extras[k]`` plus a mask ``extras[k + "_mask"]``."""
    if max_graphs is None:
        max_graphs = len(graphs)
    if len(graphs) > max_graphs:
        raise ValueError(f"{len(graphs)} graphs > max_graphs={max_graphs}")
    if not graphs:
        raise ValueError("cannot pack an empty list of graphs")

    n_tot = sum(g.num_nodes for g in graphs)
    e_tot = sum(g.num_edges for g in graphs)
    if n_tot > max_nodes or e_tot > max_edges:
        raise ValueError(
            f"batch has {n_tot} nodes / {e_tot} edges; buffers are "
            f"{max_nodes} / {max_edges}"
        )

    node_feat = _pad_rows(
        np.concatenate([g.node_feat for g in graphs], axis=0), max_nodes
    )
    edge_feat = _pad_rows(
        np.concatenate([g.edge_feat for g in graphs], axis=0), max_edges
    )
    node_off = np.cumsum([0] + [g.num_nodes for g in graphs])
    edge_off = np.cumsum([0] + [g.num_edges for g in graphs])
    ei = np.concatenate(
        [g.edge_index + node_off[i] for i, g in enumerate(graphs)], axis=1
    ).astype(np.int32)
    receivers = _pad_rows(ei[0], max_edges)
    senders = _pad_rows(ei[1], max_edges)
    node_graph = _pad_rows(
        np.concatenate(
            [np.full(g.num_nodes, i, np.int32) for i, g in enumerate(graphs)]
        ),
        max_nodes,
    )
    node_mask = np.zeros(max_nodes, bool)
    node_mask[:n_tot] = True
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[:e_tot] = True
    graph_mask = np.zeros(max_graphs, bool)
    graph_mask[: len(graphs)] = True

    y = None
    if graphs[0].y is not None:
        y = _pad_rows(np.stack([np.asarray(g.y) for g in graphs]), max_graphs)

    extras: Dict[str, np.ndarray] = {}
    keys = set()
    for g in graphs:
        keys.update(g.extras.keys())
    for k in sorted(keys):
        kinds = {g.extras[k][1] for g in graphs if k in g.extras}
        if len(kinds) != 1:
            raise ValueError(f"extra {k!r} has inconsistent kinds {kinds}")
        kind = kinds.pop()
        parts = []
        for i, g in enumerate(graphs):
            if k not in g.extras:
                continue
            a = np.asarray(g.extras[k][0])
            if kind == NODE_IDX:
                a = a.astype(np.int32) + node_off[i]
            elif kind == EDGE_IDX:
                a = a.astype(np.int32) + edge_off[i]
            parts.append(a)
        cat = (np.stack(parts, axis=0) if kind == GRAPH
               else np.concatenate(parts, axis=0))
        if kind == NODE_ROW:
            pad_n = max_nodes
        elif kind == EDGE_ROW:
            pad_n = max_edges
        elif kind == GRAPH:
            pad_n = max_graphs
        elif extra_pad is not None and k in extra_pad:
            pad_n = extra_pad[k]
        else:
            raise ValueError(
                f"extra {k!r} of kind {kind!r} needs an extra_pad entry"
            )
        mask = np.zeros(pad_n, bool)
        mask[: cat.shape[0]] = True
        extras[k] = _pad_rows(cat, pad_n)
        extras[k + "_mask"] = mask

    return PackedGraphs(
        node_feat=node_feat, edge_feat=edge_feat, senders=senders,
        receivers=receivers, node_graph=node_graph, node_mask=node_mask,
        edge_mask=edge_mask, graph_mask=graph_mask, y=y, extras=extras,
    )


def pack_graphs_blocked(
    graphs: Sequence[Graph],
    n_blocks: int,
    block_nodes: int = 256,
    block_edges: int = 768,
    max_graphs: Optional[int] = None,
    extra_pad: Optional[Mapping[str, int]] = None,
) -> PackedGraphs:
    """Pack graphs first-fit into ``n_blocks`` blocks of (block_nodes,
    block_edges) capacity. Within a block, node rows and edge slots are
    contiguous and padded to the block boundary, so every edge slot of
    block b references node rows in [b*block_nodes, (b+1)*block_nodes).
    Graph slots stay in input order."""
    if max_graphs is None:
        max_graphs = len(graphs)
    n_cursor = np.zeros(len(graphs), int)
    e_cursor = np.zeros(len(graphs), int)
    fill_n = np.zeros(n_blocks, int)
    fill_e = np.zeros(n_blocks, int)
    for i, g in enumerate(graphs):
        if g.num_nodes > block_nodes or g.num_edges > block_edges:
            raise ValueError(
                f"graph ({g.num_nodes}n/{g.num_edges}e) exceeds block "
                f"capacity ({block_nodes}/{block_edges})"
            )
        for b in range(n_blocks):
            if (fill_n[b] + g.num_nodes <= block_nodes
                    and fill_e[b] + g.num_edges <= block_edges):
                n_cursor[i] = b * block_nodes + fill_n[b]
                e_cursor[i] = b * block_edges + fill_e[b]
                fill_n[b] += g.num_nodes
                fill_e[b] += g.num_edges
                break
        else:
            raise ValueError("graphs do not fit the requested blocks")

    max_nodes = n_blocks * block_nodes
    max_edges = n_blocks * block_edges
    fn = graphs[0].node_feat.shape[1:]
    fe = graphs[0].edge_feat.shape[1:]
    node_feat = np.zeros((max_nodes,) + fn, graphs[0].node_feat.dtype)
    edge_feat = np.zeros((max_edges,) + fe, graphs[0].edge_feat.dtype)
    senders = np.zeros(max_edges, np.int32)
    receivers = np.zeros(max_edges, np.int32)
    node_graph = np.zeros(max_nodes, np.int32)
    node_mask = np.zeros(max_nodes, bool)
    edge_mask = np.zeros(max_edges, bool)
    graph_mask = np.zeros(max_graphs, bool)
    ys = None

    extras_parts: Dict[str, list] = {}
    kinds: Dict[str, str] = {}
    for gid, g in enumerate(graphs):
        n_off = int(n_cursor[gid])
        e_off = int(e_cursor[gid])
        nn_, ne = g.num_nodes, g.num_edges
        node_feat[n_off: n_off + nn_] = g.node_feat
        edge_feat[e_off: e_off + ne] = g.edge_feat
        receivers[e_off: e_off + ne] = g.edge_index[0] + n_off
        senders[e_off: e_off + ne] = g.edge_index[1] + n_off
        node_graph[n_off: n_off + nn_] = gid
        node_mask[n_off: n_off + nn_] = True
        edge_mask[e_off: e_off + ne] = True
        graph_mask[gid] = True
        if g.y is not None:
            if ys is None:
                ys = np.zeros((max_graphs,) + np.asarray(g.y).shape,
                              np.asarray(g.y).dtype)
            ys[gid] = g.y
        for k, (arr, kind) in g.extras.items():
            arr = np.asarray(arr)
            if kind == NODE_IDX:
                arr = arr.astype(np.int32) + n_off
            elif kind == EDGE_IDX:
                arr = arr.astype(np.int32) + e_off
            extras_parts.setdefault(k, []).append(arr)
            kinds[k] = kind

    extras: Dict[str, np.ndarray] = {}
    for k, parts in extras_parts.items():
        kind = kinds[k]
        cat = (np.stack(parts, axis=0) if kind == GRAPH
               else np.concatenate(parts, axis=0))
        if kind in (NODE_ROW, EDGE_ROW):
            raise NotImplementedError(
                "row-kind extras unsupported in blocked packing"
            )
        pad_n = max_graphs if kind == GRAPH else (extra_pad or {}).get(k)
        if pad_n is None:
            raise ValueError(f"extra {k!r} needs an extra_pad entry")
        mask = np.zeros(pad_n, bool)
        mask[: cat.shape[0]] = True
        extras[k] = _pad_rows(cat, pad_n)
        extras[k + "_mask"] = mask

    return PackedGraphs(
        node_feat=node_feat, edge_feat=edge_feat, senders=senders,
        receivers=receivers, node_graph=node_graph, node_mask=node_mask,
        edge_mask=edge_mask, graph_mask=graph_mask, y=ys, extras=extras,
        block_nodes=block_nodes, block_edges=block_edges,
    )
