"""A dataset held as flat arrays, packed into batches by the C++ packer
(port of ``pretrain_gnns_tpu.data.flat``).

``FlatGraphs`` stores every graph's nodes and edges concatenated, with
offsets, and its labels ``y`` stacked once as ``[G, T]``. ``FlatLoader``
plans each epoch with one ``native.plan_epoch`` call (the greedy first-fit
of ``PackedLoader``, in C++) and packs each batch with one
``native.pack_batch`` call; its batches equal ``PackedLoader``'s and the
JAX package's ``FlatLoader``'s element for element, with integer features
as int32.

Both layouts: contiguous padded buffers, or the block-diagonal layout the
kernels take (``blocks = (n_blocks, block_nodes, block_edges)``). Fixed-
shape per-graph extras of kind ``NODE_IDX`` (offset by the graph's first
node row; bio's ``center_node_idx``) and ``GRAPH`` are packed from the
plan's cursors.

:func:`plan_epoch_plain` and :func:`pack_plain` are the plain versions
(the JAX package's Python walk and numpy loop) that the tests hold the C++
against; no path falls back to them."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np

from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.core.graphs import (
    GRAPH, NODE_IDX, Graph, PackedGraphs, _pad_rows,
)


class NotFlat(ValueError):
    """The graphs' extras do not flatten (one missing on some graphs, of
    another kind than ``NODE_IDX``/``GRAPH``, or of varying shapes): the
    graphs are to be packed one by one. Every other fault of the arrays is
    a plain ``ValueError``."""


def _shrink(a) -> np.ndarray:
    """int64 features as int32: every index fits, and the batch and its
    copy to the card are half the bytes."""
    a = np.asarray(a)
    return np.ascontiguousarray(a.astype(np.int32) if a.dtype == np.int64
                                else a)


class FlatGraphs:
    """Dataset as flat arrays: node and edge features, offsets
    ``node_off``/``edge_off`` [G + 1], graph-local int32 endpoints
    ``recv``/``send``, labels ``y`` [G, ...] and ``extras`` as ``name ->
    (array [G, ...], kind)`` with kinds ``NODE_IDX`` or ``GRAPH``."""

    def __init__(self, node_feat, node_off, recv, send, edge_feat,
                 edge_off, y=None, extras=None):
        self.node_feat = _shrink(node_feat)
        self.edge_feat = _shrink(edge_feat)
        self.node_off = np.ascontiguousarray(node_off, np.int64)
        self.edge_off = np.ascontiguousarray(edge_off, np.int64)
        self.recv = np.ascontiguousarray(recv, np.int32)
        self.send = np.ascontiguousarray(send, np.int32)
        self.y = None if y is None else np.ascontiguousarray(y)
        self.extras: Dict[str, Tuple[np.ndarray, str]] = extras or {}
        self.lens_n = np.diff(self.node_off)
        self.lens_e = np.diff(self.edge_off)
        # the packer trusts the endpoints: check them once, here
        if (len(self.node_off) != len(self.edge_off)
                or self.node_off[-1] != len(self.node_feat)
                or self.edge_off[-1] != len(self.edge_feat)
                or len(self.recv) != len(self.edge_feat)
                or len(self.send) != len(self.edge_feat)
                or (self.lens_n < 0).any() or (self.lens_e < 0).any()):
            raise ValueError("the offsets do not partition the arrays")
        n_of_edge = np.repeat(self.lens_n, self.lens_e)
        if len(self.recv) and (
                min(self.recv.min(), self.send.min()) < 0
                or (np.maximum(self.recv, self.send) >= n_of_edge).any()):
            raise ValueError("an edge endpoint is outside its graph")
        G = len(self)
        if self.y is not None and len(self.y) != G:
            raise ValueError(f"y has {len(self.y)} rows for {G} graphs")
        for k, (vals, kind) in self.extras.items():
            if kind not in (NODE_IDX, GRAPH) or len(vals) != G:
                raise ValueError(f"extra {k!r} is not flat-compatible")

    @classmethod
    def from_graphs(cls, graphs: Sequence[Graph]) -> "FlatGraphs":
        """Flatten host graphs. Fixed-shape NODE_IDX/GRAPH extras that
        every graph carries are kept; other extras raise :class:`NotFlat`
        (the caller then packs graph by graph). Endpoints outside their
        graph, labels of another count and no graphs at all raise
        ``ValueError``."""
        if not graphs:
            raise ValueError("no graphs to flatten")
        node_off = np.cumsum([0] + [g.num_nodes for g in graphs])
        edge_off = np.cumsum([0] + [g.num_edges for g in graphs])
        ei = np.concatenate([g.edge_index for g in graphs], axis=1)
        y = (np.stack([np.asarray(g.y) for g in graphs])
             if graphs[0].y is not None else None)
        extras: Dict[str, Tuple[np.ndarray, str]] = {}
        keys = set()
        for g in graphs:
            keys.update(g.extras.keys())
        for k in sorted(keys):
            vals, kinds = [], set()
            for g in graphs:
                if k not in g.extras:
                    raise NotFlat(f"extra {k!r} missing on some graphs")
                a, kind = g.extras[k]
                vals.append(np.asarray(a))
                kinds.add(kind)
            if len(kinds) != 1 or kinds.pop() not in (NODE_IDX, GRAPH):
                raise NotFlat(f"extra {k!r} not flat-compatible")
            if len({v.shape for v in vals}) != 1:
                raise NotFlat(f"extra {k!r} has varying shapes")
            extras[k] = (np.stack(vals, axis=0), g.extras[k][1])
        return cls(
            np.concatenate([g.node_feat for g in graphs]), node_off,
            ei[0], ei[1], np.concatenate([g.edge_feat for g in graphs]),
            edge_off, y, extras)

    def __len__(self) -> int:
        return len(self.node_off) - 1

    def _arrays(self):
        return (self.node_feat, self.node_off, self.recv, self.send,
                self.edge_feat, self.edge_off)

    def pack(
        self,
        graph_ids,
        max_nodes: int,
        max_edges: int,
        max_graphs: int,
        blocks: Optional[Tuple[int, int, int]] = None,
        extra_pad: Optional[Mapping[str, int]] = None,
        nstart=None,
    ) -> PackedGraphs:
        """Pack the graphs ``graph_ids``, in order, into fresh buffers
        through the C++ packer. With ``blocks = (n_blocks, block_nodes,
        block_edges)`` the batch has the block-diagonal layout (buffers of
        ``n_blocks`` blocks) and ``nstart``, each graph's first node row
        from one batch of :func:`native.plan_epoch`, places it. Raises
        ``ValueError("batch exceeds packed buffers")`` if the graphs do
        not fit."""
        ids = np.ascontiguousarray(graph_ids, np.int64)
        if blocks is not None:
            if nstart is None:
                raise ValueError("the blocked layout needs nstart from "
                                 "native.plan_epoch")
            bn = blocks[1]
            nstart = np.asarray(nstart, np.int64)
            arrays = native.pack_batch(
                *self._arrays(), ids, 0, 0, max_graphs, blocks=blocks,
                block_of=nstart // bn)
        else:
            arrays = native.pack_batch(*self._arrays(), ids, max_nodes,
                                       max_edges, max_graphs)
            nstart = np.cumsum(self.lens_n[ids]) - self.lens_n[ids]
        return self._batch(arrays, ids, max_graphs, blocks, extra_pad,
                           nstart)

    def _batch(self, arrays, ids, max_graphs, blocks, extra_pad,
               nstart) -> PackedGraphs:
        """The packed arrays, with ``y`` and the extras of ``ids`` (each
        graph's first node row at ``nstart``), as a ``PackedGraphs``."""
        G = len(ids)
        y = None
        if self.y is not None:
            y = np.zeros((max_graphs,) + self.y.shape[1:], self.y.dtype)
            y[:G] = self.y[ids]
        extras: Dict[str, np.ndarray] = {}
        for k, (vals, kind) in self.extras.items():
            sel = vals[ids]
            if kind == NODE_IDX:
                sel = sel.astype(np.int32) + np.asarray(
                    nstart, np.int32).reshape((G,) + (1,) * (sel.ndim - 1))
                cat = sel.reshape((-1,) + sel.shape[2:])
                pad_n = (extra_pad or {}).get(k, max_graphs)
            else:
                cat, pad_n = sel, max_graphs
            mask = np.zeros(pad_n, bool)
            mask[: cat.shape[0]] = True
            extras[k] = _pad_rows(cat, pad_n)
            extras[k + "_mask"] = mask
        nf, ef, snd, rcv, ng, nm, em, gm = arrays
        return PackedGraphs(
            node_feat=nf, edge_feat=ef, senders=snd, receivers=rcv,
            node_graph=ng, node_mask=nm, edge_mask=em, graph_mask=gm, y=y,
            extras=extras, block_nodes=blocks[1] if blocks else 0,
            block_edges=blocks[2] if blocks else 0)


def plan_epoch_plain(lens_n, lens_e, order, batch_size: int,
                     blocks: Tuple[int, int, int]):
    """The plain version of :func:`native.plan_epoch`: the greedy
    first-fit walk of the JAX package's ``FlatLoader`` and
    ``_first_fit``, one graph and one block at a time in Python."""
    n_blocks, bn, be = blocks
    batch = np.empty(len(order), np.int32)
    nstart = np.empty(len(order), np.int32)
    estart = np.empty(len(order), np.int32)
    b_idx = in_batch = 0
    fill_n, fill_e = [0] * n_blocks, [0] * n_blocks
    for i, g in enumerate(order):
        nn, ne = int(lens_n[g]), int(lens_e[g])
        placed = next((b for b in range(n_blocks)
                       if fill_n[b] + nn <= bn and fill_e[b] + ne <= be),
                      None)
        if placed is None:
            if in_batch == 0 or nn > bn or ne > be:
                raise ValueError("batch exceeds packed buffers")
            b_idx, in_batch = b_idx + 1, 0
            fill_n, fill_e = [0] * n_blocks, [0] * n_blocks
            placed = 0
        batch[i] = b_idx
        nstart[i] = placed * bn + fill_n[placed]
        estart[i] = placed * be + fill_e[placed]
        fill_n[placed] += nn
        fill_e[placed] += ne
        in_batch += 1
        if in_batch == batch_size:
            b_idx, in_batch = b_idx + 1, 0
            fill_n, fill_e = [0] * n_blocks, [0] * n_blocks
    return batch, nstart, estart, b_idx + (in_batch > 0)


def pack_plain(flat: FlatGraphs, graph_ids, max_nodes: int, max_edges: int,
               max_graphs: int,
               blocks: Optional[Tuple[int, int, int]] = None,
               extra_pad: Optional[Mapping[str, int]] = None
               ) -> PackedGraphs:
    """The plain version of :meth:`FlatGraphs.pack`: the JAX package's
    numpy loop, its placement from :func:`plan_epoch_plain`."""
    ids = np.asarray(graph_ids, np.int64)
    G = len(ids)
    if blocks is not None:
        n_blocks, bn, be = blocks
        max_nodes, max_edges = n_blocks * bn, n_blocks * be
        batch, n_cur, e_cur, n = plan_epoch_plain(
            flat.lens_n, flat.lens_e, ids, max(G, 1), blocks)
        if n > 1:
            raise ValueError("batch exceeds packed buffers")
    else:
        n_cur = np.cumsum(flat.lens_n[ids]) - flat.lens_n[ids]
        e_cur = np.cumsum(flat.lens_e[ids]) - flat.lens_e[ids]
    if G > max_graphs:
        raise ValueError("batch exceeds packed buffers")
    nf = np.zeros((max_nodes,) + flat.node_feat.shape[1:],
                  flat.node_feat.dtype)
    ef = np.zeros((max_edges,) + flat.edge_feat.shape[1:],
                  flat.edge_feat.dtype)
    snd = np.zeros(max_edges, np.int32)
    rcv = np.zeros(max_edges, np.int32)
    ng = np.zeros(max_nodes, np.int32)
    nm = np.zeros(max_nodes, bool)
    em = np.zeros(max_edges, bool)
    gm = np.zeros(max_graphs, bool)
    for g, gi in enumerate(ids):
        n0, n1 = flat.node_off[gi], flat.node_off[gi + 1]
        e0, e1 = flat.edge_off[gi], flat.edge_off[gi + 1]
        nc, ec = int(n_cur[g]), int(e_cur[g])
        if nc + n1 - n0 > max_nodes or ec + e1 - e0 > max_edges:
            raise ValueError("batch exceeds packed buffers")
        nf[nc: nc + n1 - n0] = flat.node_feat[n0:n1]
        ef[ec: ec + e1 - e0] = flat.edge_feat[e0:e1]
        rcv[ec: ec + e1 - e0] = flat.recv[e0:e1] + nc
        snd[ec: ec + e1 - e0] = flat.send[e0:e1] + nc
        ng[nc: nc + n1 - n0] = g
        nm[nc: nc + n1 - n0] = True
        em[ec: ec + e1 - e0] = True
        gm[g] = True
    return flat._batch((nf, ef, snd, rcv, ng, nm, em, gm), ids, max_graphs,
                       blocks, extra_pad, n_cur)


class FlatLoader:
    """Batches of a ``FlatGraphs``, with ``PackedLoader``'s semantics:
    the order shuffled from ``default_rng((seed, epoch))`` (the graphs'
    own order with ``shuffle=False``; that generator still feeds
    ``post_transform``), a
    batch closed early when the next graph does not fit (first-fit over the
    blocks), ``drop_last``, ``post_transform(batch, rng)`` with the epoch's
    generator, and ``last_epoch_stats``. Each epoch is planned with one
    ``native.plan_epoch`` call; each batch gets buffers of its own."""

    def __init__(self, flat: FlatGraphs, batch_size: int,
                 max_nodes: int = 0, max_edges: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False,
                 blocks: Optional[Tuple[int, int, int]] = None,
                 extra_pad: Optional[Mapping[str, int]] = None,
                 post_transform=None):
        self.flat = flat
        self.post_transform = post_transform
        self.batch_size = batch_size
        self.blocks = blocks
        if blocks is not None:
            n_blocks, bn, be = blocks
            max_nodes, max_edges = n_blocks * bn, n_blocks * be
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.extra_pad = extra_pad
        self._epoch = 0
        self.last_epoch_stats: Dict[str, float] = {}

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass the loader's pass ``epoch`` (from 0): its
        order and transform generator as in a run that made every pass
        before it."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.flat)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[PackedGraphs]:
        order = np.arange(len(self.flat))
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        # the standard layout is one block of the whole buffers
        layout = self.blocks or (1, self.max_nodes, self.max_edges)
        batch, nstart, _, n_batches = native.plan_epoch(
            self.flat.lens_n, self.flat.lens_e, order, self.batch_size,
            *layout)
        bounds = np.searchsorted(batch, np.arange(n_batches + 1))
        if (self.drop_last and n_batches
                and bounds[-1] - bounds[-2] < self.batch_size):
            n_batches -= 1  # the trailing partial batch
        n_graphs = n_edges = 0
        for b in range(n_batches):
            s, e = bounds[b], bounds[b + 1]
            ids = order[s:e]
            out = self.flat.pack(ids, self.max_nodes, self.max_edges,
                                 self.batch_size, blocks=self.blocks,
                                 extra_pad=self.extra_pad,
                                 nstart=nstart[s:e])
            if self.post_transform is not None:
                out = self.post_transform(out, rng)
            n_graphs += int(e - s)
            n_edges += int(self.flat.lens_e[ids].sum())
            yield out
        self.last_epoch_stats = {
            "batches": n_batches, "graphs": n_graphs, "edges": n_edges,
            "graphs_per_batch": n_graphs / max(n_batches, 1),
        }
