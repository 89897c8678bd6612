"""Epoch iteration: shuffle, batch, and pack host graphs into static shapes
(port of ``pretrain_gnns_tpu.data.packing``).

Batches are ``batch_size`` graphs in seeded shuffled order, packed into
fixed buffers sized once per dataset. A batch whose graphs overflow the
buffers flushes early and carries the rest into the next batch.
:func:`make_loader` picks the loader: ``data.flat.FlatLoader`` (the C++
packer) when the graphs flatten, ``PackedLoader`` (graph by graph, in
numpy) otherwise."""

from __future__ import annotations

import math
import warnings
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretrain_gnns_tpu_torch.core.graphs import (
    Graph, PackedGraphs, pack_graphs, pack_graphs_blocked,
)


def choose_blocks(graphs, batch_size: int, packing: str = "auto",
                  device: Optional[torch.device] = None):
    """Resolve ``packing`` to a block layout, or None for the standard
    padded layout. "auto" is blocked (128/384) on a CUDA device, which the
    kernels (fused GIN conv, blocked SpMM) need, and standard elsewhere."""
    if packing == "standard":
        return None
    if packing == "blocked":
        return block_layout(graphs, batch_size, block_nodes=128,
                            block_edges=384)
    if packing != "auto":
        raise ValueError(packing)
    on_cuda = device is not None and torch.device(device).type == "cuda"
    return (block_layout(graphs, batch_size, block_nodes=128,
                         block_edges=384) if on_cuda else None)


def block_layout(
    graphs: Sequence[Graph],
    batch_size: int,
    block_nodes: int = 256,
    block_edges: int = 768,
    slack: float = 1.3,
) -> Tuple[int, int, int]:
    """(n_blocks, block_nodes, block_edges) of the block-diagonal layout;
    capacities grow to fit the largest single graph."""
    n = np.array([g.num_nodes for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    block_nodes = max(block_nodes, int(n.max()))
    block_edges = max(block_edges, int(e.max()))
    block_nodes = (block_nodes + 7) // 8 * 8
    block_edges = (block_edges + 127) // 128 * 128
    n_blocks = max(
        int(math.ceil(n.mean() * batch_size * slack / block_nodes)),
        int(math.ceil(e.mean() * batch_size * slack / block_edges)),
        1,
    )
    n_blocks = (n_blocks + 7) // 8 * 8  # the JAX layout's multiple of 8
    return n_blocks, block_nodes, block_edges


def buffer_sizes(
    graphs: Sequence[Graph],
    batch_size: int,
    slack: float = 1.15,
    multiple: int = 128,
) -> Tuple[int, int]:
    """(max_nodes, max_edges): an average batch plus slack, never less
    than the largest graph, rounded up to ``multiple``."""
    n = np.array([g.num_nodes for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    max_nodes = max(int(n.mean() * batch_size * slack), int(n.max()) + 1)
    max_edges = max(
        int(e.mean() * batch_size * slack) + max_nodes // 8,
        int(e.max()) + 1,
    )
    r = lambda v: int(math.ceil(v / multiple) * multiple)
    return r(max_nodes), r(max_edges)


def make_loader(
    graphs: Sequence[Graph],
    batch_size: int,
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    seed: int = 0,
    extra_pad=None,
    blocks: Optional[Tuple[int, int, int]] = None,
    post_transform=None,
):
    """A ``FlatLoader`` when the graphs flatten (fixed-shape NODE_IDX and
    GRAPH extras only), else a ``PackedLoader``, with a warning that says
    why. Both iterate alike: seeded shuffle (or the graphs' order with
    ``shuffle=False``, as the fine-tuning eval loaders take them), early
    flush, ``drop_last``, ``post_transform`` with the epoch's generator,
    ``last_epoch_stats``.
    Any other fault of the graphs (an endpoint outside its graph, labels
    that do not stack) raises, as the packers trust their indices."""
    from pretrain_gnns_tpu_torch.data.flat import (
        FlatGraphs, FlatLoader, NotFlat,
    )

    graphs = list(graphs)
    if blocks is None and (max_nodes is None or max_edges is None):
        mn, me = buffer_sizes(graphs, batch_size)
        max_nodes, max_edges = max_nodes or mn, max_edges or me
    try:
        flat = FlatGraphs.from_graphs(graphs)
    except NotFlat as e:
        warnings.warn(f"the graphs do not flatten ({e}); packing them "
                      "graph by graph with PackedLoader", stacklevel=2)
    else:
        return FlatLoader(flat, batch_size, max_nodes or 0, max_edges or 0,
                          shuffle=shuffle, seed=seed, drop_last=drop_last,
                          blocks=blocks,
                          extra_pad=extra_pad, post_transform=post_transform)
    return PackedLoader(graphs, batch_size, max_nodes, max_edges,
                        shuffle=shuffle, drop_last=drop_last, seed=seed,
                        extra_pad=extra_pad, blocks=blocks,
                        post_transform=post_transform)


class PackedLoader:
    """Iterable over packed batches (numpy leaves).

    Args:
      graphs: host dataset.
      batch_size: graph slots per batch.
      max_nodes/max_edges: buffer sizes (default: :func:`buffer_sizes`).
      shuffle: reshuffle each epoch from ``(seed, epoch)``.
      drop_last: drop the final partial batch.
      transform: ``(graph, rng) -> graph`` applied to each graph in the
        epoch's order with the epoch's generator, before the fit check
        (``data.transforms.MaskAtom`` etc.: the reference's per-graph
        placement, ``transform_device="host"``).
      extra_pad: padded lengths of the graphs' per-graph extras (and of
        the transform's).
      blocks: ``(n_blocks, block_nodes, block_edges)`` for the blocked
        layout, or None.
      post_transform: ``(batch, rng) -> batch`` applied to each packed
        batch with the epoch's generator.
    """

    def __init__(
        self,
        graphs: Sequence[Graph],
        batch_size: int,
        max_nodes: Optional[int] = None,
        max_edges: Optional[int] = None,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        transform: Optional[Callable[[Graph, np.random.Generator],
                                     Graph]] = None,
        extra_pad=None,
        blocks: Optional[Tuple[int, int, int]] = None,
        post_transform=None,
    ):
        self.graphs = list(graphs)
        self.post_transform = post_transform
        self.batch_size = batch_size
        self.blocks = blocks
        if blocks is not None:
            n_blocks, bn, be = blocks
            max_nodes, max_edges = n_blocks * bn, n_blocks * be
        elif max_nodes is None or max_edges is None:
            mn, me = buffer_sizes(self.graphs, batch_size)
            max_nodes = max_nodes or mn
            max_edges = max_edges or me
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.transform = transform
        self.extra_pad = extra_pad
        self._epoch = 0
        # packing statistics of the last completed epoch
        self.last_epoch_stats: dict = {}

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass the loader's pass ``epoch`` (from 0): its
        order and transform generator as in a run that made every pass
        before it."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.graphs)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[PackedGraphs]:
        order = np.arange(len(self.graphs))
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1

        def _pack(batch: List[Graph]) -> PackedGraphs:
            if self.blocks is not None:
                n_blocks, bn, be = self.blocks
                out = pack_graphs_blocked(
                    batch, n_blocks, bn, be, self.batch_size,
                    extra_pad=self.extra_pad,
                )
            else:
                out = pack_graphs(batch, self.max_nodes, self.max_edges,
                                  self.batch_size, extra_pad=self.extra_pad)
            if self.post_transform is not None:
                out = self.post_transform(out, rng)
            return out

        def fits(g: Graph, fills) -> bool:
            if self.blocks is None:
                return (n_nodes + g.num_nodes <= self.max_nodes
                        and n_edges + g.num_edges <= self.max_edges)
            # blocked: simulate the packer's first-fit
            n_blocks, bn, be = self.blocks
            for b in range(n_blocks):
                if (fills[b][0] + g.num_nodes <= bn
                        and fills[b][1] + g.num_edges <= be):
                    fills[b] = (fills[b][0] + g.num_nodes,
                                fills[b][1] + g.num_edges)
                    return True
            return False

        def new_fills():
            return ([(0, 0) for _ in range(self.blocks[0])]
                    if self.blocks is not None else None)

        batch: List[Graph] = []
        n_nodes = n_edges = 0
        n_batches = n_graphs = tot_edges = 0
        fills = new_fills()
        for idx in order:
            g = self.graphs[idx]
            if self.transform is not None:
                g = self.transform(g, rng)
            if batch and not fits(g, fills):
                yield _pack(batch)  # buffer overflow: flush early
                n_batches += 1
                n_graphs += len(batch)
                tot_edges += n_edges
                batch, n_nodes, n_edges = [], 0, 0
                fills = new_fills()
                fits(g, fills)
            elif not batch:
                fits(g, fills)  # seed the fill simulation
            batch.append(g)
            n_nodes += g.num_nodes
            n_edges += g.num_edges
            if len(batch) == self.batch_size:
                yield _pack(batch)
                n_batches += 1
                n_graphs += len(batch)
                tot_edges += n_edges
                batch, n_nodes, n_edges = [], 0, 0
                fills = new_fills()
        if batch and not self.drop_last:
            yield _pack(batch)
            n_batches += 1
            n_graphs += len(batch)
            tot_edges += n_edges
        self.last_epoch_stats = {
            "batches": n_batches, "graphs": n_graphs, "edges": tot_edges,
            "graphs_per_batch": n_graphs / max(n_batches, 1),
        }
