"""Context prediction's input pipeline (port of ``PresampledContextLoader``
and of the blocked walk of ``DeviceContextLoader`` in
``pretrain_gnns_tpu.data.context_loader``).

Each sample is two independent graphs, its substructure and its context
(``data/transforms.py``); a batch packs each stream into buffers of its
own, aligned by graph slot, as a ``PackedPair``. The transform's Python
BFS runs once per (graph, variant) when :class:`ContextPairs` is made;
epochs then cycle the variants and the C++ packer packs the batches.

Two layouts:

- standard (what the CPU runs): both streams in contiguous buffers of
  ``max_nodes`` / ``max_edges``, the batch closed when the larger of a
  pair's two streams no longer fits (``_iter_ids``);
- blocked (what the kernels take): each stream its own block geometry
  (:func:`stream_layout`), each graph placed first-fit in each stream, the
  batch closed when either stream runs out of room. One call of the C++
  ``native.plan_pair_epoch`` plans an epoch; :func:`blocked_pair_walk` is
  its plain version, the JAX package's Python walk, which the tests hold
  it against. The JAX package walks this layout only on its
  device-resident loader, over lengths rounded up to its 8-row chunks; the
  port packs the graphs unrounded, so it walks their own lengths.

Documented deviation of the JAX package kept here: the reference redraws
each graph's root every epoch; here a graph has ``variants`` (default 8)
presampled contexts, epoch ``e`` using variant ``e % variants`` (the draw
is the same per sample; the batches still change every epoch)."""

from __future__ import annotations

import math
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.core.graphs import Graph, PackedPair
from pretrain_gnns_tpu_torch.data.flat import FlatGraphs

Geometry = Tuple[int, int, int]  # (n_blocks, block_nodes, block_edges)


def _transform_key(transform) -> tuple:
    return (type(transform).__name__, sorted(vars(transform).items()))


class ContextPairs:
    """The presampled pairs of a dataset: for each of ``variants`` draws,
    the substructures and the contexts as ``FlatGraphs`` (the pairs whose
    context is empty left out, so that variants differ in length) and each
    pair's overlap indices, ragged. The variants come from one generator,
    ``default_rng((seed, 727272))``, one draw after another over the
    graphs, as the JAX package draws them. ``seconds`` is the time the
    presampling took. Several runs on one dataset can share one object:
    ``train.pretrain.build_loader`` takes it in place of the graphs."""

    def __init__(self, graphs: Sequence[Graph], transform, seed: int = 0,
                 variants: int = 8):
        t0 = time.perf_counter()
        self.graphs = list(graphs)
        self.key = (_transform_key(transform), seed, variants)
        self.variants = variants
        rng = np.random.default_rng((seed, 727272))
        self.sub: List[FlatGraphs] = []
        self.ctx: List[FlatGraphs] = []
        self.ov_flat: List[np.ndarray] = []
        self.ov_off: List[np.ndarray] = []
        for _ in range(variants):
            subs, ctxs, ovs = [], [], []
            for g in self.graphs:
                pair = transform(g, rng)
                if pair is None:
                    continue
                c = pair.context
                ovs.append(np.asarray(
                    c.extras["overlap_context_substruct_idx"][0], np.int64))
                subs.append(pair.substruct)
                ctxs.append(Graph(c.node_feat, c.edge_index, c.edge_feat))
            if not subs:
                raise ValueError("no valid context pairs in dataset")
            self.sub.append(FlatGraphs.from_graphs(subs))
            self.ctx.append(FlatGraphs.from_graphs(ctxs))
            self.ov_flat.append(np.concatenate(ovs))
            self.ov_off.append(np.concatenate(
                [[0], np.cumsum([len(o) for o in ovs])]).astype(np.int64))
        self.seconds = time.perf_counter() - t0


def stream_layout(lens_n: np.ndarray, lens_e: np.ndarray,
                  batch_size: int) -> Geometry:
    """One stream's block geometry (the JAX ``DeviceContextLoader``'s
    ``layout``): blocks of at least 128 node rows and 384 edge slots, grown
    to the largest graph (rows to a multiple of 8, slots of 128), and as
    many blocks as an average batch needs with 30% to spare, rounded up to
    a multiple of 8."""
    n = np.asarray(lens_n)
    e = np.asarray(lens_e)
    bn = max(128, int(-(-n.max(initial=1) // 8) * 8))
    be = max(384, int(-(-e.max(initial=1) // 128) * 128))
    nb = max(int(math.ceil(n.mean() * batch_size * 1.3 / bn)),
             int(math.ceil(e.mean() * batch_size * 1.3 / be)), 1)
    return (nb + 7) // 8 * 8, bn, be


def blocked_pair_walk(order, lens, geometry, batch_size: int,
                      drop_last: bool = True):
    """The joint first-fit walk of the blocked layout over the graphs in
    ``order``, in Python: the plain version of ``native.plan_pair_epoch``
    (the JAX ``DeviceContextLoader._iter_blocked``'s walk). ``lens =
    ((sub_n, sub_e), (ctx_n, ctx_e))``, arrays indexed by graph id, and
    ``geometry = (sub, ctx)``, each ``(n_blocks, block_nodes,
    block_edges)``. Each graph goes into the first block of each stream
    with room for it; a batch closes at ``batch_size`` graphs or when
    either stream has no room for the next graph. Yields ``(ids,
    ((sub_nstart, sub_estart), (ctx_nstart, ctx_estart)))`` per batch, the
    starts each graph's first node row and edge slot in its stream; with
    ``drop_last`` the last batch is dropped if it is short. Raises
    ``ValueError`` for a graph that fits no empty block."""
    lens = [tuple(np.asarray(a, np.int64) for a in s) for s in lens]

    def empty():
        return [(np.zeros(nb, np.int64), np.zeros(nb, np.int64))
                for nb, _, _ in geometry]

    def place(fill, gi):
        """The graph's starts in both streams, the fills advanced, or
        None (and no fill changed) if a stream has no room."""
        blocks = []
        for (fn, fe), (_, bn, be), (ln, le) in zip(fill, geometry, lens):
            ok = (fn + ln[gi] <= bn) & (fe + le[gi] <= be)
            b = int(ok.argmax())
            if not ok[b]:
                return None
            blocks.append(b)
        starts = []
        for b, (fn, fe), (_, bn, be), (ln, le) in zip(blocks, fill,
                                                       geometry, lens):
            starts.append((b * bn + fn[b], b * be + fe[b]))
            fn[b] += ln[gi]
            fe[b] += le[gi]
        return starts

    def flush(batch, starts):
        s = np.asarray(starts, np.int64).reshape(len(batch), 2, 2)
        return (np.asarray(batch, np.int64),
                ((s[:, 0, 0], s[:, 0, 1]), (s[:, 1, 0], s[:, 1, 1])))

    batch, starts, fill = [], [], empty()
    for gi in order:
        gi = int(gi)
        at = place(fill, gi)
        if at is None and batch:
            yield flush(batch, starts)
            batch, starts, fill = [], [], empty()
            at = place(fill, gi)
        if at is None:
            raise ValueError("pair exceeds blocked buffers")
        batch.append(gi)
        starts.append(at)
        if len(batch) == batch_size:
            yield flush(batch, starts)
            batch, starts, fill = [], [], empty()
    if batch and not drop_last:
        yield flush(batch, starts)


class PresampledContextLoader:
    """Shuffled ``PackedPair`` batches of presampled context pairs (see the
    module docstring), the order from ``default_rng((seed, epoch))``. ``graphs`` is the dataset or its
    :class:`ContextPairs` (made with this ``transform``, ``seed`` and
    ``variants``, else ``ValueError``). With ``blocked`` each stream gets
    its own block geometry (``blocks = (sub, ctx)``, each ``(n_blocks,
    block_nodes, block_edges)``) and ``max_nodes`` / ``max_edges`` are not
    used; else ``blocks`` is None. ``last_epoch_stats["edges"]`` counts the
    valid edges of both streams."""

    def __init__(self, graphs, batch_size: int, transform, max_nodes: int,
                 max_edges: int, seed: int = 0, drop_last: bool = True,
                 variants: int = 8, blocked: bool = False):
        if isinstance(graphs, ContextPairs):
            if graphs.key != (_transform_key(transform), seed, variants):
                raise ValueError(
                    "the presampled pairs were made with another "
                    "transform, seed or number of variants")
            pairs = graphs
        else:
            pairs = ContextPairs(graphs, transform, seed, variants)
        self.pairs = pairs
        self.batch_size = batch_size
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.seed, self.drop_last = seed, drop_last
        self.variants = variants
        self._epoch = 0
        self.last_epoch_stats: dict = {}
        self._sub, self._ctx = pairs.sub, pairs.ctx
        self._ov_flat, self._ov_off = pairs.ov_flat, pairs.ov_off
        # the standard layout's joint capacity: a pair fits if the larger
        # of its two streams does
        self._eff_n = [np.maximum(s.lens_n, c.lens_n)
                       for s, c in zip(self._sub, self._ctx)]
        self._eff_e = [np.maximum(s.lens_e, c.lens_e)
                       for s, c in zip(self._sub, self._ctx)]
        self.blocks = None
        if blocked:
            self.blocks = tuple(
                stream_layout(np.concatenate([f.lens_n for f in flats]),
                              np.concatenate([f.lens_e for f in flats]),
                              batch_size)
                for flats in (self._sub, self._ctx))

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass the loader's pass ``epoch`` (from 0): its
        order and variant as in a run that made every pass before it."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = min(len(f) for f in self._sub)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

    def _overlap_padded(self, v: int, ids: np.ndarray,
                        ctx_starts: np.ndarray, pad_len: int):
        """The graphs' ragged overlap indices, each offset by its graph's
        first context row, in one array padded to ``pad_len`` (int32),
        and its mask."""
        off = self._ov_off[v]
        lens = off[ids + 1] - off[ids]
        tot = int(lens.sum())
        within = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(off[ids], lens) + within
        vals = self._ov_flat[v][src] + np.repeat(ctx_starts, lens)
        pad = np.zeros(pad_len, np.int32)
        pad[:tot] = vals
        m = np.zeros(pad_len, bool)
        m[:tot] = True
        return pad, m

    def _pair(self, v, ids, sub, ctx, ctx_starts) -> PackedPair:
        pad, m = self._overlap_padded(v, ids, ctx_starts, ctx.max_nodes)
        extras = dict(ctx.extras or {})
        extras["overlap_context_substruct_idx"] = pad
        extras["overlap_context_substruct_idx_mask"] = m
        return PackedPair(sub, ctx.replace(extras=extras))

    def _batch(self, v: int, ids: np.ndarray) -> PackedPair:
        """The standard layout's batch of the pairs ``ids`` of variant
        ``v``."""
        sub = self._sub[v].pack(
            ids, self.max_nodes, self.max_edges, self.batch_size,
            extra_pad={"center_substruct_idx": self.batch_size})
        ctx = self._ctx[v].pack(ids, self.max_nodes, self.max_edges,
                                self.batch_size)
        cn = self._ctx[v].lens_n[ids]
        return self._pair(v, ids, sub, ctx, np.cumsum(cn) - cn)

    def _batch_blocked(self, v: int, ids: np.ndarray,
                       placement) -> PackedPair:
        """The blocked layout's batch of the pairs ``ids`` of variant
        ``v`` at ``placement`` (from :func:`blocked_pair_walk`): each
        stream packed into its blocks, ``center_substruct_idx`` offset by
        the substructures' node starts and the overlap rows by the
        contexts'."""
        (ns_sub, _), (ns_ctx, _) = placement
        sub = self._sub[v].pack(
            ids, 0, 0, self.batch_size, blocks=self.blocks[0],
            extra_pad={"center_substruct_idx": self.batch_size},
            nstart=ns_sub)
        ctx = self._ctx[v].pack(ids, 0, 0, self.batch_size,
                                blocks=self.blocks[1], nstart=ns_ctx)
        return self._pair(v, ids, sub, ctx, ns_ctx)

    def _epoch_order(self):
        v = self._epoch % self.variants
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        order = np.arange(len(self._sub[v]))
        rng.shuffle(order)
        return v, order

    def _stats(self, v, batches):
        """Wraps an epoch's ``(ids, ...)`` batches, counting them into
        ``last_epoch_stats`` as they pass."""
        se, ce = self._sub[v].lens_e, self._ctx[v].lens_e
        n_batches = n_graphs = n_edges = 0
        for item in batches:
            ids = item[0]
            n_batches += 1
            n_graphs += len(ids)
            n_edges += int(se[ids].sum() + ce[ids].sum())
            yield item
        self.last_epoch_stats = {
            "batches": n_batches, "graphs": n_graphs, "edges": n_edges,
            "graphs_per_batch": n_graphs / max(n_batches, 1),
        }

    def _iter_ids(self) -> Iterator[Tuple[int, np.ndarray]]:
        """The standard layout's greedy walk over one epoch: yields
        ``(variant, graph ids)`` per batch."""
        v, order = self._epoch_order()

        def walk():
            eff_n, eff_e = self._eff_n[v], self._eff_e[v]
            batch: List[int] = []
            fn = fe = 0
            for gi in order:
                nn, ne = int(eff_n[gi]), int(eff_e[gi])
                if batch and (fn + nn > self.max_nodes
                              or fe + ne > self.max_edges):
                    yield (np.asarray(batch, np.int64),)
                    batch, fn, fe = [], 0, 0
                batch.append(int(gi))
                fn += nn
                fe += ne
                if len(batch) == self.batch_size:
                    yield (np.asarray(batch, np.int64),)
                    batch, fn, fe = [], 0, 0
            if batch and not self.drop_last:
                yield (np.asarray(batch, np.int64),)

        for (ids,) in self._stats(v, walk()):
            yield v, ids

    def _iter_blocked(self):
        """The blocked layout's walk over one epoch, planned by one
        ``native.plan_pair_epoch`` call: yields ``(variant, graph ids,
        placement)`` per batch, ``placement`` as
        :func:`blocked_pair_walk` gives it."""
        v, order = self._epoch_order()
        batch, starts, n_batches = native.plan_pair_epoch(
            (self._sub[v].lens_n, self._sub[v].lens_e),
            (self._ctx[v].lens_n, self._ctx[v].lens_e), order,
            self.batch_size, *self.blocks)
        bounds = np.searchsorted(batch, np.arange(n_batches + 1))
        if (self.drop_last and n_batches
                and bounds[-1] - bounds[-2] < self.batch_size):
            n_batches -= 1  # the trailing partial batch

        def batches():
            for b in range(n_batches):
                st = starts[bounds[b]:bounds[b + 1]].astype(np.int64)
                yield (order[bounds[b]:bounds[b + 1]],
                       ((st[:, 0], st[:, 1]), (st[:, 2], st[:, 3])))

        for ids, placement in self._stats(v, batches()):
            yield v, ids, placement

    def __iter__(self) -> Iterator[PackedPair]:
        if self.blocks is not None:
            for v, ids, placement in self._iter_blocked():
                yield self._batch_blocked(v, ids, placement)
        else:
            for v, ids in self._iter_ids():
                yield self._batch(v, ids)
