"""Context prediction's input pipeline (port of ``PresampledContextLoader``,
``ContextPairLoader`` and ``DeviceContextLoader`` of
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
  port's :class:`PresampledContextLoader` packs the graphs unrounded, so it
  walks their own lengths, and its :class:`DeviceContextLoader` walks the
  rounded ones, as the JAX loader does.

Documented deviation of the JAX package kept by
:class:`PresampledContextLoader`: the reference redraws each graph's root
every epoch; there a graph has ``variants`` (default 8) presampled
contexts, epoch ``e`` using variant ``e % variants`` (the draw is the same
per sample; the batches still change every epoch).
:class:`ContextPairLoader` is the reference's own per-epoch resampling
(``transform_device="host"``): every graph's pair drawn anew each epoch,
in the epoch's order, from the epoch's generator; standard, it is the JAX
``ContextPairLoader``; blocked, it draws the epoch's pairs first and walks
and packs them as the presampled loader does, on one geometry a stream
fixed for the run."""

from __future__ import annotations

import math
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.core.graphs import Graph, PackedPair, pack_graphs
from pretrain_gnns_tpu_torch.data import device_pack
from pretrain_gnns_tpu_torch.data.flat import FlatGraphs
from pretrain_gnns_tpu_torch.data.transforms import SubstructContextPair

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
            pairs = [pair for pair in (transform(g, rng) for g in self.graphs)
                     if pair is not None]
            for dst, part in zip((self.sub, self.ctx, self.ov_flat,
                                  self.ov_off), flatten_pairs(pairs)):
                dst.append(part)
        self.seconds = time.perf_counter() - t0


def flatten_pairs(pairs: Sequence[SubstructContextPair]):
    """One draw of pairs, flat: the substructures and the contexts (their
    overlap extra taken out) as ``FlatGraphs``, and the overlap indices,
    ragged, as one array and its offsets. Raises ``ValueError`` when there
    is no pair."""
    if not pairs:
        raise ValueError("no valid context pairs in dataset")
    ovs = [np.asarray(p.context.extras["overlap_context_substruct_idx"][0],
                      np.int64) for p in pairs]
    ctxs = [Graph(p.context.node_feat, p.context.edge_index,
                  p.context.edge_feat) for p in pairs]
    return (FlatGraphs.from_graphs([p.substruct for p in pairs]),
            FlatGraphs.from_graphs(ctxs), np.concatenate(ovs),
            np.concatenate([[0], np.cumsum([len(o) for o in ovs])]
                           ).astype(np.int64))


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


class _PairBatches:
    """What the two pair loaders share: the epoch counter, the blocked
    walk and batch of flat pairs (draw ``v`` of ``_sub``, ``_ctx``,
    ``_ov_flat``, ``_ov_off``, on the geometries ``blocks``) and the
    epoch's statistics."""

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass the loader's pass ``epoch`` (from 0): its
        order and its pairs (the variant, or the draw) as in a run that
        made every pass before it."""
        self._epoch = int(epoch)

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

    def _walk_blocked(self, v: int, order: np.ndarray):
        """The blocked layout's batches of the pairs of draw ``v`` in
        ``order``, planned by one ``native.plan_pair_epoch`` call: yields
        ``(graph ids, placement)``, ``placement`` as
        :func:`blocked_pair_walk` gives it; with ``drop_last`` the
        trailing partial batch is left out."""
        batch, starts, n_batches = native.plan_pair_epoch(
            (self._sub[v].lens_n, self._sub[v].lens_e),
            (self._ctx[v].lens_n, self._ctx[v].lens_e), order,
            self.batch_size, *self.blocks)
        bounds = np.searchsorted(batch, np.arange(n_batches + 1))
        if (self.drop_last and n_batches
                and bounds[-1] - bounds[-2] < self.batch_size):
            n_batches -= 1  # the trailing partial batch
        for b in range(n_batches):
            st = starts[bounds[b]:bounds[b + 1]].astype(np.int64)
            yield (order[bounds[b]:bounds[b + 1]],
                   ((st[:, 0], st[:, 1]), (st[:, 2], st[:, 3])))

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


class PresampledContextLoader(_PairBatches):
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

    def __len__(self) -> int:
        n = min(len(f) for f in self._sub)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

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

    def _epoch_order(self):
        v = self._epoch % self.variants
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        order = np.arange(len(self._sub[v]))
        rng.shuffle(order)
        return v, order

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
        for ids, placement in self._stats(v, self._walk_blocked(v, order)):
            yield v, ids, placement

    def __iter__(self) -> Iterator[PackedPair]:
        if self.blocks is not None:
            for v, ids, placement in self._iter_blocked():
                yield self._batch_blocked(v, ids, placement)
        else:
            for v, ids in self._iter_ids():
                yield self._batch(v, ids)


class ContextPairLoader(_PairBatches):
    """The reference's context pipeline (the JAX ``ContextPairLoader``,
    ``transform_device="host"``): every epoch, the graphs shuffled by
    ``default_rng((seed, epoch))`` and each graph's pair drawn anew by
    ``transform`` from that generator, in that order, the graphs without
    a context skipped. Yields ``PackedPair`` batches.

    Standard layout (``blocks`` None): the JAX loader batch for batch, the
    pairs drawn as the batches are made, each stream packed into buffers
    of ``max_nodes`` / ``max_edges``, a batch closed at ``batch_size``
    pairs or when either stream of the next pair no longer fits.

    Blocked (``blocks``, the graphs' own ``(n_blocks, block_nodes,
    block_edges)``, which the kernels take): the epoch's pairs drawn first
    (nothing else draws from the generator, so the draws are the JAX
    loader's), then walked in draw order by ``native.plan_pair_epoch`` and
    packed as :class:`PresampledContextLoader` packs a variant. Both
    streams take the graphs' geometry for the whole run: a substructure or
    a context is an induced subgraph of its graph, so it fits a block of
    the graph's, and a batch of them fits the graph batch's blocks; the
    shapes stay static for the CUDA-graph replays.

    ``last_epoch_stats["edges"]`` counts the valid edges of both
    streams."""

    def __init__(self, graphs: Sequence[Graph], batch_size: int, transform,
                 max_nodes: int, max_edges: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 blocks: Optional[Geometry] = None):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.transform = transform
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.blocks = None if blocks is None else (tuple(blocks),
                                                   tuple(blocks))
        self._epoch = 0
        self.last_epoch_stats: dict = {}

    def _draws(self) -> Iterator[SubstructContextPair]:
        """This pass's pairs in draw order (the pass counter advanced)."""
        order = np.arange(len(self.graphs))
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        for idx in order:
            pair = self.transform(self.graphs[idx], rng)
            if pair is not None:
                yield pair

    def pack_standard(self, pairs: Sequence[SubstructContextPair]
                      ) -> PackedPair:
        """The standard layout's batch of ``pairs`` (the JAX loader's
        ``flush``)."""
        sub = pack_graphs([p.substruct for p in pairs], self.max_nodes,
                          self.max_edges, self.batch_size,
                          extra_pad={"center_substruct_idx":
                                     self.batch_size})
        ctx = pack_graphs([p.context for p in pairs], self.max_nodes,
                          self.max_edges, self.batch_size,
                          extra_pad={"overlap_context_substruct_idx":
                                     self.max_nodes})
        return PackedPair(sub, ctx)

    def _iter_standard(self) -> Iterator[PackedPair]:
        batch: List[SubstructContextPair] = []
        n_s = e_s = n_c = e_c = 0
        n_batches = n_graphs = n_edges = 0

        def flush():
            nonlocal n_batches, n_graphs, n_edges
            n_batches += 1
            n_graphs += len(batch)
            n_edges += e_s + e_c
            return self.pack_standard(batch)

        for pair in self._draws():
            s, c = pair.substruct, pair.context
            if batch and (n_s + s.num_nodes > self.max_nodes
                          or e_s + s.num_edges > self.max_edges
                          or n_c + c.num_nodes > self.max_nodes
                          or e_c + c.num_edges > self.max_edges):
                yield flush()
                batch, n_s, e_s, n_c, e_c = [], 0, 0, 0, 0
            batch.append(pair)
            n_s += s.num_nodes
            e_s += s.num_edges
            n_c += c.num_nodes
            e_c += c.num_edges
            if len(batch) == self.batch_size:
                yield flush()
                batch, n_s, e_s, n_c, e_c = [], 0, 0, 0, 0
        if batch and not self.drop_last:
            yield flush()
        self.last_epoch_stats = {
            "batches": n_batches, "graphs": n_graphs, "edges": n_edges,
            "graphs_per_batch": n_graphs / max(n_batches, 1),
        }

    def iter_blocked(self) -> Iterator[Tuple[np.ndarray, PackedPair]]:
        """The blocked layout's pass: yields ``(ids, batch)``, ``ids`` the
        batch's pairs as positions in the pass's draw order, which
        :attr:`pairs` holds until the next pass."""
        self.pairs = list(self._draws())
        self._sub, self._ctx, self._ov_flat, self._ov_off = (
            [part] for part in flatten_pairs(self.pairs))
        order = np.arange(len(self.pairs))
        for ids, placement in self._stats(0, self._walk_blocked(0, order)):
            yield ids, self._batch_blocked(0, ids, placement)

    def __iter__(self) -> Iterator[PackedPair]:
        if self.blocks is None:
            yield from self._iter_standard()
        else:
            for _, batch in self.iter_blocked():
                yield batch


class DeviceContextLoader(device_pack.EpochStackMixin,
                          PresampledContextLoader):
    """Context prediction on the device-resident dataset (the JAX
    ``DeviceContextLoader``): every variant's presampled substructures and
    contexts live on ``device`` as chunked resident arrays
    (``data.device_pack``), concatenated variant-major so that one set of
    shapes covers all variants (each variant's chunk base rides the
    descriptor's gather plan). Iteration yields descriptors of a few
    kilobytes; :meth:`prepare` builds the ``PackedPair`` on the device.

    Both layouts walk the 8-padded lengths, which chunk alignment takes:
    standard, the larger of a pair's two streams against buffers rounded
    up to 8; blocked (``blocked=True``), each stream its own geometry
    (:func:`stream_layout` of the padded lengths) and the joint first-fit
    ``native.plan_pair_epoch`` over them. The descriptor carries each
    stream's slot masks and gather plan (``s_*``, ``c_*``),
    ``center_slots`` and the overlap rows ``overlap_slots`` with their
    ``overlap_mask``. Device memory: ``variants`` copies of the
    substructures and contexts."""

    def __init__(self, *args, blocked: bool = False, device=None, **kw):
        super().__init__(*args, **kw)
        ceil8 = device_pack._ceil8
        self.max_nodes = int(ceil8(self.max_nodes))
        self.max_edges = int(ceil8(self.max_edges))
        self.device = torch.device(device or "cpu")
        self._aux_s, self._aux_c = [], []
        self._base = []  # per variant: (sub_n, sub_e, ctx_n, ctx_e) rows
        cat = {"s_node8": [], "s_edge8": [], "c_node8": [], "c_edge8": []}
        rows = dict.fromkeys(cat, 0)
        self._center_local = []
        for v in range(self.variants):
            base = []
            for p, flat, auxes in (("s_", self._sub[v], self._aux_s),
                                   ("c_", self._ctx[v], self._aux_c)):
                dev, aux = device_pack.build_device_flat(flat, as_numpy=True)
                auxes.append(aux)
                for name in ("node8", "edge8"):
                    base.append(rows[p + name])
                    cat[p + name].append(dev[name])
                    rows[p + name] += dev[name].shape[0]
            self._base.append(tuple(base))
            self._center_local.append(np.asarray(
                self._sub[v].extras["center_substruct_idx"][0]
            ).reshape(-1).astype(np.int64))
            # chunk-aligned capacity accounting for the standard walk
            self._eff_n[v] = np.maximum(self._aux_s[v]["lens_n8"],
                                        self._aux_c[v]["lens_n8"])
            self._eff_e[v] = np.maximum(self._aux_s[v]["lens_e8"],
                                        self._aux_c[v]["lens_e8"])
        self.dev = {k: torch.from_numpy(np.concatenate(v)).to(self.device)
                    for k, v in cat.items()}
        if blocked:
            self.blocks = tuple(
                stream_layout(np.concatenate([a["lens_n8"] for a in auxes]),
                              np.concatenate([a["lens_e8"] for a in auxes]),
                              self.batch_size)
                for auxes in (self._aux_s, self._aux_c))
            (nb_s, bn_s, be_s), (nb_c, bn_c, be_c) = self.blocks
            self._streams = ((nb_s * bn_s, nb_s * be_s, bn_s, be_s),
                             (nb_c * bn_c, nb_c * be_c, bn_c, be_c))
        else:
            self._streams = ((self.max_nodes, self.max_edges, 0, 0),) * 2

    # the device side --------------------------------------------------
    def prepare(self, desc) -> PackedPair:
        """The ``PackedPair`` of ``desc`` (tensors on the resident arrays'
        device), both streams built there by ``device_pack.materialize``."""
        def stream(p, aux, geometry):
            d = {k[2:]: v for k, v in desc.items() if k.startswith(p)}
            d["gid"], d["gmask"] = desc["gid"], desc["gmask"]
            mn, me, bn, be = geometry
            return device_pack.materialize(
                {"node8": self.dev[p + "node8"],
                 "edge8": self.dev[p + "edge8"]}, d, mn, me,
                fn=aux["fn"], fe=aux["fe"], with_y=False,
                block_nodes=bn, block_edges=be,
                node_dtype=aux["node_dtype"], edge_dtype=aux["edge_dtype"])

        sub = stream("s_", self._aux_s[0], self._streams[0])
        ctx = stream("c_", self._aux_c[0], self._streams[1])
        sub = sub.replace(extras={
            "center_substruct_idx": desc["center_slots"]})
        ctx = ctx.replace(extras={
            "overlap_context_substruct_idx": desc["overlap_slots"],
            "overlap_context_substruct_idx_mask": desc["overlap_mask"]})
        return PackedPair(sub, ctx)

    # host-side descriptors -------------------------------------------
    def _descriptor(self, v: int, ids: np.ndarray,
                    placement=None) -> device_pack.Descriptor:
        G = self.batch_size
        bases = self._base[v]

        def stream(flat, aux, base_n, base_e, geometry, starts):
            lens_n = flat.lens_n[ids]
            lens_e = flat.lens_e[ids]
            if starts is None:
                n8 = aux["lens_n8"][ids]
                e8 = aux["lens_e8"][ids]
                nstarts = np.concatenate([[0], np.cumsum(n8)[:-1]])
                estarts = np.concatenate([[0], np.cumsum(e8)[:-1]])
            else:
                nstarts, estarts = starts
            d = device_pack.stream_descriptor(
                aux, lens_n, lens_e, ids, nstarts, estarts,
                geometry[0], geometry[1], G,
                chunk_base_n=base_n, chunk_base_e=base_e)
            return d, nstarts

        ps, pc = placement if placement is not None else (None, None)
        ds, ns_sub = stream(self._sub[v], self._aux_s[v], bases[0],
                            bases[1], self._streams[0], ps)
        dc, ns_ctx = stream(self._ctx[v], self._aux_c[v], bases[2],
                            bases[3], self._streams[1], pc)
        desc = device_pack.Descriptor(gid=ds.pop("gid"),
                                      gmask=ds.pop("gmask"))
        dc.pop("gid"), dc.pop("gmask")
        desc.update({f"s_{k}": a for k, a in ds.items()})
        desc.update({f"c_{k}": a for k, a in dc.items()})

        # center slot per graph slot (padding graphs -> 0, masked by gmask)
        center = np.zeros(G, np.int32)
        center[: len(ids)] = ns_sub + self._center_local[v][ids]
        desc["center_slots"] = center

        # ragged overlap indices offset into the packed context slots
        pad, m = self._overlap_padded(v, ids, ns_ctx, self._streams[1][0])
        desc["overlap_slots"] = pad
        desc["overlap_mask"] = m
        return desc

    def _walk_blocked(self, v: int, order: np.ndarray):
        """As the presampled loader's walk, over the 8-padded lengths."""
        a_s, a_c = self._aux_s[v], self._aux_c[v]
        batch, starts, n_batches = native.plan_pair_epoch(
            (a_s["lens_n8"], a_s["lens_e8"]), (a_c["lens_n8"], a_c["lens_e8"]),
            order, self.batch_size, *self.blocks)
        bounds = np.searchsorted(batch, np.arange(n_batches + 1))
        if (self.drop_last and n_batches
                and bounds[-1] - bounds[-2] < self.batch_size):
            n_batches -= 1  # the trailing partial batch
        for b in range(n_batches):
            st = starts[bounds[b]:bounds[b + 1]].astype(np.int64)
            yield (order[bounds[b]:bounds[b + 1]],
                   ((st[:, 0], st[:, 1]), (st[:, 2], st[:, 3])))

    # data parallelism: the columns this loader makes descriptors for
    # (device_pack.owns_column; the others' batches yield stubs)
    shard_cols = None

    def __iter__(self) -> Iterator[device_pack.Descriptor]:
        if self.blocks is not None:
            walk = self._iter_blocked()
        else:
            walk = ((v, ids, None) for v, ids in self._iter_ids())
        for b, (v, ids, placement) in enumerate(walk):
            if not device_pack.owns_column(self.shard_cols, b):
                edges = (self._sub[v].lens_e[ids].sum()
                         + self._ctx[v].lens_e[ids].sum())
                yield {"_stub": (len(ids), int(edges))}
                continue
            yield self._descriptor(v, ids, placement)
