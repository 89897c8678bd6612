"""The device-resident dataset: batches built on the card from small
descriptors (port of ``pretrain_gnns_tpu.data.device_pack``).

The whole flat dataset lives on the device once, in 8-row chunks: every
graph's node rows and edge rows are padded to a multiple of ``CHUNK`` and
the rows of a chunk (node features; edge features with the graph-local
endpoints) are flattened into one wide row (:func:`build_device_flat`).
Each step then ships only a descriptor of a few kilobytes (slot masks,
segment ids, the plan of which chunks to gather, and the host's masking
or negative-sampling draws), and :func:`materialize` builds the padded
batch on the device with wide-row gathers. Batch placement is aligned to
chunks, so a chunk never straddles two graphs.

The host's work an epoch is the C++ planner (first-fit over the shuffled
order, on the 8-padded lengths) and numpy assembly of the descriptors,
on the prefetch thread. Descriptors are numpy and equal the JAX package's
element for element; :class:`Descriptor` is a dict of them that moves to
the device as a batch does.

:func:`materialize` uses nothing that waits for the host or has a shape
that depends on the data, so that it runs inside a captured CUDA graph.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs, _to
from pretrain_gnns_tpu_torch.data.batch_transforms import (
    negative_candidates_np, sample_per_group_np, select_negatives_np,
)
from pretrain_gnns_tpu_torch.data.flat import FlatGraphs

CHUNK = 8


def _ceil8(a):
    return (a + CHUNK - 1) // CHUNK * CHUNK


def _scatter_runs(starts, lens):
    """positions of concatenated runs: for run i, lens[i] slots beginning
    at starts[i] (the np.repeat trick; no python loop)."""
    lens = np.asarray(lens, np.int64)
    tot = int(lens.sum())
    if not tot:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    within = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(np.asarray(starts, np.int64), lens) + within, within


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """The torch dtype of a numpy dtype (None stays None)."""
    if dtype is None:
        return None
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class Descriptor(dict):
    """One step's descriptor: named numpy arrays (or, after :meth:`to`,
    tensors). It moves, pins and names its leaves as a batch does, so that
    the run loop, ``train.graphed.ScanStep`` and the throughput meter take
    it in place of one."""

    layout = ()

    def leaves(self) -> Dict[str, Any]:
        return dict(self)

    def _map(self, fn) -> "Descriptor":
        return Descriptor({k: fn(v if isinstance(v, torch.Tensor)
                                 else torch.from_numpy(np.ascontiguousarray(v)))
                           for k, v in self.items()})

    def to(self, device, non_blocking: bool = False) -> "Descriptor":
        return self._map(_to(device, non_blocking))

    def pin_memory(self) -> "Descriptor":
        return self._map(lambda t: t.pin_memory())

    def counts(self) -> Dict[str, int]:
        """Valid edges and nodes (a context pair's both streams) and graph
        slots, as ``ThroughputMeter.counts_of`` counts a batch."""
        def total(*names):
            return sum(int(np.asarray(self[n]).sum()) for n in names
                       if n in self)
        return {"edges": total("edge_mask", "s_edge_mask", "c_edge_mask"),
                "nodes": total("node_mask", "s_node_mask", "c_node_mask"),
                "graphs": total("gmask")}


def build_device_flat(flat: FlatGraphs, device=None, as_numpy: bool = False):
    """Chunked resident arrays and the host's chunk offset tables.
    ``as_numpy`` leaves the arrays on the host (multi-variant loaders
    concatenate several first).

    Returns (dev, aux): dev holds tensors on ``device`` (numpy with
    ``as_numpy``)
      node8  [n_node_chunks, CHUNK*Fn] int32
      edge8  [n_edge_chunks, CHUNK*(Fe+2)] int32 (cols per row:
             edge_feat.. , send_local, recv_local)
      y      [G, T] (optional)
    aux holds numpy: node_chunk_off/edge_chunk_off [G] (first chunk row of
    each graph), the 8-padded lengths, the widths and the float feature
    dtypes (None for integer features)."""
    lens_n = np.diff(flat.node_off)
    lens_e = np.diff(flat.edge_off)

    def _as_int(a, what):
        """The chunk layout stores int32 rows. Integer features pass
        through; float features (bio: 0/1 indicator vectors) are stored
        as int32 and cast back at materialize time. Anything fractional
        cannot ride the resident layout."""
        if np.issubdtype(a.dtype, np.integer):
            return a, None
        ai = a.astype(np.int32)
        if not np.array_equal(ai, a):
            raise ValueError(f"device dataset requires integral {what}")
        return ai, a.dtype
    node_feat, node_dtype = _as_int(flat.node_feat, "node features")
    edge_feat, edge_dtype = _as_int(flat.edge_feat, "edge features")
    fn = int(np.prod(node_feat.shape[1:], initial=1))
    fe = int(np.prod(edge_feat.shape[1:], initial=1))

    cn = _ceil8(lens_n) // CHUNK  # chunks per graph
    ce = _ceil8(lens_e) // CHUNK
    node_chunk_off = np.concatenate([[0], np.cumsum(cn)[:-1]])
    edge_chunk_off = np.concatenate([[0], np.cumsum(ce)[:-1]])

    node8 = np.zeros((int(cn.sum()) * CHUNK, fn), np.int32)
    pos, _ = _scatter_runs(node_chunk_off * CHUNK, lens_n)
    node8[pos] = node_feat.reshape(-1, fn)
    node8 = node8.reshape(-1, CHUNK * fn)

    edge8 = np.zeros((int(ce.sum()) * CHUNK, fe + 2), np.int32)
    epos, _ = _scatter_runs(edge_chunk_off * CHUNK, lens_e)
    edge8[epos, :fe] = edge_feat.reshape(-1, fe)
    edge8[epos, fe] = flat.send
    edge8[epos, fe + 1] = flat.recv
    edge8 = edge8.reshape(-1, CHUNK * (fe + 2))

    dev = {"node8": node8, "edge8": edge8}
    if flat.y is not None:
        dev["y"] = flat.y
    if not as_numpy:
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            device or "cpu", copy=True) for k, v in dev.items()}
    aux = {
        "node_chunk_off": node_chunk_off.astype(np.int64),
        "edge_chunk_off": edge_chunk_off.astype(np.int64),
        "lens_n8": _ceil8(lens_n).astype(np.int64),
        "lens_e8": _ceil8(lens_e).astype(np.int64),
        "fn": fn, "fe": fe,
        "node_dtype": node_dtype, "edge_dtype": edge_dtype,
    }
    return dev, aux


def token_row(width: int, first: int, like: torch.Tensor) -> torch.Tensor:
    """``[first, 0, ..., 0]`` of ``width`` in ``like``'s dtype and device,
    made there (a tensor copied from the host would not capture)."""
    return (torch.arange(width, device=like.device) == 0).to(
        like.dtype) * first


def materialize(
    dev: Dict[str, torch.Tensor],
    desc: Dict[str, torch.Tensor],
    max_nodes: int,
    max_edges: int,
    fn: int,
    fe: int,
    block_nodes: int = 0,
    block_edges: int = 0,
    with_y: bool = True,
    mask_atom_token: int = 119,
    mask_bond_token: int = 5,
    node_dtype=None,
    edge_dtype=None,
) -> PackedGraphs:
    """Descriptor (tensors on ``dev``'s device) -> ``PackedGraphs``: wide-row
    gathers and selects of static shapes, nothing that waits for the host.
    ``node_dtype``/``edge_dtype`` (numpy dtypes) restore float features
    stored as int32 in the resident chunks (bio indicator features)."""
    gid = desc["gid"]
    gmask = desc["gmask"]
    nvalid = desc["node_mask"]
    evalid = desc["edge_mask"]

    node_feat = dev["node8"].index_select(
        0, desc["node_chunk_rows"]).reshape(max_nodes, fn)
    node_feat = torch.where(nvalid[:, None], node_feat, 0)
    node_dtype, edge_dtype = torch_dtype(node_dtype), torch_dtype(edge_dtype)
    if node_dtype is not None:
        node_feat = node_feat.to(node_dtype)

    epack = dev["edge8"].index_select(
        0, desc["edge_chunk_rows"]).reshape(max_edges, fe + 2)
    edge_feat = torch.where(evalid[:, None], epack[:, :fe], 0)
    if edge_dtype is not None:
        edge_feat = edge_feat.to(edge_dtype)
    # each chunk's graph's first node row, for its 8 slots (a static
    # expand: the repeat's length never depends on the data)
    nbase = desc["edge_chunk_nbase"][:, None].expand(
        -1, CHUNK).reshape(max_edges)
    senders = torch.where(evalid, nbase + epack[:, fe], 0).to(torch.int32)
    receivers = torch.where(evalid, nbase + epack[:, fe + 1],
                            0).to(torch.int32)

    y = None
    if with_y and "y" in dev:
        y = dev["y"].index_select(0, gid) * gmask[:, None].to(dev["y"].dtype)

    extras = {}
    if "center_node_idx" in desc:
        # bio center-node slot (padding graphs -> row 0; masked by the
        # loss via graph_mask)
        extras["center_node_idx"] = desc["center_node_idx"]
    for key in ("negative_edges", "negative_edges_blocked"):
        if key in desc:
            extras[key] = desc[key]
            extras[f"{key}_mask"] = desc[f"{key}_mask"]
    if "masked_edge_idx" in desc:
        # bio edge masking (bio/util.py:46-104): labels from the CLEAN
        # materialized features, then BOTH directions overwritten with
        # the mask indicator [0,...,0,1]
        eidx = desc["masked_edge_idx"]
        em = desc["masked_edge_idx_mask"]
        extras["masked_edge_idx"] = eidx
        extras["masked_edge_idx_mask"] = em
        extras["mask_edge_label"] = torch.where(
            em[:, None], edge_feat.index_select(0, eidx), 0)
        extras["mask_edge_label_mask"] = em
        mask_feat = token_row(fe, 1, edge_feat).flip(0)
        mb = desc["masked_edge_bool"] & evalid
        edge_feat = torch.where(mb[:, None], mask_feat, edge_feat)
    if "masked_bool" in desc:
        # chem attribute masking: labels gathered from the CLEAN
        # materialized features, then tokens written via where
        masked = desc["masked_bool"] & nvalid
        slots = desc["masked_slots"]
        smask = desc["masked_slots_mask"]
        extras["masked_atom_indices"] = slots
        extras["masked_atom_indices_mask"] = smask
        extras["mask_node_label"] = torch.where(
            smask[:, None], node_feat.index_select(0, slots), 0)
        extras["mask_node_label_mask"] = smask
        token = token_row(fn, mask_atom_token, node_feat)
        node_feat = torch.where(masked[:, None], token, node_feat)
        if "connected_edge_indices" in desc:
            conn = desc["connected_edge_indices"]
            cmask = desc["connected_edge_indices_mask"]
            extras["connected_edge_indices"] = conn
            extras["connected_edge_indices_mask"] = cmask
            extras["mask_edge_label"] = torch.where(
                cmask[:, None], edge_feat.index_select(0, conn), 0)
            extras["mask_edge_label_mask"] = cmask
            edge_masked = (masked.index_select(0, senders)
                           | masked.index_select(0, receivers)) & evalid
            etoken = token_row(fe, mask_bond_token, edge_feat)
            edge_feat = torch.where(edge_masked[:, None], etoken, edge_feat)

    return PackedGraphs(
        node_feat=node_feat, edge_feat=edge_feat, senders=senders,
        receivers=receivers, node_graph=desc["node_graph"],
        node_mask=nvalid, edge_mask=evalid, graph_mask=gmask, y=y,
        extras=extras, block_nodes=block_nodes, block_edges=block_edges)


def stream_descriptor(
    aux: Dict[str, np.ndarray],
    lens_n: np.ndarray,
    lens_e: np.ndarray,
    ids: np.ndarray,
    nstarts: np.ndarray,
    estarts: np.ndarray,
    max_nodes: int,
    max_edges: int,
    G: int,
    chunk_base_n: int = 0,
    chunk_base_e: int = 0,
) -> Dict[str, np.ndarray]:
    """Core :func:`materialize` descriptor for ONE resident stream:
    slot-space masks/segment-ids plus the chunk gather plan. Module-level
    so multi-stream loaders (context pairs) reuse it; ``chunk_base_*``
    offsets the gather rows into a concatenated multi-variant resident
    array."""
    k = len(ids)
    gid = np.zeros(G, np.int32)
    gid[:k] = ids
    gmask = np.zeros(G, bool)
    gmask[:k] = True

    # slot-space ids/masks (REAL lengths at chunk-aligned starts)
    node_graph = np.zeros(max_nodes, np.int32)
    node_mask = np.zeros(max_nodes, bool)
    pos, _ = _scatter_runs(nstarts, lens_n)
    node_graph[pos] = np.repeat(np.arange(k, dtype=np.int32), lens_n)
    node_mask[pos] = True
    edge_mask = np.zeros(max_edges, bool)
    epos, _ = _scatter_runs(estarts, lens_e)
    edge_mask[epos] = True

    # chunk gather plans (padding chunks gather row 0, masked out)
    cn = aux["lens_n8"][ids] // CHUNK
    ce = aux["lens_e8"][ids] // CHUNK
    node_chunk_rows = np.zeros(max_nodes // CHUNK, np.int32)
    cpos, cwithin = _scatter_runs(
        np.asarray(nstarts, np.int64) // CHUNK, cn
    )
    node_chunk_rows[cpos] = (
        np.repeat(aux["node_chunk_off"][ids] + chunk_base_n, cn) + cwithin
    )
    edge_chunk_rows = np.zeros(max_edges // CHUNK, np.int32)
    edge_chunk_nbase = np.zeros(max_edges // CHUNK, np.int32)
    cepos, cewithin = _scatter_runs(
        np.asarray(estarts, np.int64) // CHUNK, ce
    )
    edge_chunk_rows[cepos] = (
        np.repeat(aux["edge_chunk_off"][ids] + chunk_base_e, ce) + cewithin
    )
    edge_chunk_nbase[cepos] = np.repeat(
        np.asarray(nstarts, np.int64), ce
    )
    return {
        "gid": gid, "gmask": gmask,
        "node_graph": node_graph, "node_mask": node_mask,
        "edge_mask": edge_mask,
        "node_chunk_rows": node_chunk_rows,
        "edge_chunk_rows": edge_chunk_rows,
        "edge_chunk_nbase": edge_chunk_nbase,
    }


class EpochStackMixin:
    """Whole-epoch descriptor stacking for the device-resident loaders
    (the epoch trainer's input, ``train.pretrain.run_epoch_mode``).
    Requires iteration yielding descriptor dicts, ``last_epoch_stats``,
    and ``_desc_counts``."""

    def _desc_counts(self, d) -> Tuple[int, int]:
        if "_stub" in d:  # non-local column in a multi-process run
            return d["_stub"]
        counts = Descriptor.counts(d)
        return counts["graphs"], counts["edges"]

    def epoch_stack(
        self, steps_cap: int = 0, n_dev: int = 1
    ) -> Optional[Dict[str, object]]:
        """One epoch's descriptors stacked into ``[steps, ...]`` (or
        ``[steps, n_dev, ...]`` for data parallelism) numpy arrays, ready
        for a single host-to-device copy.

        ``steps_cap`` fixes the stack's length across epochs (the
        first-fit planner's batch count can drift by 1-2 with the
        shuffle): short epochs are padded with a replay of the first
        descriptor and masked via ``valid``; long epochs return the
        surplus in ``overflow`` (same per-step shapes, for single steps).
        Returns None when the epoch yields no descriptor.
        """
        descs = list(self)
        stats = dict(self.last_epoch_stats)
        if n_dev > 1:
            usable = len(descs) // n_dev * n_dev
            if usable < len(descs):
                for d in descs[usable:]:
                    g, e = self._desc_counts(d)
                    stats["graphs"] -= g
                    stats["edges"] -= e
                    stats["batches"] -= 1
                descs = descs[:usable]
        if not descs:
            return None
        steps = len(descs) // max(n_dev, 1)
        if steps_cap <= 0:
            steps_cap = steps

        def group(ds: List[Dict[str, np.ndarray]]):
            """len(ds) == n_dev -> one stack element."""
            ds = [d for d in ds if "_stub" not in d]
            if not ds:
                raise ValueError("process owns no columns in this group")
            if n_dev <= 1 and len(ds) == 1:
                return ds[0]
            return {
                k: np.stack([d[k] for d in ds]) for k in ds[0]
            }

        elems = [
            group(descs[i * max(n_dev, 1):(i + 1) * max(n_dev, 1)])
            for i in range(steps)
        ]
        overflow = elems[steps_cap:]
        elems = elems[:steps_cap]
        n_real = len(elems)
        valid = np.zeros(steps_cap, bool)
        valid[:n_real] = True
        if n_real < steps_cap:
            elems = elems + [elems[0]] * (steps_cap - n_real)
        stacked = {
            k: np.stack([e[k] for e in elems]) for k in elems[0]
        }
        stats["graphs_per_batch"] = stats["graphs"] / max(
            stats["batches"], 1
        )
        self.last_epoch_stats = stats
        return {
            "stacked": stacked, "valid": valid, "n_steps": n_real,
            "overflow": overflow, "stats": stats,
        }


class DeviceBatchLoader(EpochStackMixin):
    """Iterator yielding per-batch descriptors (:class:`Descriptor`, numpy
    leaves) for :meth:`prepare`. Same iteration semantics as
    ``data.flat.FlatLoader`` (seeded epoch shuffle, greedy first-fit,
    drop_last, last_epoch_stats), except that graph placements are
    CHUNK-aligned (capacity accounting uses the 8-padded sizes), so fewer
    graphs may fit a batch. The resident arrays live on ``device``.

    ``mask_spec`` = dict(rate, mask_edge, node_budget, edge_budget,
    atom_token, bond_token) adds chem masking's descriptor fields (the
    draws on the host, the labels gathered on the device);
    ``bio_mask_spec`` = dict(rate, budget) bio's edge masking; ``neg_spec``
    = dict(budget) edge prediction's negative pairs, drawn by the C++
    sampler (block-aligned with ``blocks``, else compact), or with
    ``neg_spec["sampler"] == "numpy"`` by the JAX package's numpy
    rejection sampler; ``center_spec`` ships the bio center-node slot per
    graph (the GraphPred head's concat input). Each batch's draws come from
    ``default_rng((seed, epoch, batch))``.
    """

    def __init__(
        self,
        flat: FlatGraphs,
        batch_size: int,
        max_nodes: int = 0,
        max_edges: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        blocks: Optional[Tuple[int, int, int]] = None,
        mask_spec: Optional[dict] = None,
        neg_spec: Optional[dict] = None,
        bio_mask_spec: Optional[dict] = None,
        center_spec: bool = False,
        device=None,
    ):
        self.flat = flat
        self.device = torch.device(device or "cpu")
        self.dev, self._aux = build_device_flat(flat, self.device)
        self.bio_mask_spec = bio_mask_spec
        self._center_local = None
        if center_spec:
            self._center_local = np.asarray(
                flat.extras["center_node_idx"][0]
            ).reshape(len(flat)).astype(np.int64)
        self.batch_size = batch_size
        self.blocks = blocks
        if blocks is not None:
            n_blocks, bn, be = blocks
            if bn % CHUNK or be % CHUNK:
                raise ValueError("block sizes must be chunk multiples")
            max_nodes, max_edges = n_blocks * bn, n_blocks * be
        else:
            max_nodes = _ceil8(max_nodes)
            max_edges = _ceil8(max_edges)
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.mask_spec = mask_spec
        self.neg_spec = neg_spec
        if neg_spec is not None:
            # the C++ sampler's view of the dataset, checked once
            self._edges = native.DatasetEdges(flat.send, flat.recv,
                                              flat.edge_off, flat.lens_n)
        self._epoch = 0
        self.last_epoch_stats: Dict[str, float] = {}
        self._lens_n = np.diff(flat.node_off).astype(np.int64)
        self._lens_e = np.diff(flat.edge_off).astype(np.int64)

    def __len__(self) -> int:
        n = len(self.flat)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size
        )

    def set_epoch(self, epoch: int) -> None:
        """Make the next pass the loader's pass ``epoch`` (from 0): its
        order and draws as in a run that made every pass before it."""
        self._epoch = int(epoch)

    # the device side --------------------------------------------------
    def prepare(self, desc) -> PackedGraphs:
        """The batch of ``desc`` (tensors on the resident arrays' device),
        built there by :func:`materialize`."""
        bn, be = (self.blocks[1], self.blocks[2]) if self.blocks else (0, 0)
        ms = self.mask_spec or {}
        return materialize(
            self.dev, desc, self.max_nodes, self.max_edges,
            fn=self._aux["fn"], fe=self._aux["fe"],
            block_nodes=bn, block_edges=be,
            mask_atom_token=ms.get("atom_token", 119),
            mask_bond_token=ms.get("bond_token", 5),
            node_dtype=self._aux["node_dtype"],
            edge_dtype=self._aux["edge_dtype"],
        )

    # host-side placement ---------------------------------------------
    def _descriptor(self, ids: np.ndarray, nstarts: np.ndarray,
                    estarts: np.ndarray,
                    rng: np.random.Generator) -> Descriptor:
        G = self.batch_size
        k = len(ids)
        lens_n = self._lens_n[ids]
        lens_e = self._lens_e[ids]
        desc = Descriptor(stream_descriptor(
            self._aux, lens_n, lens_e, ids, nstarts, estarts,
            self.max_nodes, self.max_edges, G,
        ))
        nstart = np.full(G, self.max_nodes, np.int64)
        estart = np.full(G, self.max_edges, np.int64)
        nstart[:k] = nstarts
        estart[:k] = estarts
        if self.mask_spec is not None:
            self._add_masking(desc, desc["gid"], desc["gmask"], lens_e,
                              nstart, estart, rng)
        if self.neg_spec is not None:
            self._add_negatives(desc, ids, nstart[:k], estart[:k], rng)
        if self.bio_mask_spec is not None:
            self._add_bio_masking(desc, ids, estart[:k], rng)
        if self._center_local is not None:
            center = np.zeros(G, np.int32)
            center[:k] = nstart[:k] + self._center_local[ids]
            desc["center_node_idx"] = center
        return desc

    def _add_bio_masking(self, desc, ids, estarts, rng):
        """bio MaskEdge (bio/util.py:46-104) in flat-local bond space:
        per graph sample int(E_undirected * rate) + 1 distinct bonds;
        ship the even-slot representatives + a both-directions bool; the
        labels/feature overwrite happen on device from the CLEAN
        materialized features."""
        ms = self.bio_mask_spec
        k = len(ids)
        nbonds = self._lens_e[ids] // 2
        tot = int(nbonds.sum())
        gid_b = np.repeat(np.arange(k), nbonds)
        sel = sample_per_group_np(
            rng, gid_b, np.ones(tot, bool), k, ms["rate"]
        )
        within = np.arange(tot) - np.repeat(
            np.cumsum(nbonds) - nbonds, nbonds
        )
        slots = (
            np.repeat(estarts, nbonds) + 2 * within
        )[sel].astype(np.int32)
        budget = ms["budget"]
        if len(slots) > budget:
            raise ValueError(f"{len(slots)} masked bonds > {budget}")
        pad = np.zeros(budget, np.int32)
        pad[: len(slots)] = slots
        m = np.zeros(budget, bool)
        m[: len(slots)] = True
        mb = np.zeros(self.max_edges, bool)
        mb[slots] = True
        mb[slots + 1] = True
        desc["masked_edge_idx"] = pad
        desc["masked_edge_idx_mask"] = m
        desc["masked_edge_bool"] = mb

    def _add_negatives(self, desc, ids, nstarts, estarts, rng):
        """NegativeEdge (chem/util.py:22-52) in flat-local space: per
        graph draw 5E uniform pairs, keep the first E//2 that are not
        self-loops / existing directed edges / earlier picks. The C++
        sampler (``native.sample_negatives``) draws them, block-aligned
        (``block_edges // 2`` slots a block, the layout the pair-dot
        kernel takes) on a blocked layout, else compact; the numpy
        rejection sampler with ``neg_spec["sampler"] == "numpy"``."""
        budget = self.neg_spec["budget"]
        if self.neg_spec.get("sampler", "native") != "numpy":
            seed = int(rng.integers(np.uint64(2**63)))
            if self.blocks is not None:
                pairs, m = native.sample_negatives(
                    self._edges, ids, nstarts, seed, estarts=estarts,
                    blocks=self.blocks)
                desc["negative_edges_blocked"] = pairs
                desc["negative_edges_blocked_mask"] = m
            else:
                pairs, m = native.sample_negatives(
                    self._edges, ids, nstarts, seed, budget=budget)
                desc["negative_edges"] = pairs
                desc["negative_edges_mask"] = m
            return
        flat = self.flat
        k = len(ids)
        lens_n = self._lens_n[ids]
        lens_e = self._lens_e[ids]
        gi, a, b, cand_per = negative_candidates_np(rng, lens_n, lens_e)

        etot = int(lens_e.sum())
        within = np.arange(etot) - np.repeat(
            np.cumsum(lens_e) - lens_e, lens_e
        )
        erow = np.repeat(flat.edge_off[ids], lens_e) + within
        eg = np.repeat(np.arange(k), lens_e)
        M = int(lens_n.max(initial=1))
        keys_exist = (
            eg * (M * M) + flat.recv[erow].astype(np.int64) * M
            + flat.send[erow]
        )
        take = select_negatives_np(
            gi * (M * M) + a * M + b, keys_exist, k * M * M, a == b,
            cand_per, lens_e // 2, gi,
        )

        gt = gi[take]
        pairs = np.stack(
            [nstarts[gt] + a[take], nstarts[gt] + b[take]], axis=1
        ).astype(np.int32)
        if len(pairs) > budget:
            raise ValueError(
                f"{len(pairs)} negative edges > budget {budget}"
            )
        pad = np.zeros((budget, 2), np.int32)
        pad[: len(pairs)] = pairs
        m = np.zeros(budget, bool)
        m[: len(pairs)] = True
        desc["negative_edges"] = pad
        desc["negative_edges_mask"] = m

    def _add_masking(self, desc, gid, gmask, lens_e, nstart, estart, rng):
        ms = self.mask_spec
        G = len(gid)
        k = int(gmask.sum())
        masked = sample_per_group_np(
            rng, desc["node_graph"], desc["node_mask"], G, ms["rate"]
        )
        slots = np.nonzero(masked)[0].astype(np.int32)
        nb = ms["node_budget"]
        if len(slots) > nb:
            raise ValueError(f"{len(slots)} masked nodes > budget {nb}")
        pad = np.zeros(nb, np.int32)
        pad[: len(slots)] = slots
        m = np.zeros(nb, bool)
        m[: len(slots)] = True
        desc["masked_bool"] = masked
        desc["masked_slots"] = pad
        desc["masked_slots_mask"] = m
        if ms.get("mask_edge"):
            # per-bond (even-slot) representatives whose endpoints hit the
            # masked set — slot endpoints reconstructed from the flat
            # local arrays with the np.repeat trick
            le = lens_e[:k].astype(np.int64)
            etot = int(le.sum())
            if etot:
                within_e = np.arange(etot) - np.repeat(
                    np.cumsum(le) - le, le
                )
                erow = np.repeat(
                    self.flat.edge_off[gid[:k]], le
                ) + within_e
                nbase = np.repeat(nstart[:k], le)
                snd = self.flat.send[erow] + nbase
                rcv = self.flat.recv[erow] + nbase
                em = masked[snd] | masked[rcv]
                eslot = np.repeat(estart[:k], le) + within_e
                conn = eslot[(within_e % 2 == 0) & em].astype(np.int32)
            else:
                conn = np.zeros(0, np.int32)
            eb = ms["edge_budget"]
            if len(conn) > eb:
                raise ValueError(f"{len(conn)} masked bonds > budget {eb}")
            cpad = np.zeros(eb, np.int32)
            cpad[: len(conn)] = conn
            cm = np.zeros(eb, bool)
            cm[: len(conn)] = True
            desc["connected_edge_indices"] = cpad
            desc["connected_edge_indices_mask"] = cm

    def _plan(self, order: np.ndarray):
        """Greedy first-fit partition of the whole (shuffled) epoch into
        batches + chunk-aligned slot placements: one ``native.plan_epoch``
        call on the 8-padded sizes."""
        layout = self.blocks or (1, self.max_nodes, self.max_edges)
        batch, ns, es, n = native.plan_epoch(
            self._aux["lens_n8"], self._aux["lens_e8"], order,
            self.batch_size, *layout)
        return n, batch, ns, es

    def __iter__(self) -> Iterator[Descriptor]:
        order = np.arange(len(self.flat))
        ep = self._epoch
        rng = np.random.default_rng((self.seed, ep))
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1

        n_total, bid, ns, es = self._plan(order)
        bounds = np.searchsorted(bid, np.arange(n_total + 1))
        limit = n_total
        if (self.drop_last and n_total
                and bounds[n_total] - bounds[n_total - 1]
                < self.batch_size):
            limit -= 1  # trailing partial batch

        n_batches = n_graphs = n_edges = 0
        for b in range(limit):
            sl = slice(bounds[b], bounds[b + 1])
            ids = order[sl]
            n_batches += 1
            n_graphs += len(ids)
            n_edges += int(self._lens_e[ids].sum())
            # per-batch keyed rng: draws depend only on
            # (seed, epoch, batch_index)
            brng = np.random.default_rng((self.seed, ep, b))
            yield self._descriptor(ids, ns[sl], es[sl], brng)
        self.last_epoch_stats = {
            "batches": n_batches, "graphs": n_graphs, "edges": n_edges,
            "graphs_per_batch": n_graphs / max(n_batches, 1),
        }
