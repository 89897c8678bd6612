"""Vectorized transforms over a packed batch (port of
``pretrain_gnns_tpu.data.batch_transforms``: ``sample_per_group_np``,
``BatchMaskAtom``, ``BatchMaskEdge`` and ``BatchNegativeEdge`` with its
selection helpers). The same ``np.random.Generator`` state gives the same
masks, pairs and extras as the JAX package.

Masking: one numpy pass per batch samples each graph's ``int(n * rate) +
1`` distinct atoms (chem) or bonds (bio), writes the mask features and
emits the compact extras that ``objectives.masking`` reads.

Negative edges, for ``objectives.edgepred``: per graph, ``E_g // 2`` node
pairs that are not self-loops, existing directed edges or repeats.
:class:`BatchNegativeEdge` samples them in numpy into a compact
``negative_edges`` list; :class:`NativeNegativeEdge` calls the C++
sampler of ``pretrain_gnns_tpu_torch.native``, which on a blocked batch
writes each graph's pairs into its block's region of ``block_edges // 2``
slots (``negative_edges_blocked``), the layout the pair-dot kernel takes.

Every transform runs in the prefetch thread."""

from __future__ import annotations

import dataclasses

import numpy as np

from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs


def sample_per_group_np(
    rng: np.random.Generator,
    group_ids: np.ndarray,
    valid: np.ndarray,
    num_groups: int,
    rate: float,
) -> np.ndarray:
    """Uniform distinct sampling of ``int(cnt * rate) + 1`` items per
    group: rank items within their group by an iid uniform draw and keep
    the lowest."""
    N = group_ids.shape[0]
    u = rng.random(N)
    sg = np.where(valid, group_ids, num_groups)
    order = np.argsort(sg * 2.0 + u)
    sgs = sg[order]
    seg_start = np.searchsorted(sgs, np.arange(num_groups))
    rank = np.arange(N) - seg_start[np.minimum(sgs, num_groups - 1)]
    nper = np.bincount(group_ids[valid], minlength=num_groups)
    k = (nper * rate).astype(np.int64) + 1  # int(cnt*rate + 1)
    sel = (rank < k[np.minimum(sgs, num_groups - 1)]) & (sgs < num_groups)
    out = np.zeros(N, bool)
    out[order[sel]] = True
    return out


def _pad1(vals: np.ndarray, budget: int, name: str):
    """``vals`` padded to ``budget`` rows, and the mask of its real rows."""
    if len(vals) > budget:
        raise ValueError(f"{len(vals)} {name} exceed budget {budget}")
    out = np.zeros((budget,) + vals.shape[1:], vals.dtype)
    out[: len(vals)] = vals
    m = np.zeros(budget, bool)
    m[: len(vals)] = True
    return out, m


@dataclasses.dataclass
class BatchMaskEdge:
    """bio MaskEdge as a packed-batch transform: per graph, sample
    ``int(bonds * rate) + 1`` distinct bonds (even slots represent them),
    keep their 9-dim features as labels and overwrite both directions with
    the mask feature ``[0, ..., 0, 1]``. Emits ``masked_edge_idx`` (slot
    indices) and ``mask_edge_label``, padded to ``budget``."""

    mask_rate: float = 0.15
    budget: int = 0

    def __call__(self, p: PackedGraphs,
                 rng: np.random.Generator) -> PackedGraphs:
        G = p.max_graphs
        emask = np.asarray(p.edge_mask)
        rcv = np.asarray(p.receivers)
        node_graph = np.asarray(p.node_graph)
        sel = sample_per_group_np(rng, node_graph[rcv[::2]], emask[::2], G,
                                  self.mask_rate)
        eidx = (np.flatnonzero(sel) * 2).astype(np.int32)

        edge_feat = np.array(p.edge_feat)
        labels = edge_feat[eidx].copy()
        mask_feat = np.zeros(edge_feat.shape[1], edge_feat.dtype)
        mask_feat[-1] = 1
        edge_feat[eidx] = mask_feat
        edge_feat[eidx + 1] = mask_feat

        budget = self.budget or (
            int(p.max_edges // 2 * self.mask_rate) + G + 8)
        vals, m = _pad1(eidx, budget, "masked bonds")
        extras = dict(p.extras or {})
        extras["masked_edge_idx"] = vals
        extras["masked_edge_idx_mask"] = m
        extras["mask_edge_label"] = _pad1(labels, budget, "masked bonds")[0]
        extras["mask_edge_label_mask"] = m
        return p.replace(edge_feat=edge_feat, extras=extras)


@dataclasses.dataclass
class BatchMaskAtom:
    """chem MaskAtom as a packed-batch transform. ``node_budget`` and
    ``edge_budget`` are the padded extras lengths."""

    num_atom_type: int = 119
    num_edge_type: int = 5
    mask_rate: float = 0.15
    mask_edge: bool = False
    node_budget: int = 0
    edge_budget: int = 0

    def __call__(self, p: PackedGraphs,
                 rng: np.random.Generator) -> PackedGraphs:
        node_graph = np.asarray(p.node_graph)
        node_mask = np.asarray(p.node_mask)
        masked = sample_per_group_np(
            rng, node_graph, node_mask, p.max_graphs, self.mask_rate
        )
        idx = np.nonzero(masked)[0].astype(np.int32)
        nb = self.node_budget or (
            int(p.max_nodes * self.mask_rate) + p.max_graphs + 8
        )
        pad_i, m = _pad1(idx, nb, "masked nodes")

        node_feat = np.array(p.node_feat)
        labels = node_feat[idx].copy()
        node_feat[idx] = [self.num_atom_type, 0]

        extras = dict(p.extras or {})
        extras["masked_atom_indices"] = pad_i
        extras["masked_atom_indices_mask"] = m
        extras["mask_node_label"] = _pad1(labels, nb, "masked nodes")[0]
        extras["mask_node_label_mask"] = m

        edge_feat = p.edge_feat
        if self.mask_edge:
            snd = np.asarray(p.senders)
            rcv = np.asarray(p.receivers)
            emask = np.asarray(p.edge_mask)
            edge_masked = (masked[snd] | masked[rcv]) & emask
            # both directions of a bond sit in consecutive slots from an
            # even offset, so even slots represent the bonds
            conn = np.nonzero(edge_masked[::2])[0].astype(np.int32) * 2
            eb = self.edge_budget or p.max_edges // 2
            pe, em = _pad1(conn, eb, "masked bonds")
            edge_feat = np.array(p.edge_feat)
            elabels = edge_feat[conn].copy()
            edge_feat[edge_masked] = [self.num_edge_type, 0]
            extras["connected_edge_indices"] = pe
            extras["connected_edge_indices_mask"] = em
            extras["mask_edge_label"] = _pad1(elabels, eb, "masked bonds")[0]
            extras["mask_edge_label_mask"] = em

        return p.replace(node_feat=node_feat, edge_feat=edge_feat,
                         extras=extras)


def negative_candidates_np(rng: np.random.Generator,
                           n_per_group: np.ndarray,
                           e_per_group: np.ndarray):
    """Candidate pool of the rejection sampling: per group draw
    ``5 * E_g`` uniform (a, b) local-node pairs. Returns
    (group_id, a_local, b_local, cand_per)."""
    cand_per = 5 * e_per_group
    C = int(cand_per.sum())
    gid = np.repeat(np.arange(len(e_per_group)), cand_per)
    u = rng.random((C, 2))
    n = n_per_group[gid]
    a = (u[:, 0] * n).astype(np.int64)
    b = (u[:, 1] * n).astype(np.int64)
    return gid, a, b, cand_per


# dense tables up to this many keys: a bool exists-table (1 B) and an
# int32 first-index table (4 B) per key, about 80 MB at the cap
_DENSE_KEYSPACE_CAP = 1 << 24


def select_first_valid_np(key: np.ndarray, exist_keys: np.ndarray,
                          keyspace: int, selfloop: np.ndarray,
                          cand_per: np.ndarray, want: np.ndarray,
                          gid: np.ndarray) -> np.ndarray:
    """The acceptance loop of the reference's NegativeEdge, vectorized:
    reject self-loops, existing directed edges and duplicates (first
    occurrence: an identical earlier candidate that was itself invalid
    makes the later copy invalid too, so dedup over all candidates equals
    dedup over the accepted ones), then keep each group's first ``want``
    survivors in candidate order. Returns the take mask.

    ``key`` must be below ``keyspace``; small keyspaces use dense tables:
    membership is one indexed load, and first occurrence is a reversed
    duplicate-index write (the last write wins, so writing in reverse
    candidate order leaves each key's first index)."""
    C = len(key)
    if C == 0:
        return np.zeros(0, bool)
    if keyspace <= _DENSE_KEYSPACE_CAP:
        table = np.zeros(keyspace, bool)
        table[exist_keys] = True
        exists = table[key]
        first = np.empty(keyspace, np.int32)  # only written slots read
        idx = np.arange(C, dtype=np.int32)
        first[key[::-1]] = idx[::-1]
        is_first = first[key] == idx
    else:
        exist_sorted = np.sort(exist_keys)
        pos = np.minimum(np.searchsorted(exist_sorted, key),
                         max(len(exist_sorted) - 1, 0))
        exists = (
            (exist_sorted[pos] == key) if len(exist_sorted)
            else np.zeros(C, bool)
        )
        first_idx = np.unique(key, return_index=True)[1]
        is_first = np.zeros(C, bool)
        is_first[first_idx] = True
    ok = ~selfloop & ~exists & is_first

    csum = np.cumsum(ok)
    run_start = np.concatenate([[0], np.cumsum(cand_per)[:-1]])
    cum_before = np.where(run_start > 0,
                          csum[np.maximum(run_start - 1, 0)], 0)
    rank = csum - np.repeat(cum_before, cand_per) - 1
    return ok & (rank < want[gid])


def select_negatives_np(key: np.ndarray, exist_keys: np.ndarray,
                        keyspace: int, selfloop: np.ndarray,
                        cand_per: np.ndarray, want: np.ndarray,
                        gid: np.ndarray) -> np.ndarray:
    """:func:`select_first_valid_np` with prefix escalation: nine in ten
    candidates are accepted, so each group's first ``3 * want + 8``
    candidates almost always hold the full quota, and since keys embed
    the group id a group's take mask depends only on its own candidates:
    the prefix result equals the full result whenever every quota is met.
    Otherwise the full ``5 * E`` pool is evaluated."""
    prefix = np.minimum(cand_per, 3 * want + 8)
    if int(prefix.sum()) < len(key):
        run_start = np.concatenate([[0], np.cumsum(cand_per)[:-1]])
        tot = int(prefix.sum())
        within = np.arange(tot) - np.repeat(
            np.cumsum(prefix) - prefix, prefix
        )
        pos = np.repeat(run_start, prefix) + within
        gid_p = np.repeat(np.arange(len(want)), prefix)
        take_p = select_first_valid_np(
            key[pos], exist_keys, keyspace, selfloop[pos], prefix,
            want, gid_p,
        )
        got = np.bincount(gid_p[take_p], minlength=len(want))
        if (got >= want).all():
            take = np.zeros(len(key), bool)
            take[pos[take_p]] = True
            return take
    return select_first_valid_np(key, exist_keys, keyspace, selfloop,
                                 cand_per, want, gid)


def _graph_slot_ranges(p: PackedGraphs):
    """(start, count) of each graph's contiguous node-slot run. Both
    packers place a graph's nodes contiguously (within one block for the
    blocked layout), so the run is [start, start + count)."""
    node_graph = np.asarray(p.node_graph)
    node_mask = np.asarray(p.node_mask)
    G = p.max_graphs
    idx = np.flatnonzero(node_mask)
    gids = node_graph[idx]
    counts = np.bincount(gids, minlength=G)
    starts = np.zeros(G, np.int64)
    order = np.argsort(gids, kind="stable")
    first = np.searchsorted(gids[order], np.arange(G))
    has = counts > 0
    starts[has] = idx[order[first[has]]]
    return starts, counts


@dataclasses.dataclass
class BatchNegativeEdge:
    """The reference's NegativeEdge as one vectorized pass over the packed
    batch: per graph, draw ``5 * E_g`` uniform node pairs and keep the
    first ``E_g // 2`` that are not self-loops, existing directed edges or
    earlier picks. Emits the slot-space ``negative_edges`` [budget, 2] and
    its mask (the compact layout)."""

    edge_budget: int = 0

    def __call__(self, p: PackedGraphs,
                 rng: np.random.Generator) -> PackedGraphs:
        G = p.max_graphs
        snd = np.asarray(p.senders)
        rcv = np.asarray(p.receivers)
        emask = np.asarray(p.edge_mask)
        node_graph = np.asarray(p.node_graph)
        starts, counts_n = _graph_slot_ranges(p)

        e_counts = np.bincount(node_graph[rcv[emask]], minlength=G)
        gid_c, a_loc, b_loc, cand_per = negative_candidates_np(
            rng, counts_n, e_counts
        )
        a = starts[gid_c] + a_loc
        b = starts[gid_c] + b_loc
        # graph-local keys keep the keyspace inside the dense tables
        M = int(counts_n.max(initial=1))
        er, es = rcv[emask], snd[emask]
        eg = node_graph[er]
        keys_exist = (
            eg.astype(np.int64) * (M * M)
            + (er - starts[eg]).astype(np.int64) * M + (es - starts[eg])
        )
        take = select_negatives_np(
            gid_c * (M * M) + a_loc * M + b_loc, keys_exist,
            G * M * M, a_loc == b_loc, cand_per, e_counts // 2, gid_c,
        )

        pairs = np.stack([a[take], b[take]], axis=1).astype(np.int32)
        budget = self.edge_budget or p.max_edges // 2
        vals, m = _pad1(pairs, budget, "negative edges")
        extras = dict(p.extras or {})
        extras["negative_edges"] = vals
        extras["negative_edges_mask"] = m
        return p.replace(extras=extras)


@dataclasses.dataclass
class NativeNegativeEdge:
    """NegativeEdge through the C++ sampler (``native/negatives.cpp``),
    fed from the packed batch: per graph in batch order, the graph-local
    endpoints of its valid edges, its node count, its first node row and
    its first edge slot. One 63-bit seed is drawn from the generator per
    batch; the sampler derives each graph's stream from it.

    It takes a blocked batch and emits ``negative_edges_blocked``
    ``[n_blocks * block_edges // 2, 2]`` and its mask, each graph's pairs
    in its block's region; a standard batch raises
    (:class:`BatchNegativeEdge` samples for those)."""

    def __call__(self, p: PackedGraphs,
                 rng: np.random.Generator) -> PackedGraphs:
        if not (p.block_nodes > 0 and p.block_edges > 0):
            raise ValueError("NativeNegativeEdge needs a blocked batch; "
                             "use BatchNegativeEdge on a standard one")
        G = p.max_graphs
        snd = np.asarray(p.senders)
        rcv = np.asarray(p.receivers)
        node_graph = np.asarray(p.node_graph)
        nstarts, lens_n = _graph_slot_ranges(p)

        # a graph's edges fill consecutive slots: a stable sort by graph
        # keeps their slot order
        slots = np.flatnonzero(np.asarray(p.edge_mask))
        eg = node_graph[rcv[slots]]
        order = np.argsort(eg, kind="stable")
        slots, eg = slots[order], eg[order]
        lens_e = np.bincount(eg, minlength=G)
        edge_off = np.concatenate([[0], np.cumsum(lens_e)]).astype(np.int64)
        send = (snd[slots] - nstarts[eg]).astype(np.int32)
        recv = (rcv[slots] - nstarts[eg]).astype(np.int32)
        estarts = np.zeros(G, np.int64)
        has = lens_e > 0
        estarts[has] = slots[edge_off[:-1][has]]
        seed = int(rng.integers(np.uint64(2**63)))

        pairs, m = native.sample_negatives_blocked(
            send, recv, edge_off, lens_n, nstarts, estarts,
            p.block_edges, p.max_edges // p.block_edges, seed)
        extras = dict(p.extras or {})
        extras["negative_edges_blocked"] = pairs
        extras["negative_edges_blocked_mask"] = m
        return p.replace(extras=extras)
