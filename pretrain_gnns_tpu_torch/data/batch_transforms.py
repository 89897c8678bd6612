"""Vectorized masking over a packed batch (port of
``pretrain_gnns_tpu.data.batch_transforms``: ``sample_per_group_np``,
``BatchMaskAtom`` and ``BatchMaskEdge``). The same ``np.random.Generator``
state gives the same masks and extras as the JAX package.

One numpy pass per batch samples each graph's ``int(n * rate) + 1``
distinct atoms (chem) or bonds (bio), writes the mask features and emits
the compact extras that ``objectives.masking`` reads. It runs in the
prefetch thread."""

from __future__ import annotations

import dataclasses

import numpy as np

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
