"""Vectorized masking over a packed batch (port of
``pretrain_gnns_tpu.data.batch_transforms``: ``sample_per_group_np`` and
``BatchMaskAtom``). The same ``np.random.Generator`` state gives the same
masks and extras as the JAX package.

One numpy pass per batch samples each graph's ``int(n * rate) + 1``
distinct atoms, writes the mask tokens and emits the compact extras that
``objectives.masking.MaskingObjective`` reads. It runs in the prefetch
thread."""

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
        if len(idx) > nb:
            raise ValueError(f"{len(idx)} masked nodes exceed budget {nb}")

        node_feat = np.array(p.node_feat)
        labels = node_feat[idx].copy()
        node_feat[idx] = [self.num_atom_type, 0]

        extras = dict(p.extras or {})
        pad_i = np.zeros(nb, np.int32)
        pad_i[: len(idx)] = idx
        pad_l = np.zeros((nb,) + labels.shape[1:], labels.dtype)
        pad_l[: len(idx)] = labels
        m = np.zeros(nb, bool)
        m[: len(idx)] = True
        extras["masked_atom_indices"] = pad_i
        extras["masked_atom_indices_mask"] = m
        extras["mask_node_label"] = pad_l
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
            if len(conn) > eb:
                raise ValueError(
                    f"{len(conn)} masked bonds exceed budget {eb}"
                )
            edge_feat = np.array(p.edge_feat)
            elabels = edge_feat[conn].copy()
            edge_feat[edge_masked] = [self.num_edge_type, 0]
            pe = np.zeros(eb, np.int32)
            pe[: len(conn)] = conn
            pl = np.zeros((eb,) + elabels.shape[1:], elabels.dtype)
            pl[: len(conn)] = elabels
            em = np.zeros(eb, bool)
            em[: len(conn)] = True
            extras["connected_edge_indices"] = pe
            extras["connected_edge_indices_mask"] = em
            extras["mask_edge_label"] = pl
            extras["mask_edge_label_mask"] = em

        return p.replace(node_feat=node_feat, edge_feat=edge_feat,
                         extras=extras)
