"""Edge-prediction pretraining (port of ``EdgePredObjective`` of
``pretrain_gnns_tpu.objectives.edgepred``; the same math in the chem and
the bio domain).

Positive pairs are every second directed edge, i.e. each undirected bond
once, since both directions of a bond sit in consecutive slots; the score
of a pair is ``h[a] . h[b]``. Negative pairs come with the batch: the
block-aligned ``negative_edges_blocked`` of
``data.batch_transforms.NativeNegativeEdge`` or the compact
``negative_edges`` of ``BatchNegativeEdge``. Loss = mean BCE(pos, 1) +
mean BCE(neg, 0) over the valid pairs. On CUDA only the blocked layout
runs (the trunk and ``spmm.edge_dot`` raise on a standard batch); the
compact one is the CPU's.

A batch that carries no negatives (``transform_device="device"`` on the
device-resident dataset) gets them drawn inside the step from the
objective's ``mask`` stream (``models.chem.MaskStream``) by
:func:`sample_negative_edges`: one candidate pair an edge slot, in the
slot's own graph, kept if it is no self-loop, no existing directed edge
and no repeat, a graph's quota ``E_g // 2`` taken in slot order. On a
standard batch the pairs are compacted in slot order (the JAX layout); on
a blocked batch each block's pairs come from its own edge slots, at most
``block_edges // 2`` of them, and are laid into its ``block_edges // 2``
slots of ``negative_edges_blocked`` in the same order: the same set of
pairs in the layout the pair-dot kernel takes. Sorts, binary searches and
gathers, shapes fixed and nothing read back, so that it runs inside a
captured CUDA graph; pair keys are int64. Its draws cannot equal
``jax.random``'s; the distribution is the same."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models.chem import GNN, MaskStream
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.objectives.masking import first_per_group
from pretrain_gnns_tpu_torch.ops import segment, spmm


def _masked_bce_mean(scores, target: float, mask) -> torch.Tensor:
    loss = losses.bce_with_logits(scores, torch.full_like(scores, target))
    m = mask.to(loss.dtype)
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


def negative_candidates(g: PackedGraphs, generator: torch.Generator):
    """One candidate pair an edge slot, both ends uniform over the slot's
    graph's nodes, and whether it is kept (see the module docstring).
    Returns ``(a, b, keep)``, each [E_pad]."""
    N, E, G = g.max_nodes, g.max_edges, g.max_graphs
    dev = g.senders.device
    snd, rcv = g.senders.long(), g.receivers.long()
    emask = g.edge_mask
    node_graph = g.node_graph.long()

    # each graph's node count and first row (its rows are contiguous)
    nper = segment.segment_count(node_graph, G, mask=g.node_mask,
                                 dtype=torch.int64)
    rows = torch.where(g.node_mask, torch.arange(N, device=dev), N)
    nstart = torch.full((G,), N, device=dev).scatter_reduce(
        0, node_graph, rows, "amin")
    nstart = torch.where(nper > 0, nstart, 0)

    eg = torch.where(emask, node_graph[snd], G - 1)
    n_e, s_e = nper[eg], nstart[eg]
    u1 = torch.rand(E, generator=generator, device=dev)
    u2 = torch.rand(E, generator=generator, device=dev)
    hi = torch.clamp(n_e - 1, min=0)
    a = s_e + torch.minimum((u1 * n_e).to(torch.int64), hi)
    b = s_e + torch.minimum((u2 * n_e).to(torch.int64), hi)

    # no existing directed edge: a binary search on the sorted edge keys
    sorted_keys = torch.sort(torch.where(emask, snd * N + rcv, -1)).values
    ckey = a * N + b
    pos = torch.searchsorted(sorted_keys, ckey)
    hit = sorted_keys[pos.clamp(max=E - 1)] == ckey
    valid = emask & (a != b) & ~hit

    # no repeat: a stable sort by key keeps each key's slots in order,
    # and the first of each survives
    dkey = torch.where(valid, ckey, N * N)
    order = torch.argsort(dkey, stable=True)
    dk = dkey[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       dk[1:] != dk[:-1]]) & (dk < N * N)
    valid = valid & torch.zeros_like(first).scatter_(0, order, first)

    # each graph's quota E_g // 2, in slot order among the valid
    quota = segment.segment_count(eg, G, mask=emask, dtype=torch.int64) // 2
    keep = first_per_group(torch.where(valid, eg, G), G, quota)
    return a, b, keep


def _pairs(a, b, idx, keep):
    return (torch.stack([a[idx], b[idx]], dim=-1).to(torch.int32),
            keep[idx])


def sample_negative_edges(g: PackedGraphs, generator: torch.Generator,
                          budget: int = 0):
    """The device's ``NegativeEdge`` (chem/util.py:22-52) on ``g``. On a
    standard batch ``(pairs [budget, 2] int32, mask [budget] bool)``, the
    kept pairs first in slot order (``budget`` 0: ``E_pad // 2``). On a
    blocked batch ``(pairs [n_blocks * block_edges // 2, 2], mask)``: block
    ``b``'s kept pairs, in slot order, in its slots ``b * block_edges // 2``
    onwards."""
    a, b, keep = negative_candidates(g, generator)
    if g.block_nodes > 0:
        be = g.block_edges
        # a block's graphs have all their edge slots in the block, so its
        # kept pairs number at most sum(E_g // 2) <= block_edges // 2
        idx = torch.argsort(~keep.view(-1, be), dim=1, stable=True)
        idx = idx[:, : be // 2] + torch.arange(
            0, g.max_edges, be, device=idx.device)[:, None]
        return _pairs(a, b, idx.reshape(-1), keep)
    idx = torch.argsort(~keep, stable=True)[: budget or g.max_edges // 2]
    return _pairs(a, b, idx, keep)


class EdgePredObjective(nn.Module, MaskStream):
    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin", trunk: type = GNN):
        """``trunk`` is the trunk's class: the chem ``GNN`` or, for the
        bio domain, ``models.bio.GNN``."""
        super().__init__()
        self.gnn = trunk(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        self.seed_masks(0)

    def forward(self, g: PackedGraphs, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        extras = dict(g.extras or {})
        if ("negative_edges_blocked" not in extras
                and "negative_edges" not in extras):
            # drawn inside the step (transform_device="device")
            key = ("negative_edges_blocked" if g.block_nodes > 0
                   else "negative_edges")
            extras[key], extras[f"{key}_mask"] = sample_negative_edges(
                g, self.mask_generator(g.senders.device))
        blocked_neg = "negative_edges_blocked" in extras
        h = self.gnn(g, train=train)
        if g.block_nodes > 0:
            # Score ALL edge slots through the blocked pair-dot head and
            # keep the even ones: the odd slots get a zero cotangent from
            # the slice, so the gradient is that of the even-edges loss.
            pos_score = spmm.edge_dot(
                h, g.receivers, g.senders, g.edge_mask, g.block_nodes,
                g.block_edges)[::2]
        else:
            pos_score = spmm.edge_dot(h, g.receivers[::2], g.senders[::2],
                                      g.edge_mask[::2])
        pos_mask = g.edge_mask[::2]
        if blocked_neg:
            neg = extras["negative_edges_blocked"]
            neg_mask = extras["negative_edges_blocked_mask"]
            # column slices of [P, 2] are strided: the kernel takes
            # contiguous index vectors
            neg_score = spmm.edge_dot(
                h, neg[:, 0].contiguous(), neg[:, 1].contiguous(), neg_mask,
                g.block_nodes, g.block_edges // 2)
        else:
            neg = extras["negative_edges"]
            neg_mask = extras["negative_edges_mask"]
            neg_score = spmm.edge_dot(h, neg[:, 0], neg[:, 1], neg_mask)
        loss = (_masked_bce_mean(pos_score, 1.0, pos_mask)
                + _masked_bce_mean(neg_score, 0.0, neg_mask))
        acc = losses.sign_accuracy(pos_score, neg_score, pos_mask, neg_mask)
        return loss, {"acc": acc}
