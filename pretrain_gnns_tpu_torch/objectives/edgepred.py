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
compact one is the CPU's. Sampling negatives on the device inside the step
is not ported: a batch without negatives raises."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models.chem import GNN
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.ops import spmm


def _masked_bce_mean(scores, target: float, mask) -> torch.Tensor:
    loss = losses.bce_with_logits(scores, torch.full_like(scores, target))
    m = mask.to(loss.dtype)
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


class EdgePredObjective(nn.Module):
    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin", trunk: type = GNN):
        """``trunk`` is the trunk's class: the chem ``GNN`` or, for the
        bio domain, ``models.bio.GNN``."""
        super().__init__()
        self.gnn = trunk(num_layer, emb_dim, jk, drop_ratio, gnn_type)

    def forward(self, g: PackedGraphs, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        extras = g.extras or {}
        blocked_neg = "negative_edges_blocked" in extras
        if not blocked_neg and "negative_edges" not in extras:
            raise ValueError(
                "the batch carries no negative edges: build it with "
                "NativeNegativeEdge or BatchNegativeEdge")
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
