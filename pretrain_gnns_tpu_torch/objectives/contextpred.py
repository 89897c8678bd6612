"""Context-prediction pretraining (port of ``ContextPredObjective`` of
``pretrain_gnns_tpu.objectives.contextpred``; the same math in the chem and
the bio domain).

Two independent trunks: ``gnn_substruct`` (``num_layer`` layers) encodes
the substructure stream and ``gnn_context`` (``csize`` layers) the context
stream of a ``PackedPair``. ``substruct_rep`` is each graph's centre row
of the substructure trunk; the overlap rows are the context trunk's rows
of the context nodes that lie in the substructure.

cbow: the overlap rows pooled per graph (``context_pooling`` mean or sum)
give ``context_rep``; the positive score is ``substruct_rep .
context_rep``, the negatives pair each substructure with the
``context_rep`` of the graph ``i + 1``, ``i + 2``, ... slots on among the
valid ones (:func:`objectives.infomax.cycle_shift`). skipgram: each
overlap row scores against its graph's ``substruct_rep``, the negatives
against the shifted graphs'. Loss = masked mean BCE(pos, 1) +
``neg_samples`` x masked mean BCE(neg, 0), in float32 (the JAX package's
documented deviation: the reference takes it in float64).

The rows are gathered by ``ops/segment.gather_rows`` and pooled (cbow) or
spread over the overlap rows (skipgram) by a one-hot product over the
graph slots, so that forward and backward sum in the same order every run
on either device."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedPair
from pretrain_gnns_tpu_torch.models.chem import GNN
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.objectives.edgepred import _masked_bce_mean
from pretrain_gnns_tpu_torch.objectives.infomax import cycle_shift
from pretrain_gnns_tpu_torch.ops import segment as seg


def slot_one_hot(slot: torch.Tensor, mask: torch.Tensor, num_slots: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """``[num_slots, K]``: 1 where valid row k belongs to slot s."""
    slots = torch.arange(num_slots, device=slot.device)
    return ((slot.long()[None, :] == slots[:, None])
            & mask.bool()[None, :]).to(dtype)


class ContextPredObjective(nn.Module):
    def __init__(self, num_layer: int = 5, csize: int = 3,
                 emb_dim: int = 300, jk: str = "last",
                 drop_ratio: float = 0.0, gnn_type: str = "gin",
                 mode: str = "cbow", neg_samples: int = 1,
                 context_pooling: str = "mean", trunk: type = GNN):
        """``trunk`` is the trunks' class: the chem ``GNN`` or, for the
        bio domain, ``models.bio.GNN``."""
        super().__init__()
        if mode not in ("cbow", "skipgram"):
            raise ValueError("Invalid mode!")
        if context_pooling not in ("mean", "sum"):
            raise ValueError(f"unknown context_pooling {context_pooling!r}")
        self.mode, self.neg_samples = mode, neg_samples
        self.context_pooling = context_pooling
        self.gnn_substruct = trunk(num_layer, emb_dim, jk, drop_ratio,
                                   gnn_type)
        self.gnn_context = trunk(csize, emb_dim, jk, drop_ratio, gnn_type)

    def forward(self, pair: PackedPair, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sub, ctx = pair.substruct, pair.context
        h_sub = self.gnn_substruct(sub, train=train)
        h_ctx = self.gnn_context(ctx, train=train)

        center = sub.extras["center_substruct_idx"].reshape(-1).long()
        substruct_rep = seg.gather_rows(h_sub, center)  # [G, D]
        graph_mask = sub.graph_mask
        G = ctx.max_graphs
        n_valid = graph_mask.sum()
        ov_mask = ctx.extras["overlap_context_substruct_idx_mask"]
        # padded overlap entries read rows of their own (none repeats a
        # row thousands of times, which a sorted backward would walk one
        # by one); the mask keeps them out of every sum
        ov_idx = ctx.extras["overlap_context_substruct_idx"].long()
        ov_idx = torch.where(ov_mask, ov_idx, torch.arange(
            ov_idx.shape[0], device=ov_idx.device) % ctx.max_nodes)
        ov_rep = seg.gather_rows(h_ctx, ov_idx)  # [K, D]
        hot = slot_one_hot(seg.gather_rows(ctx.node_graph, ov_idx),
                           ov_mask, G, ov_rep.dtype)  # [G, K]
        shifts = [cycle_shift(G, n_valid, i + 1, device=h_sub.device)
                  for i in range(self.neg_samples)]

        if self.mode == "cbow":
            context_rep = hot @ ov_rep  # [G, D]
            if self.context_pooling == "mean":
                context_rep = context_rep / torch.clamp(
                    hot.sum(dim=1, keepdim=True), min=1.0)
            pred_pos = (substruct_rep * context_rep).sum(dim=1)
            pred_neg = torch.cat([
                (substruct_rep * seg.gather_rows(context_rep, s)).sum(dim=1)
                for s in shifts])
            pos_mask = graph_mask
        else:
            # each valid overlap row's graph's row (the product picks it
            # exactly), 0 for the padded ones
            spread = hot.t()  # [K, G]
            pred_pos = ((spread @ substruct_rep) * ov_rep).sum(dim=1)
            pred_neg = torch.cat([
                ((spread @ seg.gather_rows(substruct_rep, s)) * ov_rep
                 ).sum(dim=1) for s in shifts])
            pos_mask = ov_mask
        neg_mask = pos_mask.repeat(self.neg_samples)

        loss_pos = _masked_bce_mean(pred_pos, 1.0, pos_mask)
        loss_neg = _masked_bce_mean(pred_neg, 0.0, neg_mask)
        loss = loss_pos + self.neg_samples * loss_neg
        return loss, {
            "balanced_loss": loss_pos + loss_neg,
            "acc": losses.sign_accuracy(pred_pos, pred_neg, pos_mask,
                                        neg_mask),
        }
