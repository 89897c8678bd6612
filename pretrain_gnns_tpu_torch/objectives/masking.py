"""Attribute-masking pretraining objectives (port of ``MaskingObjective``
and ``BioMaskEdgeObjective`` of ``pretrain_gnns_tpu.objectives.masking``).

Chem: predict the original atom type (119 classes) of the masked atoms
from their representation and, with ``mask_edge``, the bond type (4
classes) of masked bonds from ``h[src] + h[dst]``. Batches carry the
extras of ``data.batch_transforms.BatchMaskAtom``.

Bio: predict the dominant evidence channel (the argmax of the first 7
label dims) of each masked edge from ``h[src] + h[dst]``. Batches carry
the extras of ``data.batch_transforms.BatchMaskEdge``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import bio, inits
from pretrain_gnns_tpu_torch.models.chem import GNN
from pretrain_gnns_tpu_torch.objectives import losses


def _masked_accuracy(logits, labels, mask) -> torch.Tensor:
    hit = (logits.argmax(-1) == labels.long()) & mask
    return hit.sum() / torch.clamp(mask.sum(), min=1)


class MaskingObjective(nn.Module):
    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin", mask_edge: bool = True,
                 num_atom_classes: int = 119, num_bond_classes: int = 4):
        super().__init__()
        self.mask_edge = mask_edge
        self.gnn = GNN(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        # the JAX heads: weights bounded by the input's width, biases by
        # emb_dim (they differ under JK concat)
        rep = (num_layer + 1) * emb_dim if jk == "concat" else emb_dim
        self.linear_pred_atoms = inits.Linear(rep, num_atom_classes, emb_dim)
        if mask_edge:
            self.linear_pred_bonds = inits.Linear(rep, num_bond_classes,
                                                  emb_dim)

    def forward(self, g: PackedGraphs, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = self.gnn(g, train=train)
        idx = g.extras["masked_atom_indices"].long()
        idx_mask = g.extras["masked_atom_indices_mask"]
        node_labels = g.extras["mask_node_label"][:, 0]
        pred_node = self.linear_pred_atoms(h[idx])
        loss = losses.masked_softmax_xent(pred_node, node_labels, idx_mask)
        metrics = {"acc_node": _masked_accuracy(pred_node, node_labels,
                                                idx_mask)}
        if self.mask_edge:
            eidx = g.extras["connected_edge_indices"].long()
            emask = g.extras["connected_edge_indices_mask"]
            edge_labels = g.extras["mask_edge_label"][:, 0]
            src = g.receivers[eidx].long()
            dst = g.senders[eidx].long()
            pred_edge = self.linear_pred_bonds(h[src] + h[dst])
            loss = loss + losses.masked_softmax_xent(pred_edge, edge_labels,
                                                     emask)
            metrics["acc_edge"] = _masked_accuracy(pred_edge, edge_labels,
                                                   emask)
        return loss, metrics


class BioMaskEdgeObjective(nn.Module):
    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin", num_edge_classes: int = 7):
        super().__init__()
        self.num_edge_classes = num_edge_classes
        self.gnn = bio.GNN(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        self.linear_pred_edges = nn.Linear(emb_dim, num_edge_classes)

    def forward(self, g: PackedGraphs, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = self.gnn(g, train=train)
        eidx = g.extras["masked_edge_idx"].long()
        emask = g.extras["masked_edge_idx_mask"]
        labels = g.extras["mask_edge_label"][:, : self.num_edge_classes
                                             ].argmax(dim=1)
        src = g.receivers[eidx].long()
        dst = g.senders[eidx].long()
        pred = self.linear_pred_edges(h[src] + h[dst])
        loss = losses.masked_softmax_xent(pred, labels, emask)
        return loss, {"acc_edge": _masked_accuracy(pred, labels, emask)}
