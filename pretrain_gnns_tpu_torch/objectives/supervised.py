"""Supervised pretraining as a ``run_pretrain`` objective (port of
``SupervisedObjective`` of ``pretrain_gnns_tpu.objectives.supervised``).

The reference's supervised stage trains a ``GNNGraphPred`` with the
domain's BCE: the masked multi-task BCE on labels in {-1, 0, +1} for chem
(1,310 ChEMBL tasks there), the plain BCE on {0, 1} labels for bio (5,000
coarse GO terms there). The head lives under ``pred`` and its trunk under
``pred.gnn``; ``TRUNK_PATH`` names that path for whoever saves the
trunk."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import bio as bio_models
from pretrain_gnns_tpu_torch.models import chem as chem_models
from pretrain_gnns_tpu_torch.objectives import losses

TRUNK_PATH = ("pred", "gnn")


class SupervisedObjective(nn.Module):
    def __init__(self, num_tasks: int = 1, num_layer: int = 5,
                 emb_dim: int = 300, jk: str = "last",
                 drop_ratio: float = 0.0, gnn_type: str = "gin",
                 graph_pooling: str = "mean", domain: str = "chem"):
        super().__init__()
        self.domain = domain
        pred_cls = (bio_models.GNNGraphPred if domain == "bio"
                    else chem_models.GNNGraphPred)
        self.pred = pred_cls(
            num_layer=num_layer, emb_dim=emb_dim, num_tasks=num_tasks, jk=jk,
            drop_ratio=drop_ratio, graph_pooling=graph_pooling,
            gnn_type=gnn_type)

    @property
    def gnn(self) -> nn.Module:
        """The trunk, where the other objectives keep theirs."""
        return self.pred.gnn

    def forward(self, g: PackedGraphs, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if g.y is None:
            raise ValueError("the batch carries no labels y [G, T]")
        out = self.pred(g, train=train)
        loss_of = (losses.plain_bce if self.domain == "bio"
                   else losses.masked_task_bce)
        return loss_of(out, g.y, g.graph_mask), {}
