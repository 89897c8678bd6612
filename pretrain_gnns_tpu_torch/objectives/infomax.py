"""Deep Graph Infomax pretraining (port of ``InfomaxObjective`` of
``pretrain_gnns_tpu.objectives.infomax``; the same math in the chem and the
bio domain).

``summary = sigmoid(mean_pool(h))`` per graph slot; a bilinear
discriminator ``score(v, s) = h_v . (s W)`` with ``W [D, D]`` drawn from
U(-1/sqrt(D), 1/sqrt(D)). Positive pairs match each node with its own
graph's summary; negative pairs with the next valid graph's, by the cyclic
shift over the valid graph slots (:func:`cycle_shift`). Loss = masked mean
BCE(pos, 1) + masked mean BCE(neg, 0) over the valid nodes. The batches
carry no transform."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import pools
from pretrain_gnns_tpu_torch.models.chem import GNN
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.objectives.edgepred import _masked_bce_mean


def cycle_shift(num_slots: int, n_valid: torch.Tensor, shift: int,
                device=None) -> torch.Tensor:
    """Slot ``i`` -> ``(i + shift) mod n_valid`` for ``i < n_valid``;
    padded slots (and every slot when ``n_valid`` is 0) map to
    themselves. ``n_valid`` is a tensor, so the card is not waited on."""
    i = torch.arange(num_slots, device=device)
    shifted = torch.where(n_valid > 0,
                          (i + shift) % torch.clamp(n_valid, min=1), i)
    return torch.where(i < n_valid, shifted, i)


class InfomaxObjective(nn.Module):
    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin", trunk: type = GNN):
        """``trunk`` is the trunk's class: the chem ``GNN`` or, for the
        bio domain, ``models.bio.GNN``. The discriminator weight keeps the
        JAX package's name, ``discriminator_weight``."""
        super().__init__()
        self.gnn = trunk(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        self.discriminator_weight = nn.Parameter(
            torch.empty(emb_dim, emb_dim))
        self.reset_discriminator()

    @torch.no_grad()
    def reset_discriminator(self, generator=None) -> None:
        """U(-1/sqrt(D), 1/sqrt(D)), PyG's ``uniform`` of the reference."""
        bound = 1.0 / math.sqrt(self.discriminator_weight.shape[0])
        self.discriminator_weight.uniform_(-bound, bound,
                                           generator=generator)

    def forward(self, g: PackedGraphs, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = self.gnn(g, train=train)
        summary = torch.sigmoid(pools.mean_pool(h, g))  # [G, D]
        w = self.discriminator_weight
        proj = summary.to(w.dtype) @ w  # [G, D], float32 as jnp promotes
        node_graph = g.node_graph.long()
        shifted = cycle_shift(g.max_graphs, g.graph_mask.sum(), 1,
                              device=h.device)
        pos = (h * proj[node_graph]).sum(dim=1)
        neg = (h * proj[shifted[node_graph]]).sum(dim=1)
        loss = (_masked_bce_mean(pos, 1.0, g.node_mask)
                + _masked_bce_mean(neg, 0.0, g.node_mask))
        acc = losses.sign_accuracy(pos, neg, g.node_mask, g.node_mask)
        return loss, {"acc": acc}
