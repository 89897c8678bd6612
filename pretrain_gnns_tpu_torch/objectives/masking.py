"""Attribute-masking pretraining objectives (port of ``MaskingObjective``,
``FusedMaskingObjective``, ``sample_masked_nodes`` and
``BioMaskEdgeObjective`` of ``pretrain_gnns_tpu.objectives.masking``).

Chem: predict the original atom type (119 classes) of the masked atoms
from their representation and, with ``mask_edge``, the bond type (4
classes) of masked bonds from ``h[src] + h[dst]``. ``MaskingObjective``'s
batches carry the extras of ``data.batch_transforms.BatchMaskAtom`` (or
of a device-resident descriptor's ``mask_spec``);
``FusedMaskingObjective`` takes clean batches and masks inside the step
(``transform_device="device"``), its draws from the objective's ``mask``
stream (``models.chem.MaskStream``): :func:`sample_masked_nodes` takes
``int(n_g * rate) + 1`` distinct atoms of each graph by sorts, binary
searches and gathers, shapes fixed, nothing read back to the host, so
that it runs inside a captured CUDA graph. Its draws cannot equal
``jax.random``'s; the distribution is the same.

Bio: predict the dominant evidence channel (the argmax of the first 7
label dims) of each masked edge from ``h[src] + h[dst]``. Batches carry
the extras of ``data.batch_transforms.BatchMaskEdge``.

The heads go through ``models.inits.dense`` (the mixed-precision knob);
the losses are taken in float32."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.data.device_pack import token_row
from pretrain_gnns_tpu_torch.models import bio, inits
from pretrain_gnns_tpu_torch.models.chem import GNN, MaskStream
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.ops import segment


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
        pred_node = inits.dense(self.linear_pred_atoms, h[idx])
        loss = losses.masked_softmax_xent(pred_node, node_labels, idx_mask)
        metrics = {"acc_node": _masked_accuracy(pred_node, node_labels,
                                                idx_mask)}
        if self.mask_edge:
            eidx = g.extras["connected_edge_indices"].long()
            emask = g.extras["connected_edge_indices_mask"]
            edge_labels = g.extras["mask_edge_label"][:, 0]
            src = g.receivers[eidx].long()
            dst = g.senders[eidx].long()
            pred_edge = inits.dense(self.linear_pred_bonds, h[src] + h[dst])
            loss = loss + losses.masked_softmax_xent(pred_edge, edge_labels,
                                                     emask)
            metrics["acc_edge"] = _masked_accuracy(pred_edge, edge_labels,
                                                   emask)
        return loss, metrics


def first_per_group(groups: torch.Tensor, num_groups: int,
                    quota: torch.Tensor) -> torch.Tensor:
    """Keeps the first ``quota[g]`` items of each group ``g`` in index order
    (``groups`` [N] in ``[0, num_groups]``, ``num_groups`` meaning no
    group): a stable sort by group, each item's rank in its group by a
    binary search for the group's first sorted position, and the kept
    flags scattered back through the sort's permutation. Returns a bool
    [N]."""
    n = groups.shape[0]
    order = torch.argsort(groups, stable=True)
    sg = groups[order]
    last = num_groups - 1
    seg_start = torch.searchsorted(
        sg, torch.arange(num_groups, dtype=sg.dtype, device=sg.device))
    rank = torch.arange(n, device=sg.device) - seg_start[sg.clamp(max=last)]
    take = (rank < quota[sg.clamp(max=last)]) & (sg < num_groups)
    return torch.zeros_like(take).scatter_(0, order, take)


def sample_masked_nodes(node_graph: torch.Tensor, node_mask: torch.Tensor,
                        num_graphs: int, mask_rate: float,
                        generator: torch.Generator) -> torch.Tensor:
    """The device's ``random.sample(range(n_g), int(n_g * rate) + 1)`` for
    each graph (chem/util.py:230): one uniform a node from ``generator``,
    the nodes ranked within their graph by a stable sort of ``graph * 2 +
    u`` (the uniform lies in [0, 1), so graphs never interleave), and each
    graph's ``floor(n_g * rate + 1e-4) + 1`` lowest kept (in float32, the
    epsilon guarding exact products such as 20 * 0.15). Returns a bool
    [N_pad] mask of valid nodes."""
    n = node_graph.shape[0]
    u = torch.rand(n, generator=generator, device=node_graph.device)
    sg = torch.where(node_mask, node_graph.to(torch.int32), num_graphs)
    order = torch.argsort(sg.to(torch.float32) * 2.0 + u, stable=True)
    nper = segment.segment_count(node_graph, num_graphs, mask=node_mask)
    n_masked = torch.floor(nper * mask_rate + 1e-4).to(torch.int32) + 1
    ranked = first_per_group(sg[order], num_graphs, n_masked)
    masked = torch.zeros_like(ranked).scatter_(0, order, ranked)
    return masked & node_mask


class FusedMaskingObjective(nn.Module, MaskStream):
    """Chem attribute masking on clean batches, the masks drawn inside the
    step (see the module docstring). ``masked_override`` [N_pad] bool takes
    the place of the draw (the parity tests). The heads are
    ``MaskingObjective``'s; the node head runs over every row and the
    loss weighs the masked ones, and the edge head over every bond's even
    slot, weighed by whether an endpoint is masked."""

    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin", mask_edge: bool = True,
                 mask_rate: float = 0.15, num_atom_classes: int = 119,
                 num_bond_classes: int = 4, mask_atom_token: int = 119,
                 mask_bond_token: int = 5):
        super().__init__()
        self.mask_edge, self.mask_rate = mask_edge, mask_rate
        self.mask_atom_token, self.mask_bond_token = (mask_atom_token,
                                                      mask_bond_token)
        self.gnn = GNN(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        rep = (num_layer + 1) * emb_dim if jk == "concat" else emb_dim
        self.linear_pred_atoms = inits.Linear(rep, num_atom_classes, emb_dim)
        if mask_edge:
            self.linear_pred_bonds = inits.Linear(rep, num_bond_classes,
                                                  emb_dim)
        self.seed_masks(0)

    def forward(self, g: PackedGraphs, train: bool = False,
                masked_override: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if masked_override is not None:
            masked = masked_override & g.node_mask
        else:
            masked = sample_masked_nodes(
                g.node_graph, g.node_mask, g.max_graphs, self.mask_rate,
                self.mask_generator(g.node_mask.device))
        nf = g.node_feat
        node_labels = nf[:, 0]
        token = token_row(nf.shape[1], self.mask_atom_token, nf)
        x_in = torch.where(masked[:, None], token, nf)
        edge_feat = g.edge_feat
        if self.mask_edge:
            edge_masked = (masked[g.senders.long()]
                           | masked[g.receivers.long()]) & g.edge_mask
            etoken = token_row(edge_feat.shape[1], self.mask_bond_token,
                               edge_feat)
            edge_feat = torch.where(edge_masked[:, None], etoken, edge_feat)
        h = self.gnn(g.replace(node_feat=x_in, edge_feat=edge_feat),
                     train=train)
        pred_node = inits.dense(self.linear_pred_atoms, h)
        loss = losses.masked_softmax_xent(pred_node, node_labels, masked)
        metrics = {"acc_node": _masked_accuracy(pred_node, node_labels,
                                                masked)}
        if self.mask_edge:
            # both directions of a bond sit in consecutive slots from an
            # even offset, so even slots represent the bonds
            src = g.receivers[::2].long()
            dst = g.senders[::2].long()
            pair_w = edge_masked[::2] & g.edge_mask[::2]
            edge_labels = g.edge_feat[::2, 0]
            pred_edge = inits.dense(self.linear_pred_bonds, h[src] + h[dst])
            loss = loss + losses.masked_softmax_xent(pred_edge, edge_labels,
                                                     pair_w)
            metrics["acc_edge"] = _masked_accuracy(pred_edge, edge_labels,
                                                   pair_w)
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
        pred = inits.dense(self.linear_pred_edges, h[src] + h[dst])
        loss = losses.masked_softmax_xent(pred, labels, emask)
        return loss, {"acc_edge": _masked_accuracy(pred, labels, emask)}
