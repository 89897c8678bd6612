"""Bio GIN trunk (port of ``GINConv`` and ``GNN`` of
``pretrain_gnns_tpu.models.bio``), for protein ego-networks.

Edge features are 9-dim floats ``[w1..w7, self_loop, mask]``; every conv
encodes them with ``edge_encoder = Linear(9, D)``, fed to the aggregation
in fused form: ``ein = [edge_feat | 1]`` and ``W = [weight^T; bias]``, so
that ``ein @ W == edge_encoder(edge_feat)``. The message is
``[x_j | e]``; its sum per receiver splits into a neighbour sum and an
edge-embedding sum (``ops/spmm.gather_scatter(combine="concat")``, the
fused edge-transform SpMM K2 on CUDA). The self loop (feature one-hot at
dim 7) is added analytically: ``aggr += [h | e_self] * node_mask`` with
``e_self = edge_encoder.weight[:, 7] + bias``.

Module and parameter names follow the reference state dict
(``gnns.0.input_node_embeddings``, ``gnns.{k}.edge_encoder``,
``gnns.{k}.mlp.{0,1,3}`` with the batch norm at ``mlp.1``). Only the GIN
conv and ``drop_ratio = 0`` are ported; the JK modes are ``last`` and the
intended layer ``sum``."""

from __future__ import annotations

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import inits
from pretrain_gnns_tpu_torch.models.norm import MaskedBatchNorm
from pretrain_gnns_tpu_torch.ops import spmm

EDGE_FEAT_DIM = 9
SELF_LOOP_DIM = 7


def edge_inputs(g: PackedGraphs, dtype: torch.dtype) -> torch.Tensor:
    """``[edge_feat | 1]``, the edge input of every conv's encoder."""
    ef = g.edge_feat.to(dtype)
    return torch.cat([ef, torch.ones_like(ef[:, :1])], dim=1)


class GINConv(nn.Module):
    """GIN conv with the ``[x_j | e]`` message, then the MLP
    Linear(2D, 2D) -> masked BatchNorm -> ReLU -> Linear(2D, D). Layer 0
    first embeds the uniform node labels with Embedding(2, D). On CUDA the
    batch must have the block-diagonal layout."""

    def __init__(self, emb_dim: int, input_layer: bool = False):
        super().__init__()
        D = emb_dim
        self.mlp = nn.Sequential(
            nn.Linear(2 * D, 2 * D), MaskedBatchNorm(2 * D), nn.ReLU(),
            nn.Linear(2 * D, D),
        )
        self.edge_encoder = nn.Linear(EDGE_FEAT_DIM, D)
        self.input_layer = input_layer
        if input_layer:
            self.input_node_embeddings = nn.Embedding(2, D)

    def forward(self, h: torch.Tensor, g: PackedGraphs, ein: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        nmask = g.node_mask[:, None]
        if self.input_layer:
            h = self.input_node_embeddings(h[:, 0].long()) * nmask
        enc = self.edge_encoder
        W = torch.cat([enc.weight.t(), enc.bias[None]], dim=0)
        e_self = enc.weight[:, SELF_LOOP_DIM] + enc.bias
        aggr = spmm.gather_scatter(
            h, g.senders, g.receivers, g.edge_mask, g.max_nodes,
            edge_in=ein, edge_kernel=W, combine="concat",
            block_nodes=g.block_nodes, block_edges=g.block_edges,
        )
        self_msg = torch.cat([h, e_self.to(h.dtype).expand_as(h)], dim=1)
        aggr = aggr + self_msg * nmask
        lin0, bn, _, lin3 = self.mlp
        z = torch.relu(bn(lin0(aggr), g.node_mask, train))
        return lin3(z)


class GNN(nn.Module):
    """Node-representation trunk: ``num_layer`` GIN convs (no trunk-level
    embeddings or batch norm), ReLU after every layer but the last, padded
    rows zeroed after every layer, then the JK combination."""

    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin"):
        super().__init__()
        if num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        if gnn_type != "gin":
            raise NotImplementedError(
                f"bio gnn_type={gnn_type!r} is not ported")
        if drop_ratio > 0:
            raise NotImplementedError("dropout is not ported")
        if jk not in ("last", "sum"):
            raise ValueError(f"bio trunk supports JK last|sum, got {jk!r}")
        self.num_layer = num_layer
        self.jk = jk
        self.gnns = nn.ModuleList(
            GINConv(emb_dim, input_layer=(layer == 0))
            for layer in range(num_layer)
        )

    def forward(self, g: PackedGraphs, train: bool = False) -> torch.Tensor:
        nmask = g.node_mask[:, None]
        dtype = inits.activation_dtype()
        ein = edge_inputs(g, dtype)
        h = g.node_feat.to(dtype)
        h_list = []
        for layer, conv in enumerate(self.gnns):
            h = conv(h, g, ein, train)
            if layer != self.num_layer - 1:
                h = torch.relu(h)
            h = h * nmask
            h_list.append(h)
        if self.jk == "last":
            return h_list[-1]
        return sum(h_list[1:], h_list[0])
