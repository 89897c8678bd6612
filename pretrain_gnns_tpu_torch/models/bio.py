"""Bio trunk and graph-level head (port of ``GINConv``, ``GCNConv``,
``GATConv``, ``SAGEConv``, ``GNN`` and ``GNNGraphPred`` of
``pretrain_gnns_tpu.models.bio``), for protein ego-networks.

Edge features are 9-dim floats ``[w1..w7, self_loop, mask]``; every conv
encodes them with ``edge_encoder = Linear(9, D)``, fed to the aggregation
in fused form: ``ein = [edge_feat | 1]`` and ``W = [weight^T; bias]``, so
that ``ein @ W == edge_encoder(edge_feat)``. GIN's message is
``[x_j | e]``; its sum per receiver splits into a neighbour sum and an
edge-embedding sum (``ops/spmm.gather_scatter(combine="concat")``, the
fused edge-transform SpMM K2 on CUDA). The self loop (feature one-hot at
dim 7) is added analytically: ``aggr += [h | e_self] * node_mask`` with
``e_self = edge_encoder.weight[:, 7] + bias``. GCN and GraphSAGE apply
``Linear(D, D)`` first and send ``x_j + e`` (K2's ``x + ein`` variant),
with the normalisations of the chem convs. GAT is the chem GAT layer with
the encoder ``Linear(9, H*D)`` as its edge embedding (the fused GAT conv
K4 on CUDA, or the GAT attention K5 under
``ops/gat_conv.set_fused("off")``).

Module and parameter names follow the reference state dict
(``gnns.0.input_node_embeddings``, ``gnns.{k}.edge_encoder``,
``gnns.{k}.mlp.{0,1,3}`` with the batch norm at ``mlp.1``,
``gnns.{k}.linear``, or ``gnns.{k}.weight_linear`` with ``gnns.{k}.att``
and ``gnns.{k}.bias``; the head adds ``gnn.*``, ``pool.gate_nn`` and
``graph_pred_linear``). The JK modes are ``last`` and the intended layer
``sum``. Dropout follows every layer's ReLU in train mode, as in the chem
trunk; the convs take ``train`` for their batch norm only. Under the
mixed-precision knob of ``models.inits`` the node-label embedding is cast
to the activation dtype, the edge inputs and tables stay float32, and the
dense layers go through ``inits.dense``, as in the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import inits, pools
from pretrain_gnns_tpu_torch.models.chem import (
    TrunkDropout, _GatParams, gcn_self_term, inv_sqrt_degree, lookup,
    sage_update,
)
from pretrain_gnns_tpu_torch.models.norm import MaskedBatchNorm
from pretrain_gnns_tpu_torch.ops import segment as seg
from pretrain_gnns_tpu_torch.ops import spmm

EDGE_FEAT_DIM = 9
SELF_LOOP_DIM = 7


def edge_inputs(g: PackedGraphs, dtype: torch.dtype) -> torch.Tensor:
    """``[edge_feat | 1]``, the edge input of every conv's encoder."""
    ef = g.edge_feat.to(dtype)
    return torch.cat([ef, torch.ones_like(ef[:, :1])], dim=1)


class _BioConv(nn.Module):
    """What every bio conv owns: the edge encoder in fused form and, in
    layer 0, the embedding of the uniform node labels. A conv creates
    them after its own layers, the reference's order."""

    def add_encoders(self, emb_dim: int, input_layer: bool,
                     edge_dim: int = 0) -> None:
        self.edge_encoder = nn.Linear(EDGE_FEAT_DIM, edge_dim or emb_dim)
        self.input_layer = input_layer
        if input_layer:
            self.input_node_embeddings = nn.Embedding(2, emb_dim)

    def embed_input(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        if not self.input_layer:
            return h
        return (inits.downcast(lookup(self.input_node_embeddings, h[:, 0]))
                * g.node_mask[:, None])

    def edge_kernel(self):
        """``(W [10, D], e_self [D])``: ``[weight^T; bias]`` and the self
        loop's embedding."""
        enc = self.edge_encoder
        return (torch.cat([enc.weight.t(), enc.bias[None]], dim=0),
                enc.weight[:, SELF_LOOP_DIM] + enc.bias)

    @staticmethod
    def aggregate(x, g: PackedGraphs, ein, W, **kw) -> torch.Tensor:
        return spmm.gather_scatter(
            x, g.senders, g.receivers, g.edge_mask, g.max_nodes,
            edge_in=ein, edge_kernel=W, block_nodes=g.block_nodes,
            block_edges=g.block_edges, **kw)


class GINConv(_BioConv):
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
        self.add_encoders(D, input_layer)

    def forward(self, h: torch.Tensor, g: PackedGraphs, ein: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = self.embed_input(h, g)
        W, e_self = self.edge_kernel()
        aggr = self.aggregate(h, g, ein, W, combine="concat")
        self_msg = torch.cat([h, e_self.to(h.dtype).expand_as(h)], dim=1)
        aggr = aggr + self_msg * g.node_mask[:, None]
        lin0, bn, _, lin3 = self.mlp
        z = torch.relu(bn(inits.dense(lin0, aggr), g.node_mask, train))
        return inits.dense(lin3, z)


class GCNConv(_BioConv):
    """GCN conv: ``Linear(D, D)``, then the symmetric-normalised sum of
    ``x_j + e`` messages with the self loop in the degree and as the term
    ``deg^-1 * (x + e_self)``."""

    def __init__(self, emb_dim: int, input_layer: bool = False):
        super().__init__()
        self.linear = nn.Linear(emb_dim, emb_dim)
        self.add_encoders(emb_dim, input_layer)

    def forward(self, h: torch.Tensor, g: PackedGraphs, ein: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = self.embed_input(h, g)
        W, e_self = self.edge_kernel()
        dis = inv_sqrt_degree(g)
        norm = dis[g.receivers.long()] * dis[g.senders.long()]
        x = inits.dense(self.linear, h)
        aggr = self.aggregate(x, g, ein, W, edge_weight=norm)
        return aggr + gcn_self_term(dis, g, x, e_self).to(aggr.dtype)


class SAGEConv(_BioConv):
    """GraphSAGE conv: ``Linear(D, D)``, the mean of the ``x_j + e``
    messages and the self loop (which counts in the denominator), then L2
    normalisation of every row."""

    def __init__(self, emb_dim: int, input_layer: bool = False):
        super().__init__()
        self.linear = nn.Linear(emb_dim, emb_dim)
        self.add_encoders(emb_dim, input_layer)

    def forward(self, h: torch.Tensor, g: PackedGraphs, ein: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = self.embed_input(h, g)
        W, e_self = self.edge_kernel()
        x = inits.dense(self.linear, h)
        return sage_update(self.aggregate(x, g, ein, W), g, x, e_self)


class GATConv(_BioConv, _GatParams):
    """GAT conv: the chem GAT layer on the encoded edge features, the self
    loop's embedding being ``edge_encoder.weight[:, 7] + bias``."""

    def __init__(self, emb_dim: int, input_layer: bool = False,
                 heads: int = 2, negative_slope: float = 0.2):
        super().__init__()
        self.add_gat_params(emb_dim, heads, negative_slope)
        self.add_encoders(emb_dim, input_layer, edge_dim=heads * emb_dim)

    def forward(self, h: torch.Tensor, g: PackedGraphs, ein: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = self.embed_input(h, g)
        return self.gat_layer(
            h, g, ein, lambda: inits.dense(self.edge_encoder, ein[:, :-1]))


CONVS = {"gin": GINConv, "gcn": GCNConv, "gat": GATConv,
         "graphsage": SAGEConv}


class GNN(nn.Module, TrunkDropout):
    """Node-representation trunk: ``num_layer`` convs of ``gnn_type`` (no
    trunk-level embeddings or batch norm), ReLU after every layer but the
    last, then dropout, padded rows zeroed after every layer, then the JK
    combination."""

    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin"):
        super().__init__()
        if num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        if gnn_type not in CONVS:
            raise NotImplementedError(
                f"bio gnn_type={gnn_type!r} is not ported")
        if jk not in ("last", "sum"):
            raise ValueError(f"bio trunk supports JK last|sum, got {jk!r}")
        self.num_layer = num_layer
        self.jk = jk
        self.drop_ratio = drop_ratio
        self.seed_dropout(0)
        self.gnns = nn.ModuleList(
            CONVS[gnn_type](emb_dim, input_layer=(layer == 0))
            for layer in range(num_layer)
        )

    def forward(self, g: PackedGraphs, train: bool = False) -> torch.Tensor:
        nmask = g.node_mask[:, None]
        # the edge inputs in the encoders' dtype (float32); layer 0 embeds
        # the labels and casts them to the activation dtype
        dtype = self.gnns[0].edge_encoder.weight.dtype
        ein = edge_inputs(g, dtype)
        h = g.node_feat.to(dtype)
        h_list = []
        for layer, conv in enumerate(self.gnns):
            h = conv(h, g, ein, train)
            if layer != self.num_layer - 1:
                h = torch.relu(h)
            h = self.dropout(h, train)
            h = h * nmask
            h_list.append(h)
        if self.jk == "last":
            return h_list[-1]
        return sum(h_list[1:], h_list[0])


class GNNGraphPred(nn.Module):
    """Graph-level prediction head: the trunk under ``gnn``, a readout
    (``graph_pooling``: sum, mean, max or attention, the last a module
    under ``pool``), the center node's representation
    (``g.extras["center_node_idx"]``, one node index per graph slot)
    concatenated to it, and ``graph_pred_linear`` from ``2 * emb_dim`` to
    ``num_tasks`` logits per graph slot."""

    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 num_tasks: int = 1, jk: str = "last",
                 drop_ratio: float = 0.0, graph_pooling: str = "mean",
                 gnn_type: str = "gin"):
        super().__init__()
        self.gnn = GNN(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        self.pool, _ = pools.make_pool(graph_pooling, emb_dim,
                                       allow_set2set=False)
        self.graph_pred_linear = nn.Linear(2 * emb_dim, num_tasks)

    def forward(self, g: PackedGraphs, train: bool = False) -> torch.Tensor:
        h = self.gnn(g, train=train)
        center = g.extras["center_node_idx"].long()
        graph_rep = torch.cat([self.pool(h, g), seg.gather_rows(h, center)],
                              dim=1)
        return inits.dense(self.graph_pred_linear, graph_rep)
