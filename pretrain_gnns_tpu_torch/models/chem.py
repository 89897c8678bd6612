"""Chem trunk and graph-level head (port of ``GINConv``, ``GCNConv``,
``GATConv``, ``SAGEConv``, ``GNN`` and ``GNNGraphPred`` of
``pretrain_gnns_tpu.models.chem``).

The self-loop the reference appends inside every conv (bond type 4,
direction 0) is added analytically: ``aggr += (x + e_self) * node_mask``.
Bond embeddings go to the fused GIN conv in one-hot form: ``ein = [
one_hot(bond, 6) | one_hot(dir, 3)]`` and ``We = [e1; e2]``, so that
``ein @ We == e1[bond] + e2[dir]``. GIN runs as one fused GIN conv call
(K1 on CUDA) or, under ``ops/gin_conv.set_fused("off")``, as an
aggregation followed by its MLP; that aggregation and those of GCN and
GraphSAGE go through ``ops/spmm.gather_scatter`` with
``edge_in``/``edge_kernel`` (the fused edge-transform SpMM K2 on CUDA, its
``x + ein`` variant). GAT runs as one
fused GAT conv call (K4 on CUDA) or, under
``ops/gat_conv.set_fused("off")``, as ``weight_linear``, the embedding sum
and the GAT attention (K5 on CUDA); its self loop is one more logit per
node inside the softmax.

Module and parameter names follow the reference state dict
(``x_embedding1``, ``gnns.{k}.mlp.{0,2}``, ``gnns.{k}.linear`` or
``gnns.{k}.weight_linear`` with ``gnns.{k}.att`` and ``gnns.{k}.bias``,
``gnns.{k}.edge_embedding{1,2}``, ``batch_norms.{k}``; the head adds
``gnn.*``, ``pool.*`` and ``graph_pred_linear``).

Under the mixed-precision knob of ``models.inits`` activations flow in
bfloat16 (``bfloat16_act``) from the trunk's input on; the bond one-hots,
edge weights and tables stay float32, the dense layers go through
``inits.dense``, the self terms are cast as the JAX package casts them,
and the kernels get the compute dtype of ``ops.spmm.kernel_dtype``. GAT's
attention takes float32 rows, as in the JAX package.

Dropout (``drop_ratio``) follows every layer's ReLU in train mode, before
the padded rows are zeroed. Its masks come from a ``torch.Generator`` on
the activations' device, seeded by :meth:`TrunkDropout.seed_dropout`, so a
seed fixes them on a given device."""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import inits, pools
from pretrain_gnns_tpu_torch.models.norm import MaskedBatchNorm
from pretrain_gnns_tpu_torch.ops import attention, gat_conv, gin_conv, spmm
from pretrain_gnns_tpu_torch.ops import segment as seg

NUM_ATOM_TYPE = 120  # incl. the mask token 119
NUM_CHIRALITY_TAG = 3
NUM_BOND_TYPE = 6  # incl. self-loop 4 and mask token 5
NUM_BOND_DIRECTION = 3
SELF_LOOP_BOND_TYPE = 4


def bond_one_hot(g: PackedGraphs, dtype: torch.dtype) -> torch.Tensor:
    """``ein [E, 9]``: the bond type and direction of every edge slot, one
    hot. By comparison: ``F.one_hot`` checks its input's range on the
    host, a device synchronisation per call on CUDA."""
    ef = g.edge_feat
    return torch.cat([
        ef[:, :1] == torch.arange(NUM_BOND_TYPE, device=ef.device),
        ef[:, 1:2] == torch.arange(NUM_BOND_DIRECTION, device=ef.device),
    ], dim=1).to(dtype)


def lookup(emb: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
    """``emb(idx)`` as the product ``one_hot(idx) @ emb.weight``: the same
    rows exactly (one nonzero term a row), and a weight gradient
    ``one_hot^T @ g`` that the GEMM sums in the same order every run.
    ``nn.Embedding``'s backward sums with atomics on CUDA, so that two runs
    of a step would differ in the last bits, and a sorted index backward
    walks each row's occurrences one after another: thousands for the few
    rows these tables have."""
    hot = idx.long()[:, None] == torch.arange(emb.num_embeddings,
                                              device=idx.device)
    return hot.to(emb.weight.dtype) @ emb.weight


def inv_sqrt_degree(g: PackedGraphs) -> torch.Tensor:
    """GCN's ``deg^-1/2`` per node, the self loop counted; 0 where the
    degree is 0 (padded rows), the reference's inf -> 0 clamp."""
    deg = g.in_degree(include_self_loop=True).to(torch.float32)
    pos = deg > 0
    return torch.where(pos, torch.where(pos, deg, 1.0) ** -0.5, 0.0)


def gcn_self_term(dis: torch.Tensor, g: PackedGraphs, x: torch.Tensor,
                  e_self: torch.Tensor) -> torch.Tensor:
    """GCN's self loop, ``deg^-1 * (x + e_self)`` on valid rows, in
    float32 (the JAX package casts it to the aggregation's dtype)."""
    return (dis * dis * g.node_mask)[:, None] * (seg.at_least_f32(x) + e_self)


def sage_update(s: torch.Tensor, g: PackedGraphs, x: torch.Tensor,
                e_self: torch.Tensor) -> torch.Tensor:
    """GraphSAGE after the aggregation ``s``: the self loop added, the mean
    over the degree with the self loop, L2-normalised rows, computed in
    float32 and returned in ``s``'s dtype."""
    s = s + (x + e_self.to(x.dtype)) * g.node_mask[:, None]
    deg = g.in_degree(include_self_loop=True).to(torch.float32)
    mean = seg.at_least_f32(s) / torch.clamp(deg, min=1.0)[:, None]
    return l2_normalize_rows(mean).to(s.dtype)


def l2_normalize_rows(mean: torch.Tensor) -> torch.Tensor:
    """``F.normalize(mean, dim=-1)`` with all-zero rows left 0. The double
    ``where`` keeps ``sqrt``'s infinite slope at 0 out of the backward:
    a padded row's zero cotangent times inf would be NaN and poison every
    gradient."""
    sq = mean.square().sum(dim=-1, keepdim=True)
    pos = sq > 0
    norm = torch.where(pos, sq, 1.0).sqrt()
    return torch.where(pos, mean / torch.clamp(norm, min=1e-12), 0.0)


class _ChemConv(nn.Module):
    """The bond embedding tables every chem conv owns, in fused form. A
    conv creates them after its own layers, the reference's order."""

    def add_edge_embeddings(self, emb_dim: int) -> None:
        self.edge_embedding1 = nn.Embedding(NUM_BOND_TYPE, emb_dim)
        self.edge_embedding2 = nn.Embedding(NUM_BOND_DIRECTION, emb_dim)

    def edge_kernel(self):
        """``(We [9, D], e_self [D])``: the stacked tables and the self
        loop's embedding (bond type 4, direction 0)."""
        e1 = self.edge_embedding1.weight
        e2 = self.edge_embedding2.weight
        return torch.cat([e1, e2], dim=0), e1[SELF_LOOP_BOND_TYPE] + e2[0]


class GINConv(_ChemConv):
    """GIN conv: sum of ``x_j + e`` messages plus the self loop, then the
    MLP Linear(D, 2D) -> ReLU -> Linear(2D, D), as one fused GIN conv call
    or, under ``ops/gin_conv.set_fused("off")``, as ``gather_scatter``, the
    self term and ``self.mlp`` (the same parameters either way). On CUDA
    the batch must have the block-diagonal layout."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Linear(emb_dim, 2 * emb_dim), nn.ReLU(),
            nn.Linear(2 * emb_dim, emb_dim),
        )
        self.add_edge_embeddings(emb_dim)

    def conv_inputs(self, h: torch.Tensor, g: PackedGraphs) -> tuple:
        """The arguments of ``gin_conv.fused_gin_conv`` for this layer but
        the compute dtype: the bond one-hots in the tables' dtype and the
        edge weights in float32, whatever ``h``'s."""
        We, e_self = self.edge_kernel()
        ein = bond_one_hot(g, We.dtype)
        lin0, lin2 = self.mlp[0], self.mlp[2]
        return (h, ein, We, e_self, lin0.weight.t(), lin0.bias,
                lin2.weight.t(), lin2.bias, g.senders, g.receivers,
                g.edge_mask.to(torch.float32), g.node_mask, g.block_nodes,
                g.block_edges)

    def forward(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        blocked = g.block_nodes > 0 and g.block_edges > 0
        if h.is_cuda and not blocked:
            raise ValueError(
                "GINConv on CUDA needs a block-diagonal batch "
                "(packing='blocked' or 'auto')"
            )
        if gin_conv.fused_enabled():
            return gin_conv.fused_gin_conv(
                *self.conv_inputs(h, g), compute_dtype=spmm.kernel_dtype(h))
        We, e_self = self.edge_kernel()
        aggr = spmm.gather_scatter(
            h, g.senders, g.receivers, g.edge_mask, g.max_nodes,
            edge_in=bond_one_hot(g, We.dtype), edge_kernel=We,
            block_nodes=g.block_nodes, block_edges=g.block_edges,
        )
        aggr = aggr + (h + e_self.to(h.dtype)) * g.node_mask[:, None]
        lin0, _, lin2 = self.mlp
        return inits.dense(lin2, torch.relu(inits.dense(lin0, aggr)))


class GCNConv(_ChemConv):
    """GCN conv: ``Linear(D, D)``, then the symmetric-normalised sum of
    ``x_j + e`` messages with the self loop in the degree and as the term
    ``deg^-1 * (x + e_self)``. On CUDA the batch must have the
    block-diagonal layout (``gather_scatter`` raises otherwise)."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.linear = nn.Linear(emb_dim, emb_dim)
        self.add_edge_embeddings(emb_dim)

    def forward(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        We, e_self = self.edge_kernel()
        dis = inv_sqrt_degree(g)
        norm = dis[g.receivers.long()] * dis[g.senders.long()]
        x = inits.dense(self.linear, h)
        aggr = spmm.gather_scatter(
            x, g.senders, g.receivers, g.edge_mask, g.max_nodes,
            edge_in=bond_one_hot(g, We.dtype), edge_kernel=We,
            edge_weight=norm, block_nodes=g.block_nodes,
            block_edges=g.block_edges,
        )
        return aggr + gcn_self_term(dis, g, x, e_self).to(aggr.dtype)


class SAGEConv(_ChemConv):
    """GraphSAGE conv: ``Linear(D, D)``, the mean of the ``x_j + e``
    messages and the self loop (which counts in the denominator), then L2
    normalisation of every row."""

    def __init__(self, emb_dim: int):
        super().__init__()
        self.linear = nn.Linear(emb_dim, emb_dim)
        self.add_edge_embeddings(emb_dim)

    def forward(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        We, e_self = self.edge_kernel()
        x = inits.dense(self.linear, h)
        s = spmm.gather_scatter(
            x, g.senders, g.receivers, g.edge_mask, g.max_nodes,
            edge_in=bond_one_hot(g, We.dtype), edge_kernel=We,
            block_nodes=g.block_nodes, block_edges=g.block_edges,
        )
        return sage_update(s, g, x, e_self)


class _GatParams:
    """What a GAT conv owns beside its edge embedding: ``weight_linear``
    (D -> H*D), the attention vector ``att`` [1, H, 2D] (``a_i`` its first
    half, ``a_j`` its second) and the output ``bias`` [D]; and the layer
    itself, shared by the chem and bio convs."""

    def add_gat_params(self, emb_dim: int, heads: int,
                       negative_slope: float) -> None:
        self.emb_dim, self.heads = emb_dim, heads
        self.negative_slope = negative_slope
        self.weight_linear = nn.Linear(emb_dim, heads * emb_dim)
        self.att = nn.Parameter(inits.pyg_glorot((1, heads, 2 * emb_dim)))
        self.bias = nn.Parameter(torch.zeros(emb_dim))

    def gat_layer(self, h: torch.Tensor, g: PackedGraphs, ein: torch.Tensor,
                  edge_embedding) -> torch.Tensor:
        """``ein`` [E, K] and ``self.edge_kernel()`` feed the fused conv;
        ``edge_embedding()`` gives the unfused path its ``[E, H*D]``."""
        H, D = self.heads, self.emb_dim
        blocked = g.block_nodes > 0 and g.block_edges > 0
        if h.is_cuda and not blocked:
            raise ValueError(
                "GATConv on CUDA needs a block-diagonal batch "
                "(packing='blocked' or 'auto')"
            )
        We, e_self = self.edge_kernel()
        e_self = e_self.reshape(H, D)
        a_i, a_j = self.att[0, :, :D], self.att[0, :, D:]
        lin = self.weight_linear
        cdt = spmm.kernel_dtype(h)
        if gat_conv.fused_enabled():
            return gat_conv.fused_gat_conv(
                seg.at_least_f32(h), lin.weight.t(), lin.bias, ein, We,
                e_self, a_i, a_j, self.bias, g.senders, g.receivers,
                g.edge_mask.to(torch.float32), H, g.block_nodes,
                g.block_edges, self.negative_slope, compute_dtype=cdt)
        # the attention in float32 (logit stability), as in the JAX package
        x = seg.at_least_f32(inits.dense(lin, h))
        out = attention.gat_attention(
            x.reshape(-1, H, D), edge_embedding().reshape(-1, H, D),
            e_self, a_i[None], a_j[None], g.senders, g.receivers,
            g.edge_mask, g.max_nodes, self.negative_slope,
            block_nodes=g.block_nodes, block_edges=g.block_edges,
            compute_dtype=cdt)
        return out.mean(dim=1) + self.bias  # head mean


class GATConv(_ChemConv, _GatParams):
    """GAT conv: ``Linear(D, H*D)``, additive attention over the ``x_j +
    e`` messages and the self loop (segment softmax over the receivers),
    head mean, ``+ bias``. On CUDA the batch must have the block-diagonal
    layout."""

    def __init__(self, emb_dim: int, heads: int = 2,
                 negative_slope: float = 0.2):
        super().__init__()
        self.add_gat_params(emb_dim, heads, negative_slope)
        self.add_edge_embeddings(heads * emb_dim)

    def forward(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        ef = g.edge_feat
        return self.gat_layer(
            h, g, bond_one_hot(g, torch.float32),
            lambda: (lookup(self.edge_embedding1, ef[:, 0])
                     + lookup(self.edge_embedding2, ef[:, 1])))


CONVS = {"gin": GINConv, "gcn": GCNConv, "gat": GATConv,
         "graphsage": SAGEConv}


class TrunkDropout:
    """The trunks' dropout: inverted dropout with rate ``drop_ratio`` in
    train mode, the identity otherwise. The keep masks are drawn from a
    generator of the tensor's device, created at first use from the seed
    that :meth:`seed_dropout` set (a trunk's ``__init__`` sets 0)."""

    drop_ratio: float = 0.0

    def seed_dropout(self, seed: int) -> None:
        """Start the dropout masks over from ``seed``, on every device."""
        self._dropout_seed = int(seed)
        self._dropout_generators = {}

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        """The generator of the masks on ``device`` (with its index, as a
        tensor's ``device`` gives it), made from the seed at first use. A
        CUDA graph that captures the trunk registers it
        (``train/graphed.py``), so that each replay draws the masks that
        eager steps would."""
        gen = self._dropout_generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(self._dropout_seed)
            self._dropout_generators[device] = gen
        return gen

    def dropout_states(self) -> Dict[str, torch.Tensor]:
        """The state of each mask generator made so far, by device
        (``"cpu"``, ``"cuda:0"``); a generator that a CUDA graph registered
        gives its state after the graph's replays."""
        return {str(dev): gen.get_state()
                for dev, gen in self._dropout_generators.items()}

    def load_dropout_states(self, states: Mapping[str, torch.Tensor],
                            device) -> None:
        """Restart the masks from the seed, then set the generators of
        ``device``'s type from ``states`` (:meth:`dropout_states`). Another
        type's generator draws other masks from the same state, so a state
        of another type is left out: such a device's masks start from the
        seed. A state read onto the card goes back to the host, where a
        generator keeps it."""
        self.seed_dropout(self._dropout_seed)
        kind = torch.device(device).type
        for name, state in states.items():
            if torch.device(name).type == kind:
                self.dropout_generator(torch.device(name)).set_state(
                    state.cpu())

    def draws(self) -> bool:
        """Whether a captured step draws from this generator, so that a
        CUDA graph must register it."""
        return self.drop_ratio > 0

    def dropout(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        p = self.drop_ratio
        if not train or p <= 0:
            return h
        if p >= 1:
            return torch.zeros_like(h)
        gen = self.dropout_generator(h.device)
        keep = torch.rand(h.shape, generator=gen, device=h.device) >= p
        return torch.where(keep, h / (1.0 - p), 0.0)


class MaskStream(TrunkDropout):
    """An objective's ``mask`` stream: the generator of what its step
    draws on the device (the masked atoms, the negative pairs), one a
    device, made from the seed at first use. It is kept, checkpointed and
    registered with a CUDA graph as a trunk's dropout generator is; it
    draws no dropout (its rate stays 0). :meth:`seed_masks` seeds it."""

    def seed_masks(self, seed: int) -> None:
        self.seed_dropout(seed)

    def mask_generator(self, device) -> torch.Generator:
        return self.dropout_generator(torch.device(device))

    def draws(self) -> bool:
        # made by an eager step before any capture, if the step draws
        return bool(self._dropout_generators)


class GNN(nn.Module, TrunkDropout):
    """Node-representation trunk: atom embeddings, ``num_layer`` convs of
    ``gnn_type`` each followed by masked BatchNorm (and ReLU except after
    the last) and dropout, padded rows zeroed after every layer, then the
    JK combination."""

    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 jk: str = "last", drop_ratio: float = 0.0,
                 gnn_type: str = "gin"):
        super().__init__()
        if num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        if gnn_type not in CONVS:
            raise NotImplementedError(f"gnn_type={gnn_type!r} is not ported")
        if jk not in ("last", "concat", "max", "sum"):
            raise ValueError(f"unknown JK mode {jk!r}")
        self.num_layer = num_layer
        self.jk = jk
        self.drop_ratio = drop_ratio
        self.seed_dropout(0)
        self.x_embedding1 = nn.Embedding(NUM_ATOM_TYPE, emb_dim)
        self.x_embedding2 = nn.Embedding(NUM_CHIRALITY_TAG, emb_dim)
        self.gnns = nn.ModuleList(
            CONVS[gnn_type](emb_dim) for _ in range(num_layer))
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(emb_dim) for _ in range(num_layer)
        )

    def forward(self, g: PackedGraphs, train: bool = False) -> torch.Tensor:
        nmask = g.node_mask[:, None]
        x = (lookup(self.x_embedding1, g.node_feat[:, 0])
             + lookup(self.x_embedding2, g.node_feat[:, 1]))
        # padded rows exactly zero; activations flow in the compute dtype
        h = inits.downcast(x * nmask)
        h_list = [h]
        for layer in range(self.num_layer):
            h = self.gnns[layer](h, g)
            h = self.batch_norms[layer](h, g.node_mask, train)
            if layer != self.num_layer - 1:
                h = torch.relu(h)
            h = self.dropout(h, train)
            h = h * nmask
            h_list.append(h)
        if self.jk == "last":
            return h_list[-1]
        if self.jk == "concat":
            return torch.cat(h_list, dim=1)
        stack = torch.stack(h_list, dim=0)
        if self.jk == "max":
            return stack.max(dim=0).values
        return stack.sum(dim=0)


class GNNGraphPred(nn.Module):
    """Graph-level prediction head: the trunk under ``gnn``, a readout
    (``graph_pooling``: sum, mean, max, attention or set2setN; a module
    under ``pool`` for the last two) and ``graph_pred_linear`` to
    ``num_tasks`` logits per graph slot."""

    def __init__(self, num_layer: int = 5, emb_dim: int = 300,
                 num_tasks: int = 1, jk: str = "last",
                 drop_ratio: float = 0.0, graph_pooling: str = "mean",
                 gnn_type: str = "gin"):
        super().__init__()
        self.gnn = GNN(num_layer, emb_dim, jk, drop_ratio, gnn_type)
        self.pool, d = pools.make_pool(graph_pooling, self.jk_dim())
        self.graph_pred_linear = nn.Linear(d, num_tasks)

    def jk_dim(self) -> int:
        mult = self.gnn.num_layer + 1 if self.gnn.jk == "concat" else 1
        return mult * self.gnn.x_embedding1.embedding_dim

    def forward(self, g: PackedGraphs, train: bool = False) -> torch.Tensor:
        h = self.gnn(g, train=train)
        return inits.dense(self.graph_pred_linear, self.pool(h, g))
