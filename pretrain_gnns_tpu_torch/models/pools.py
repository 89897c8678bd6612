"""Graph-level readouts over packed batches (port of
``pretrain_gnns_tpu.models.pools``; there they replace PyG's
``global_{add,mean,max}_pool``, ``GlobalAttention`` and ``Set2Set``).

All readouts are mask-aware: padded nodes contribute nothing, mean
denominators count valid nodes only, and a graph slot without nodes gets
0. They are plain tensor code on either device, as they are plain XLA in
the JAX package.

Parameter names follow the JAX package's (``gate_nn``; ``lstm.weight_ih``,
``lstm.weight_hh``, ``lstm.bias_ih``, ``lstm.bias_hh``), and the LSTM
weights keep its ``[in, 4H]`` layout, so
``compat/from_jax.state_dict_from_jax`` carries them over as they are."""

from __future__ import annotations

import math

import torch
from torch import nn

from pretrain_gnns_tpu_torch.core.graphs import PackedGraphs
from pretrain_gnns_tpu_torch.models import inits
from pretrain_gnns_tpu_torch.ops import segment as seg


def _membership(h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
    """``[G, N]``: 1 where valid node n lies in graph slot G, in ``h``'s
    dtype."""
    slots = torch.arange(g.max_graphs, device=h.device)
    hot = (g.node_graph.long()[None, :] == slots[:, None]) & (
        g.node_mask.bool()[None, :])
    return hot.to(h.dtype)


def sum_pool(h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
    """Each graph slot's sum of its valid rows, as the product
    ``membership @ h``: a GEMM over the batch's few hundred slots, which
    sums in the same order every run (forward and backward) on either
    device, where ``index_add`` sums with atomics on CUDA and a sorted
    ``index_put`` walks each slot's rows one after another."""
    return _membership(h, g) @ h


def mean_pool(h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
    hot = _membership(h, g)
    return (hot @ h) / torch.clamp(hot.sum(dim=1, keepdim=True), min=1.0)


def max_pool(h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
    return seg.segment_max(h, g.node_graph, g.max_graphs, mask=g.node_mask,
                           empty_value=0.0)


class GlobalAttentionPool(nn.Module):
    """PyG ``GlobalAttention`` with ``gate_nn = Linear(D, 1)``: a softmax
    of the gate over each graph's nodes, then the weighted sum."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.gate_nn = nn.Linear(in_dim, 1)

    def forward(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        gate = inits.dense(self.gate_nn, h)  # [N, 1]
        a = seg.segment_softmax(gate, g.node_graph, g.max_graphs,
                                mask=g.node_mask)
        return seg.segment_sum(a * h, g.node_graph, g.max_graphs,
                               mask=g.node_mask)


class TorchLSTMCell(nn.Module):
    """An LSTM cell with ``nn.LSTM``'s init (every parameter
    U(-1/sqrt(H), 1/sqrt(H))) and gate order i, f, g, o, its weights stored
    ``[in, 4H]`` as the JAX package stores them. The carry is ``(c, h)``."""

    def __init__(self, hidden: int, in_dim: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(in_dim, 4 * hidden))
        self.weight_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih,
                  self.bias_hh):
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, carry, x):
        c, h = carry
        # bfloat16 inputs widen to the weights' float32, as jnp promotes
        dt = self.weight_ih.dtype
        z = x.to(dt) @ self.weight_ih + self.bias_ih \
            + h.to(dt) @ self.weight_hh + self.bias_hh
        i, f, gg, o = torch.chunk(z, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (c_new, h_new), h_new


class Set2SetPool(nn.Module):
    """PyG ``Set2Set(in_dim, processing_steps)``: an LSTM-driven attention
    readout; the output is ``2 * in_dim`` wide."""

    def __init__(self, in_dim: int, processing_steps: int):
        super().__init__()
        self.in_dim = in_dim
        self.processing_steps = processing_steps
        self.lstm = TorchLSTMCell(in_dim, 2 * in_dim)

    def forward(self, h: torch.Tensor, g: PackedGraphs) -> torch.Tensor:
        B = g.max_graphs
        q_star = h.new_zeros((B, 2 * self.in_dim))
        carry = (h.new_zeros((B, self.in_dim)), h.new_zeros((B, self.in_dim)))
        ids = g.node_graph.long()
        for _ in range(self.processing_steps):
            carry, q = self.lstm(carry, q_star)
            e = (h * seg.gather_rows(q, ids)).sum(dim=-1, keepdim=True)
            a = seg.segment_softmax(e, g.node_graph, B, mask=g.node_mask)
            r = seg.segment_sum(a * h, g.node_graph, B, mask=g.node_mask)
            q_star = torch.cat([q, r], dim=-1)
        return q_star


def make_pool(graph_pooling: str, dim: int, allow_set2set: bool = True):
    """``(readout, output width)`` for a ``graph_pooling`` name: one of the
    functions above for ``sum``, ``mean`` and ``max``, a module for
    ``attention`` and ``set2setN`` (N processing steps)."""
    plain = {"sum": sum_pool, "mean": mean_pool, "max": max_pool}
    if graph_pooling in plain:
        return plain[graph_pooling], dim
    if graph_pooling == "attention":
        return GlobalAttentionPool(dim), dim
    if (allow_set2set and graph_pooling[:-1] == "set2set"
            and graph_pooling[-1].isdigit()):
        return Set2SetPool(dim, int(graph_pooling[-1])), 2 * dim
    raise ValueError("Invalid graph pooling type.")
