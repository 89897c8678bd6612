"""Gather -> message -> segment aggregation, and the per-pair dot scores
(port of ``gather_scatter`` and ``edge_dot`` of
``pretrain_gnns_tpu.ops.spmm``).

For each node ``i``::

    out[i] = aggr_{e : receivers[e] == i} w_e * msg_e
    msg_e  = x[senders[e]] + e_e          (combine="add")
    msg_e  = [x[senders[e]] | e_e]        (combine="concat")

with ``w_e = edge_mask[e] * edge_weight[e]``, ``aggr`` the sum or the mean
over the valid edges, and the per-edge embedding ``e_e`` either given
(``edge_emb [E, F]``) or formed as ``edge_in[e] @ edge_kernel`` (not both;
without either, ``msg_e = x[senders[e]]``).

Dispatch of :func:`gather_scatter`, as in the JAX package: only the sum on
a block-diagonal batch reaches a kernel. A CUDA tensor there goes, with
``edge_in``/``edge_kernel`` or no edge term, to the fused edge-transform
SpMM (K2, ``ops/blocked_spmm.blocked_spmm_fused``), the concat form as two
calls ``[K2(x; has_x) | K2(edge_in, edge_kernel; has_ein)]``; with
``edge_emb``, to the blocked SpMM on a precomputed edge embedding (K6,
``ops/blocked_spmm.blocked_spmm``), the concat form as
``[K2(x; has_x) | K6(zeros, edge_emb)]``. ``aggr="mean"`` takes the plain
path on either device, whatever the layout. A CUDA tensor with
``aggr="sum"`` on any other batch raises ``ValueError``; a CPU tensor takes
the plain path :func:`gather_scatter_plain`. :func:`edge_dot` states its
own dispatch."""

from __future__ import annotations

from typing import Optional

import torch

from pretrain_gnns_tpu_torch.ops import blocked_spmm
from pretrain_gnns_tpu_torch.ops import edge_dot as edge_dot_ops
from pretrain_gnns_tpu_torch.ops import segment as seg


def gather_scatter_plain(
    x: torch.Tensor,  # [N, F]
    senders: torch.Tensor,  # [E] int
    receivers: torch.Tensor,  # [E] int
    edge_mask: torch.Tensor,  # [E] bool or float weights
    num_nodes: int,
    edge_in: Optional[torch.Tensor] = None,  # [E, K]
    edge_kernel: Optional[torch.Tensor] = None,  # [K, F]
    combine: str = "add",
    edge_weight: Optional[torch.Tensor] = None,  # [E]
    edge_emb: Optional[torch.Tensor] = None,  # [E, F]
    aggr: str = "sum",
) -> torch.Tensor:
    """The plain PyTorch form of :func:`gather_scatter`, for any layout and
    device (autograd gives the backward)."""
    if edge_in is not None and edge_emb is not None:
        raise ValueError("give edge_emb or edge_in/edge_kernel, not both")
    msg = x.index_select(0, senders.long())
    e = edge_in @ edge_kernel if edge_in is not None else edge_emb
    if e is not None:
        if combine == "add":
            msg = msg + e
        elif combine == "concat":
            msg = torch.cat([msg, e], dim=-1)
        else:
            raise ValueError(combine)
    elif combine != "add":
        raise ValueError(f"combine={combine!r} needs edge_in or edge_emb")
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    if aggr == "sum":
        return seg.segment_sum(msg, receivers, num_nodes, mask=edge_mask)
    if aggr == "mean":
        return seg.segment_mean(msg, receivers, num_nodes, mask=edge_mask)
    raise ValueError(aggr)


def gather_scatter(
    x: torch.Tensor,  # [N, F]
    senders: torch.Tensor,  # [E] int32
    receivers: torch.Tensor,  # [E] int32
    edge_mask: torch.Tensor,  # [E] bool
    num_nodes: int,
    edge_in: Optional[torch.Tensor] = None,  # [E, K]
    edge_kernel: Optional[torch.Tensor] = None,  # [K, F]
    combine: str = "add",  # "add" | "concat"
    edge_weight: Optional[torch.Tensor] = None,  # [E]
    block_nodes: int = 0,
    block_edges: int = 0,
    edge_emb: Optional[torch.Tensor] = None,  # [E, F]
    aggr: str = "sum",  # "sum" | "mean"
) -> torch.Tensor:
    """Aggregation of the messages; returns [N, F] ([N, F + F_e] for
    concat). See the module docstring for the dispatch."""
    fused = edge_in is not None
    if fused and edge_emb is not None:
        raise ValueError("give edge_emb or edge_in/edge_kernel, not both")
    if aggr not in ("sum", "mean"):
        raise ValueError(aggr)
    if not x.is_cuda or aggr == "mean":
        return gather_scatter_plain(x, senders, receivers, edge_mask,
                                    num_nodes, edge_in, edge_kernel,
                                    combine, edge_weight, edge_emb, aggr)
    if not (block_nodes > 0 and block_edges > 0):
        raise ValueError(
            "gather_scatter on CUDA needs a block-diagonal batch "
            "(packing='blocked' or 'auto')"
        )
    if combine not in ("add", "concat"):
        raise ValueError(combine)
    if combine == "concat" and not fused and edge_emb is None:
        raise ValueError("combine='concat' needs edge_in or edge_emb")
    w = edge_mask.to(torch.float32)
    if edge_weight is not None:
        w = w * edge_weight
    graph = (senders, receivers, w, block_nodes, block_edges)
    if combine == "add" and edge_emb is not None:
        return blocked_spmm.blocked_spmm(x, edge_emb, *graph)
    if combine == "add":
        return blocked_spmm.blocked_spmm_fused(
            x, edge_in, edge_kernel, *graph, has_x=True, has_ein=fused)
    left = blocked_spmm.blocked_spmm_fused(x, None, None, *graph, has_x=True,
                                           has_ein=False)
    if fused:
        # x only gives the row count here: detached, it gets no zero
        # gradient
        right = blocked_spmm.blocked_spmm_fused(
            x.detach(), edge_in, edge_kernel, *graph, has_x=False,
            has_ein=True)
    else:
        # the edge embedding alone, aggregated over an all-zero x of its
        # width, which asks for no gradient
        zeros = x.new_zeros((x.shape[0], edge_emb.shape[1]))
        right = blocked_spmm.blocked_spmm(zeros, edge_emb, *graph)
    return torch.cat([left, right], dim=-1)


def edge_dot(
    x: torch.Tensor,  # [N, F]
    a_idx: torch.Tensor,  # [P] int32
    b_idx: torch.Tensor,  # [P] int32
    mask: torch.Tensor,  # [P] bool
    block_nodes: int = 0,
    pairs_per_block: int = 0,
) -> torch.Tensor:
    """Masked per-pair dot scores ``mask * <x[a], x[b]>``, the scoring
    head of edge prediction. Dispatch: a CPU tensor takes the plain
    version, whatever the layout; a CUDA tensor with a block-aligned pair
    list (``block_nodes``, ``pairs_per_block`` > 0) goes to the blocked
    pair-dot kernel (K3, ``ops/edge_dot.py``); a CUDA tensor with an
    unblocked pair list raises ``ValueError``, as :func:`gather_scatter`
    does. (The JAX package scores such a list, the compact negatives,
    through two gathers; on the card every loader gives block-aligned
    pairs.)"""
    w = mask.to(torch.float32)
    if not x.is_cuda:
        return edge_dot_ops.edge_dot_plain(x, a_idx, b_idx, w)
    if not (block_nodes > 0 and pairs_per_block > 0):
        raise ValueError(
            "edge_dot on CUDA needs a block-aligned pair list "
            "(packing='blocked' or 'auto')"
        )
    return edge_dot_ops.blocked_edge_dot(x, a_idx, b_idx, w, block_nodes,
                                         pairs_per_block)
