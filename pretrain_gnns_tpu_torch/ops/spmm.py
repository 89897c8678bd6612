"""Gather -> message -> segment sum, and the per-pair dot scores (port of
the sum forms of ``gather_scatter`` and of ``edge_dot`` of
``pretrain_gnns_tpu.ops.spmm``).

For each node ``i``::

    out[i] = sum_{e : receivers[e] == i} w_e * msg_e
    msg_e  = x[senders[e]] + edge_in[e] @ edge_kernel      (combine="add")
    msg_e  = [x[senders[e]] | edge_in[e] @ edge_kernel]    (combine="concat")

with ``w_e = edge_mask[e] * edge_weight[e]``. Dispatch: a CUDA tensor on a
block-diagonal batch goes to the fused edge-transform SpMM kernel (K2,
``ops/blocked_spmm.py``), the concat form as two calls
``[K2(x; has_x) | K2(edge_in, edge_kernel; has_ein)]``; a CUDA tensor on
any other batch raises ``ValueError``; a CPU tensor takes the plain path
:func:`gather_scatter_plain`. :func:`edge_dot` states its own dispatch."""

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
) -> torch.Tensor:
    """The plain PyTorch form of :func:`gather_scatter`, for any layout and
    device (autograd gives the backward)."""
    msg = x.index_select(0, senders.long())
    if edge_in is not None:
        e = edge_in @ edge_kernel
        if combine == "add":
            msg = msg + e
        elif combine == "concat":
            msg = torch.cat([msg, e], dim=-1)
        else:
            raise ValueError(combine)
    elif combine != "add":
        raise ValueError(f"combine={combine!r} needs edge_in")
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    return seg.segment_sum(msg, receivers, num_nodes, mask=edge_mask)


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
) -> torch.Tensor:
    """Sum aggregation of the messages; returns [N, F] ([N, 2F] for
    concat). See the module docstring for the dispatch."""
    if not x.is_cuda:
        return gather_scatter_plain(x, senders, receivers, edge_mask,
                                    num_nodes, edge_in, edge_kernel,
                                    combine, edge_weight)
    if not (block_nodes > 0 and block_edges > 0):
        raise ValueError(
            "gather_scatter on CUDA needs a block-diagonal batch "
            "(packing='blocked' or 'auto')"
        )
    if combine not in ("add", "concat"):
        raise ValueError(combine)
    fused = edge_in is not None
    if combine == "concat" and not fused:
        raise ValueError("combine='concat' needs edge_in")
    w = edge_mask.to(torch.float32)
    if edge_weight is not None:
        w = w * edge_weight
    k2 = (senders, receivers, w, block_nodes, block_edges)
    if combine == "add":
        return blocked_spmm.blocked_spmm_fused(
            x, edge_in, edge_kernel, *k2, has_x=True, has_ein=fused)
    left = blocked_spmm.blocked_spmm_fused(x, None, None, *k2, has_x=True,
                                           has_ein=False)
    # x only gives the row count here: detached, it gets no zero gradient
    right = blocked_spmm.blocked_spmm_fused(x.detach(), edge_in, edge_kernel,
                                            *k2, has_x=False, has_ein=True)
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
