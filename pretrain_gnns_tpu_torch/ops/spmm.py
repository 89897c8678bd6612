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
own dispatch.

The kernels' compute dtype is a knob, as the JAX package's
(``PGT_SPMM_DTYPE``, :func:`set_compute_dtype`): ``"float32"`` or
``"bfloat16"``, where a kernel rounds its operands to bfloat16 at the
points the Pallas kernel does and sums in float32. It reaches every kernel
(K1-K7) on CUDA tensors only (:func:`kernel_dtype`); the plain path on the
CPU ignores it and follows torch's dtype promotion, as the JAX package's
XLA fallback does. The default is ``"bfloat16"``, the JAX package's;
``PGT_SPMM_DTYPE=float32`` gives the float32 kernels."""

from __future__ import annotations

import os
from typing import Optional

import torch

from pretrain_gnns_tpu_torch.ops import blocked_spmm
from pretrain_gnns_tpu_torch.ops import edge_dot as edge_dot_ops
from pretrain_gnns_tpu_torch.ops import segment as seg

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _checked(name: str) -> str:
    if name not in _DTYPES:
        raise ValueError(f"kernel compute dtype must be one of "
                         f"{tuple(_DTYPES)}, got {name!r}")
    return name


_DTYPE = _checked(os.environ.get("PGT_SPMM_DTYPE", "bfloat16"))


def set_compute_dtype(name: str) -> None:
    """Set the kernels' compute dtype: ``"float32"`` or ``"bfloat16"``;
    anything else raises ``ValueError``."""
    global _DTYPE
    _DTYPE = _checked(name)


def get_compute_dtype() -> str:
    return _DTYPE


def kernel_dtype(x: torch.Tensor) -> torch.dtype:
    """The compute dtype a kernel gets for rows ``x``: the knob's on a CUDA
    tensor, float32 on the CPU (where the plain path ignores the knob)."""
    return _DTYPES[_DTYPE] if x.is_cuda else torch.float32


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
    return blocked_gather_scatter(
        x, senders, receivers, edge_mask, edge_in, edge_kernel, combine,
        edge_weight, block_nodes, block_edges, edge_emb, kernel_dtype(x))


def blocked_gather_scatter(
    x: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_in: Optional[torch.Tensor],
    edge_kernel: Optional[torch.Tensor],
    combine: str,
    edge_weight: Optional[torch.Tensor],
    block_nodes: int,
    block_edges: int,
    edge_emb: Optional[torch.Tensor],
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The sum of :func:`gather_scatter` on a block-diagonal batch through
    the kernels' wrappers (K2, K6) at ``compute_dtype``: their kernels on
    CUDA tensors, their plain versions on CPU tensors (a reference that
    rounds as the card's kernels do)."""
    fused = edge_in is not None
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
        return blocked_spmm.blocked_spmm(x, edge_emb, *graph, compute_dtype)
    if combine == "add":
        return blocked_spmm.blocked_spmm_fused(
            x, edge_in, edge_kernel, *graph, has_x=True, has_ein=fused,
            compute_dtype=compute_dtype)
    left = blocked_spmm.blocked_spmm_fused(
        x, None, None, *graph, has_x=True, has_ein=False,
        compute_dtype=compute_dtype)
    if fused:
        # x only gives the row count and the output's dtype here: detached,
        # it gets no zero gradient
        right = blocked_spmm.blocked_spmm_fused(
            x.detach(), edge_in, edge_kernel, *graph, has_x=False,
            has_ein=True, compute_dtype=compute_dtype)
    else:
        # the edge embedding alone, aggregated over an all-zero x of its
        # width, which asks for no gradient
        zeros = x.new_zeros((x.shape[0], edge_emb.shape[1]))
        right = blocked_spmm.blocked_spmm(zeros, edge_emb, *graph,
                                          compute_dtype)
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
                                         pairs_per_block, kernel_dtype(x))
