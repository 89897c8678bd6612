"""Gather -> message -> segment sum (port of the sum form of
``pretrain_gnns_tpu.ops.spmm.gather_scatter``).

For each node ``i``::

    out[i] = sum_{e : receivers[e] == i}
                 w_e * (x[senders[e]] + edge_in[e] @ edge_kernel)

with ``w_e = edge_mask[e]``. This is the plain building block of the
fused GIN conv's plain version (``ops/gin_conv.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from pretrain_gnns_tpu_torch.ops import segment as seg


def gather_scatter(
    x: torch.Tensor,  # [N, F]
    senders: torch.Tensor,  # [E] int
    receivers: torch.Tensor,  # [E] int
    edge_mask: torch.Tensor,  # [E] bool or float weights
    num_nodes: int,
    edge_in: Optional[torch.Tensor] = None,  # [E, K]
    edge_kernel: Optional[torch.Tensor] = None,  # [K, F]
) -> torch.Tensor:
    """Sum aggregation of ``x_j + edge_in @ edge_kernel`` messages."""
    msg = x.index_select(0, senders.long())
    if edge_in is not None:
        msg = msg + edge_in @ edge_kernel
    return seg.segment_sum(msg, receivers, num_nodes, mask=edge_mask)
