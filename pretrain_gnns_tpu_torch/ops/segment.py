"""Masked segment reductions (port of ``pretrain_gnns_tpu.ops.segment``).

Every function takes an explicit ``num_segments`` and an optional validity
mask, so padded rows contribute nothing, not even to mean denominators."""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.to(data.dtype)
    return data * m.reshape(m.shape + (1,) * (data.dim() - m.dim()))


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of ``data`` rows per segment; masked rows contribute zero."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), _apply_mask(data, mask))


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    ones = (torch.ones(segment_ids.shape, dtype=dtype,
                       device=segment_ids.device)
            if mask is None else mask.to(dtype))
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean per segment over valid rows only (empty segments -> 0)."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    n = segment_count(segment_ids, num_segments, mask, dtype=s.dtype)
    n = n.reshape(n.shape + (1,) * (s.dim() - n.dim()))
    return s / torch.clamp(n, min=1.0)
