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


_NEG_INF = -1e30


def _segment_amax(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Max per segment; ``-inf`` for a segment without rows."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax")


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    empty_value: float = 0.0,
) -> torch.Tensor:
    """Max per segment over valid rows; empty segments get ``empty_value``."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
        data = torch.where(m.bool(), data, data.new_tensor(_NEG_INF))
    out = _segment_amax(data, segment_ids, num_segments)
    return torch.where(out <= _NEG_INF / 2, out.new_tensor(empty_value), out)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    extra_logit: Optional[torch.Tensor] = None,
):
    """Numerically stable softmax within each segment (GAT attention).

    ``extra_logit``: optional ``[num_segments, ...]`` per-segment logit that
    takes part in the normaliser but is not among the rows (the self loop).
    When given, returns ``(probs_for_rows, probs_for_extra)``. Masked rows
    get probability 0; the denominator is clamped at ``1e-16``. The shift by
    the segment maximum is detached: a softmax does not depend on it."""
    ids = segment_ids.long()
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (logits.dim() - mask.dim()))
        logits = torch.where(m.bool(), logits, logits.new_tensor(_NEG_INF))
    seg_max = _segment_amax(logits, ids, num_segments)
    if extra_logit is not None:
        seg_max = torch.maximum(seg_max, extra_logit)
    # empty segments: avoid -inf
    seg_max = torch.clamp(seg_max, min=_NEG_INF).detach()
    exp = torch.exp(logits - seg_max.index_select(0, ids))
    exp = _apply_mask(exp, mask)
    denom = segment_sum(exp, ids, num_segments)
    if extra_logit is not None:
        exp_extra = torch.exp(extra_logit - seg_max)
        denom = torch.clamp(denom + exp_extra, min=1e-16)
        return exp / denom.index_select(0, ids), exp_extra / denom
    denom = torch.clamp(denom, min=1e-16)
    return exp / denom.index_select(0, ids)
