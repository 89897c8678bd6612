"""Masked segment reductions (port of ``pretrain_gnns_tpu.ops.segment``).

Every function takes an explicit ``num_segments`` and an optional validity
mask, so padded rows contribute nothing, not even to mean denominators.

Rows are summed into segments by :func:`scatter_add_rows` and gathered by
:func:`gather_rows`, whose sums (forward and backward) run in an order
that is the same in every run on either device."""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.to(data.dtype)
    return data * m.reshape(m.shape + (1,) * (data.dim() - m.dim()))


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` widened to float32 if it is narrower (bfloat16); float32 and
    float64 stay as they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def scatter_add_rows(out: torch.Tensor, ids: torch.Tensor,
                     data: torch.Tensor) -> torch.Tensor:
    """``out`` with each row of ``data`` added to row ``ids[i]``, summed in
    an order that every run repeats: on CUDA by ``index_put(...,
    accumulate=True)``, which sums over the sorted indices (``index_add``
    sums with atomics there), on the CPU by ``index_add``, which adds in
    index order (``index_put``'s accumulate adds in parallel with atomics
    there)."""
    if out.is_cuda:
        return out.index_put((ids,), data, accumulate=True)
    return out.index_add(0, ids, data)


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]``, its backward summed as :func:`scatter_add_rows` sums: by
    indexing on CUDA, by ``index_select`` on the CPU."""
    return x[ids] if x.is_cuda else x.index_select(0, ids)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum of ``data`` rows per segment; masked rows contribute zero."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return scatter_add_rows(out, segment_ids.long(), _apply_mask(data, mask))


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
        data = torch.where(m.bool(), data, _NEG_INF)
    out = _segment_amax(data, segment_ids, num_segments)
    return torch.where(out <= _NEG_INF / 2, empty_value, out)


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
        logits = torch.where(m.bool(), logits, _NEG_INF)
    seg_max = _segment_amax(logits, ids, num_segments)
    if extra_logit is not None:
        seg_max = torch.maximum(seg_max, extra_logit)
    # empty segments: avoid -inf
    seg_max = torch.clamp(seg_max, min=_NEG_INF).detach()
    exp = torch.exp(logits - gather_rows(seg_max, ids))
    exp = _apply_mask(exp, mask)
    denom = segment_sum(exp, ids, num_segments)
    if extra_logit is not None:
        exp_extra = torch.exp(extra_logit - seg_max)
        denom = torch.clamp(denom + exp_extra, min=1e-16)
        return exp / gather_rows(denom, ids), exp_extra / denom
    denom = torch.clamp(denom, min=1e-16)
    return exp / gather_rows(denom, ids)
