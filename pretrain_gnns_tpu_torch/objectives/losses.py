"""Loss primitives (port of ``masked_softmax_xent`` of
``pretrain_gnns_tpu.objectives.losses``)."""

from __future__ import annotations

import torch


def masked_softmax_xent(
    logits: torch.Tensor,  # [K, C]
    labels: torch.Tensor,  # [K] int
    mask: torch.Tensor,  # [K] bool
) -> torch.Tensor:
    """Cross-entropy averaged over valid rows (torch CrossEntropyLoss's
    mean reduction restricted to ``mask``), in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0] - logz
    m = mask.to(ll.dtype)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)
