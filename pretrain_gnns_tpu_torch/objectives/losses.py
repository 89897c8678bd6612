"""Loss primitives (port of ``masked_softmax_xent``, ``bce_with_logits``
and ``sign_accuracy`` of ``pretrain_gnns_tpu.objectives.losses``)."""

from __future__ import annotations

import torch


def _at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """Narrower floats go up to float32; float64 stays."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def masked_softmax_xent(
    logits: torch.Tensor,  # [K, C]
    labels: torch.Tensor,  # [K] int
    mask: torch.Tensor,  # [K] bool
) -> torch.Tensor:
    """Cross-entropy averaged over valid rows (torch CrossEntropyLoss's
    mean reduction restricted to ``mask``), in f32 at least."""
    logits = _at_least_f32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0] - logz
    m = mask.to(ll.dtype)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (torch
    ``BCEWithLogitsLoss(reduction="none")``, the stable form), in f32 at
    least."""
    logits = _at_least_f32(logits)
    targets = targets.to(logits.dtype)
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sign_accuracy(pos_pred: torch.Tensor, neg_pred: torch.Tensor,
                  pos_mask: torch.Tensor, neg_mask: torch.Tensor
                  ) -> torch.Tensor:
    """The contrastive objectives' in-loop metric: the fraction of valid
    positive scores > 0 and valid negative scores < 0."""
    pm = pos_mask.float()
    nm = neg_mask.float()
    correct = ((pos_pred > 0) * pm).sum() + ((neg_pred < 0) * nm).sum()
    return correct / torch.clamp(pm.sum() + nm.sum(), min=1.0)
