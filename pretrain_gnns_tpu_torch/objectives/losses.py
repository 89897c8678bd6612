"""Loss primitives (port of ``pretrain_gnns_tpu.objectives.losses``:
``masked_softmax_xent``, ``bce_with_logits``, ``masked_task_bce``,
``plain_bce`` and ``sign_accuracy``). Every reduction respects its
validity mask, so padded graph, node and edge slots never contribute."""

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


def masked_task_bce(
    logits: torch.Tensor,  # [G, T]
    y: torch.Tensor,  # [G, T] labels in {-1, 0, +1}, 0 = missing
    graph_mask: torch.Tensor,  # [G] bool
) -> torch.Tensor:
    """The reference's masked multi-task BCE: an entry is valid where
    ``y != 0`` in a valid graph, its target is ``(y + 1) / 2``, and the loss
    is the sum over the valid entries over their count (at least 1)."""
    is_valid = (y.square() > 0) & graph_mask[:, None]
    loss_mat = bce_with_logits(logits, (y + 1.0) / 2.0)
    denom = torch.clamp(is_valid.sum(), min=1)
    return torch.where(is_valid, loss_mat, 0.0).sum() / denom


def plain_bce(
    logits: torch.Tensor,  # [G, T]
    y01: torch.Tensor,  # [G, T] labels in {0, 1}
    graph_mask: torch.Tensor,  # [G] bool
) -> torch.Tensor:
    """The bio BCE over all entries: the mean over every (graph, task) cell
    of the valid graphs."""
    loss_mat = bce_with_logits(logits, y01)
    m = graph_mask[:, None].to(loss_mat.dtype)
    denom = torch.clamp(m.sum() * y01.shape[1], min=1.0)
    return (loss_mat * m).sum() / denom


def sign_accuracy(pos_pred: torch.Tensor, neg_pred: torch.Tensor,
                  pos_mask: torch.Tensor, neg_mask: torch.Tensor
                  ) -> torch.Tensor:
    """The contrastive objectives' in-loop metric: the fraction of valid
    positive scores > 0 and valid negative scores < 0."""
    pm = pos_mask.float()
    nm = neg_mask.float()
    correct = ((pos_pred > 0) * pm).sum() + ((neg_pred < 0) * nm).sum()
    return correct / torch.clamp(pm.sum() + nm.sum(), min=1.0)
