"""Optimizers (port of ``pretrain_gnns_tpu.train.optim.adam``).

``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is the update rule
of ``optax.adam`` with the same defaults; with ``weight_decay > 0``,
``torch.optim.AdamW`` is that of ``optax.adamw`` (decay scaled by lr and
decoupled from the moments)."""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
         weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
