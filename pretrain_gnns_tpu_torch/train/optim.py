"""Optimizers (port of ``pretrain_gnns_tpu.train.optim.adam``).

``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is the update rule
of ``optax.adam`` with the same defaults; with ``weight_decay > 0``,
``torch.optim.AdamW`` is that of ``optax.adamw`` (decay scaled by lr and
decoupled from the moments).

On CUDA the optimizer is ``capturable``: the step count and the bias
corrections live on the card and the step reads nothing back, so that a
CUDA graph can capture it (``train/graphed.py``). The rule is the same;
only where the bias corrections are computed differs. Every optimizer of
CUDA parameters takes this setting, so eager and captured steps on the
card compare bit for bit."""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
         weight_decay: float = 0.0) -> torch.optim.Optimizer:
    params = list(params)
    capturable = bool(params) and all(p.is_cuda for p in params)
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay,
                                 capturable=capturable)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)
