"""Optimizers (port of ``adam`` and ``finetune_adam`` of
``pretrain_gnns_tpu.train.optim``).

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

from typing import Iterable, List, Union

import torch

Params = Union[Iterable[torch.nn.Parameter], List[dict]]


def adam(params: Params, lr: float = 1e-3,
         weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam (AdamW under ``weight_decay > 0``) over ``params``: parameters
    or parameter groups (dicts with ``params`` and their own ``lr``)."""
    params = list(params)
    tensors = [p for g in params
               for p in (g["params"] if isinstance(g, dict) else [g])]
    capturable = bool(tensors) and all(p.is_cuda for p in tensors)
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay,
                                 capturable=capturable)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def finetune_adam(model: torch.nn.Module, lr: float = 1e-3,
                  lr_scale: float = 1.0,
                  weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """:func:`adam` over two groups (chem/finetune.py:180-185): the trunk
    ``model.gnn`` at ``lr`` and every other parameter (the pooling gate,
    the head) at ``lr * lr_scale``; under ``weight_decay`` each group's
    decay is scaled by its own rate, as optax's ``multi_transform`` of two
    ``adamw`` does."""
    trunk = {id(p) for p in model.gnn.parameters()}
    rest = [p for p in model.parameters() if id(p) not in trunk]
    return adam([{"params": list(model.gnn.parameters()), "lr": lr},
                 {"params": rest, "lr": lr * lr_scale}], lr, weight_decay)
