"""Masked BatchNorm (port of ``pretrain_gnns_tpu.models.norm``): torch
``BatchNorm1d`` semantics over valid rows only. ``nn.BatchNorm1d`` cannot
be used, because it would count the padded rows.

- train: normalize by the biased variance of the valid rows, in f32 (in
  f64 on f64 input);
- running stats: ``running = (1 - momentum) * running + momentum * stat``
  with the unbiased variance entering ``running_var``;
- eval: normalize by the running stats. eps = 1e-5, momentum = 0.1.

State-dict keys are those of ``BatchNorm1d`` (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                train: bool) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                n = xf.new_full((), float(xf.shape[0]))
                mean = xf.mean(0)
                var = torch.square(xf - mean).mean(0)
            else:
                m = mask.to(xf.dtype)[:, None]
                n = torch.clamp(m.sum(), min=1.0)
                mean = (xf * m).sum(0) / n
                var = (torch.square(xf - mean) * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                mom = self.momentum
                self.running_mean.copy_(
                    (1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_(
                    (1 - mom) * self.running_var + mom * unbiased)
                self.num_batches_tracked += 1
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)
