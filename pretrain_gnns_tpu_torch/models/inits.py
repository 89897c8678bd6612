"""Parameter initializers matching the reference's torch defaults (port of
``pretrain_gnns_tpu.models.inits``).

``nn.Linear`` weights and biases draw from U(-1/sqrt(fan_in),
1/sqrt(fan_in)), except a :class:`Linear` head's bias, whose fan-in is
given; embedding tables are xavier-uniform; GAT's attention
vector is PyG's glorot and its output bias zero. Every draw comes
from an explicit ``torch.Generator``, so a seed fixes the weights on any
device."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def activation_dtype() -> torch.dtype:
    """Dtype activations flow in: float32 (the JAX package's default
    ``float32`` mode; its ``bfloat16_act`` mode is not ported yet)."""
    return torch.float32


class Linear(nn.Linear):
    """``nn.Linear`` whose bias is drawn from U(-1/sqrt(bias_fan_in),
    1/sqrt(bias_fan_in)): the JAX package's ``inits.dense(features,
    fan_in)`` on an input wider than ``fan_in`` (the chem masking heads
    under JK concat), whose weight bound follows the input's width and its
    bias bound ``fan_in``."""

    def __init__(self, in_features: int, out_features: int,
                 bias_fan_in: int):
        super().__init__(in_features, out_features)
        self.bias_fan_in = bias_fan_in


@torch.no_grad()
def reset_linear_(linear: nn.Linear, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.uniform_(-bound, bound, generator=generator)
    if linear.bias is not None:
        bound = 1.0 / math.sqrt(getattr(linear, "bias_fan_in",
                                        linear.in_features))
        linear.bias.uniform_(-bound, bound, generator=generator)


def pyg_glorot(shape, generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PyG ``inits.glorot``: U(-b, b), b = sqrt(6 / (shape[-2] +
    shape[-1]))."""
    bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return torch.empty(tuple(shape), dtype=dtype).uniform_(
        -bound, bound, generator=generator)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear, Embedding, LSTM cell (``reset_parameters``
    of ``models.pools.TorchLSTMCell``) and GAT attention vector (``att``,
    with its zero ``bias``) of ``module`` in module order."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            reset_linear_(m, generator)
        elif isinstance(m, nn.Embedding):
            nn.init.xavier_uniform_(m.weight, generator=generator)
        elif isinstance(getattr(m, "weight_ih", None), nn.Parameter):
            m.reset_parameters(generator)
        elif isinstance(getattr(m, "att", None), nn.Parameter):
            m.att.copy_(pyg_glorot(m.att.shape, generator, m.att.dtype))
            m.bias.zero_()
