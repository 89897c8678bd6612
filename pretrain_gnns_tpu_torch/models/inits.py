"""Parameter initializers matching the reference's torch defaults (port of
``pretrain_gnns_tpu.models.inits``).

``nn.Linear`` weights and biases draw from U(-1/sqrt(fan_in),
1/sqrt(fan_in)), except a :class:`Linear` head's bias, whose fan-in is
given; embedding tables are xavier-uniform; GAT's attention
vector is PyG's glorot and its output bias zero. Every draw comes
from an explicit ``torch.Generator``, so a seed fixes the weights on any
device.

The mixed-precision knob, as the JAX package's (``PGT_MODEL_DTYPE``,
:func:`set_compute_dtype`):

- ``"float32"``: everything in float32 (the default);
- ``"bfloat16"``: every dense layer (:func:`dense`) computes in bfloat16
  and returns float32, activations stay float32;
- ``"bfloat16_act"``: activations flow in bfloat16 from the trunk's input
  embedding on, and dense layers return bfloat16.

Parameters, batch-norm statistics, optimizer state and losses stay float32
in every mode. The casts are explicit (``torch.autocast`` rounds at other
places than flax's ``Dense(dtype=bfloat16)``)."""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

_MODES = ("float32", "bfloat16", "bfloat16_act")


def _checked(name: str) -> str:
    if name not in _MODES:
        raise ValueError(f"model dtype must be one of {_MODES}, got {name!r}")
    return name


_DENSE_DTYPE = _checked(os.environ.get("PGT_MODEL_DTYPE", "float32"))


def set_compute_dtype(name: str) -> None:
    """Set the mixed-precision mode: ``"float32"``, ``"bfloat16"`` or
    ``"bfloat16_act"``; anything else raises ``ValueError``."""
    global _DENSE_DTYPE
    _DENSE_DTYPE = _checked(name)


def get_compute_dtype() -> str:
    return _DENSE_DTYPE


def activation_dtype() -> torch.dtype:
    """Dtype activations flow in under the mixed-precision knob."""
    return torch.bfloat16 if _DENSE_DTYPE == "bfloat16_act" else torch.float32


def downcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the activation dtype (unchanged outside ``bfloat16_act``)."""
    return x.to(activation_dtype())


def dense(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear(x)`` under the mixed-precision knob, as the JAX package's
    ``inits.dense``: in float32 mode the plain layer; otherwise ``x``, the
    weight and the bias cast to bfloat16 for the product, and the result
    left in bfloat16 (``bfloat16_act``) or cast back to float32
    (``bfloat16``). The parameters themselves stay float32."""
    if _DENSE_DTYPE == "float32":
        return linear(x)
    bf = torch.bfloat16
    bias = None if linear.bias is None else linear.bias.to(bf)
    y = F.linear(x.to(bf), linear.weight.to(bf), bias)
    return y.float() if _DENSE_DTYPE == "bfloat16" else y


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
