"""Train state shared by the training entry points (port of
``pretrain_gnns_tpu.train.state.TrainState``). The model holds the
parameters and the batch-norm statistics; the optimizer holds its
moments; ``step`` counts the optimizer steps taken."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
