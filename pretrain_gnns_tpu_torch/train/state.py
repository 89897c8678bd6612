"""Train state shared by the training entry points (port of
``pretrain_gnns_tpu.train.state.TrainState``). The model holds the
parameters and the batch-norm statistics; the optimizer holds its
moments; ``step`` counts the optimizer steps taken and ``epoch`` the
epochs they closed; the trunks' dropout generators hold where their masks
are. :meth:`TrainState.state_dict` gathers all of it, as the JAX state's
pytree holds it, and :meth:`TrainState.load_state_dict` puts it back in
place (``train.checkpoints.CheckpointManager``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from pretrain_gnns_tpu_torch.models.chem import TrunkDropout

KEYS = ("model", "optimizer", "step", "epoch", "dropout")
# a data-parallel checkpoint's every rank's dropout states
OPTIONAL_KEYS = ("rank_dropout",)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0

    def _dropout_modules(self):
        return {name: m for name, m in self.model.named_modules()
                if isinstance(m, TrunkDropout)}

    def dropout_states(self) -> Dict[str, Any]:
        """Each trunk's dropout generator states by device
        (``TrunkDropout.dropout_states``), by module name."""
        return {name: m.dropout_states()
                for name, m in self._dropout_modules().items()}

    def state_dict(self) -> Dict[str, Any]:
        """The whole state: the model's and the optimizer's state dicts,
        ``step``, ``epoch`` and :meth:`dropout_states`."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "epoch": self.epoch,
                "dropout": self.dropout_states()}

    def load_state_dict(self, saved: Dict[str, Any], rank: int = 0) -> None:
        """Fill this state in place from ``saved`` (:meth:`state_dict`'s
        form, possibly of another device). The model loads strictly. The
        optimizer takes the saved moments and step counts, and keeps its
        own parameter groups: their flags (``capturable`` on CUDA, not on
        the CPU) belong to the device this run built. The dropout
        generators of this run's device type take the saved states. A
        data-parallel checkpoint (``parallel.dp.RankCheckpoints``) also
        holds every rank's generator states under ``rank_dropout``, and
        rank ``rank`` takes its own; a rank above 0 keeps its seeded
        streams where the checkpoint has none of its own. Raises
        ``KeyError`` on a missing or unexpected entry, ``RuntimeError``
        (``load_state_dict``) on a model key or shape that differs, and
        ``ValueError`` on another parameter grouping or a moment of the
        wrong shape."""
        if set(saved) - set(OPTIONAL_KEYS) != set(KEYS):
            raise KeyError(f"a train state has the entries {KEYS}, not "
                           f"{sorted(saved)}")
        dropout = self._dropout_modules()
        if set(saved["dropout"]) != set(dropout):
            raise KeyError(f"dropout states of {sorted(saved['dropout'])}, "
                           f"this model has {sorted(dropout)}")
        self.model.load_state_dict(saved["model"], strict=True)
        opt = saved["optimizer"]
        own = self.optimizer.state_dict()
        sizes = [len(g["params"]) for g in own["param_groups"]]
        if [len(g["params"]) for g in opt["param_groups"]] != sizes:
            raise ValueError(
                f"the saved optimizer groups {sum(sizes)} parameters "
                f"otherwise: {[len(g['params']) for g in opt['param_groups']]}"
                f" against {sizes}")
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for i, moments in opt["state"].items():
            for name, t in moments.items():
                if name != "step" and t.shape != params[i].shape:
                    raise ValueError(
                        f"optimizer state {i}.{name}: shape {tuple(t.shape)}"
                        f", the parameter's {tuple(params[i].shape)}")
        self.optimizer.load_state_dict(
            {"state": opt["state"], "param_groups": own["param_groups"]})
        device = next(self.model.parameters()).device
        states = saved["dropout"]
        if rank:
            ranks = saved.get("rank_dropout")
            if ranks is not None and len(ranks) <= rank:
                raise ValueError(f"the checkpoint holds the streams of "
                                 f"{len(ranks)} ranks, not of rank {rank}")
            states = ranks[rank] if ranks is not None else None
        for name, m in dropout.items():
            if states is not None:
                m.load_dropout_states(states[name], device)
        self.step, self.epoch = int(saved["step"]), int(saved["epoch"])
