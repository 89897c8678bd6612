"""Checkpoints (port of ``pretrain_gnns_tpu.train.checkpoints``).

Step checkpoints of the whole train state with retention, for resume
(:class:`CheckpointManager`): where the JAX package writes an orbax
directory a step, the port writes one torch file a step of
``TrainState.state_dict()`` (the model's and the optimizer's state dicts,
the step, the epoch it closes and the trunks' dropout generator states).
Orbax directories are not read: trunk files are what the two packages
exchange.

Trunk files (port of ``save_trunk_reference_format`` and
``load_trunk_any``, and of the JAX package's
``compat/{torch_writer,torch_reader,import_params}.py``, which read and
write torch's format without torch): the trunk written in the reference's
layout and torch's legacy format, read back from a reference ``.pth`` or
from either package's export, and grafted into a trunk module.

The port's modules carry the reference's parameter names (chem:
``x_embedding{1,2}``, ``gnns.{k}.*``, ``batch_norms.{k}.*``; bio:
``gnns.{k}.edge_encoder``, ``gnns.0.input_node_embeddings`` and bio GIN's
``gnns.{k}.mlp.1`` batch norm), so a trunk file is the trunk module's
``state_dict`` as it is, and :func:`graft` is ``load_state_dict(strict=
True)``, which raises on a missing or unexpected key or a wrong shape.
torch 1.0.1's ``BatchNorm1d`` wrote no ``num_batches_tracked``: a batch
norm without one gets the count 0, as the JAX importer skips it."""

from __future__ import annotations

import os
import re
import tempfile
import zipfile
from collections import OrderedDict
from typing import List, Mapping, Optional

import torch
from torch import nn

from pretrain_gnns_tpu_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Step checkpoints of a ``TrainState`` with retention: the newest
    ``max_to_keep`` are kept, as orbax keeps them. A checkpoint is
    ``<directory>/step_<step>.pt``, written to a temporary file in the
    directory and moved into place (``os.replace``), so a name never holds
    a partial write. Only whole files of that name count as steps: a
    temporary or stray file, or one cut short (no zip directory at its
    end), is never a step."""

    def __init__(self, directory, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be positive, got "
                             f"{max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):09d}.pt")

    def all_steps(self) -> List[int]:
        """The steps of the whole checkpoints, in order."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m and zipfile.is_zipfile(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             extra: Optional[Mapping] = None) -> None:
        """Write ``state`` (with the entries of ``extra``, such as
        ``TrainState``'s optional ``rank_dropout``) as step ``step``, then
        drop all but the newest ``max_to_keep`` checkpoints."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=".step_",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save({**state.state_dict(), **(extra or {})}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self.path(old))

    def restore(self, state: TrainState, step: Optional[int] = None,
                rank: int = 0) -> TrainState:
        """Fill ``state`` in place from step ``step`` (default: the latest)
        as data-parallel rank ``rank`` and return it. The file is read with
        ``weights_only=True`` onto the device of ``state``'s parameters;
        ``TrainState.load_state_dict`` raises on a missing or unexpected
        key or a wrong shape."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(state.model.parameters()).device
        saved = torch.load(self.path(step), map_location=device,
                           weights_only=True)
        state.load_state_dict(saved, rank=rank)
        return state

    def close(self) -> None:
        """Nothing to flush: every save has finished when it returns."""


def save_trunk_reference_format(trunk: nn.Module, path) -> None:
    """Write ``trunk``'s state dict to ``path`` as the reference does
    (``torch.save(model.gnn.state_dict())``, chem/pretrain_masking.py:
    146-147), every tensor on the CPU, in the legacy (pre-zip) format that
    the reference's torch 1.0.1 reads (``GNN_graphpred.from_pretrained``,
    chem/model.py:354-356)."""
    state = OrderedDict((k, v.detach().cpu())
                        for k, v in trunk.state_dict().items())
    torch.save(state, path, _use_new_zipfile_serialization=False)


def load_trunk_any(path) -> "OrderedDict[str, torch.Tensor]":
    """``{name: tensor}`` from a reference ``.pth`` or from the JAX
    package's or the port's export, every tensor on the CPU. A ``.pth`` is
    outside input, so it is read with ``torch.load(weights_only=True)``:
    tensors and plain containers only, no code run. That reads the legacy
    files of the reference and of either package's writer (the JAX one's
    pickle names only ``torch._utils._rebuild_tensor_v2`` and the typed
    storages) and torch's zip format. Raises ``ValueError`` when the file
    holds anything but a state dict of tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, Mapping) or not all(
            isinstance(k, str) and isinstance(v, torch.Tensor)
            for k, v in obj.items()):
        raise ValueError(f"{path} holds no state dict of tensors")
    return OrderedDict(obj)


def graft(trunk: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a reference trunk's state dict into ``trunk`` strictly, with
    ``num_batches_tracked = 0`` beside every batch norm's
    ``running_mean`` that lacks one."""
    state = OrderedDict(state_dict)
    for key in state_dict:
        if key.endswith("running_mean"):
            count = key[:-len("running_mean")] + "num_batches_tracked"
            state.setdefault(count, torch.tensor(0, dtype=torch.long))
    trunk.load_state_dict(state, strict=True)
