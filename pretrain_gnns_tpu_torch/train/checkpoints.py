"""Trunk files (port of ``save_trunk_reference_format`` and
``load_trunk_any`` of ``pretrain_gnns_tpu.train.checkpoints`` and of the
JAX package's ``compat/{torch_writer,torch_reader,import_params}.py``,
which read and write torch's format without torch): the trunk written in
the reference's layout and torch's legacy format, read back from a
reference ``.pth`` or from either package's export, and grafted into a
trunk module. Step checkpoints of the whole train state with resume are
not ported yet.

The port's modules carry the reference's parameter names (chem:
``x_embedding{1,2}``, ``gnns.{k}.*``, ``batch_norms.{k}.*``; bio:
``gnns.{k}.edge_encoder``, ``gnns.0.input_node_embeddings`` and bio GIN's
``gnns.{k}.mlp.1`` batch norm), so a trunk file is the trunk module's
``state_dict`` as it is, and :func:`graft` is ``load_state_dict(strict=
True)``, which raises on a missing or unexpected key or a wrong shape.
torch 1.0.1's ``BatchNorm1d`` wrote no ``num_batches_tracked``: a batch
norm without one gets the count 0, as the JAX importer skips it."""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import torch
from torch import nn


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
