"""Map the JAX package's flax variables onto the port's ``state_dict``.

``state_dict_from_jax(params, batch_stats)`` takes the variables of a JAX
``MaskingObjective`` (or of its ``gnn`` trunk alone) as nested dicts of
numpy arrays and returns reference-layout keys (``gnn.gnns.0.mlp.0.weight``
...). Dense kernels are ``[in, out]`` in flax and ``[out, in]`` in torch,
so they are transposed; batch-norm ``scale``/``bias`` become
``weight``/``bias`` and ``mean``/``var`` become ``running_mean``/
``running_var``, with ``num_batches_tracked = 0``; a GAT conv's raw
``att`` and ``bias`` arrays and the set2set readout's LSTM arrays
(``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``, kept ``[in, 4H]``)
keep their own names, and so does ``InfomaxObjective``'s
``discriminator_weight``: the port's parameter has the JAX name and its
``[D, D]`` layout (``summary @ W`` in both), so it is neither renamed to
``.weight`` nor transposed. The variables of a ``SupervisedObjective``
map the same way (``pred.gnn.*``, ``pred.pool.*``,
``pred.graph_pred_linear.*``).
It is the port's own copy of the mapping the JAX package's trunk export
applies."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch


def _torch_name(name: str) -> str:
    """flax module name -> reference state-dict path component."""
    for prefix in ("gnns_", "batch_norms_", "mlp_"):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return prefix[:-1] + "." + name[len(prefix):]
    return name


_RAW_LEAVES = ("att", "bias", "weight_ih", "weight_hh", "bias_ih", "bias_hh",
               "discriminator_weight")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any]
                        ) -> "OrderedDict[str, torch.Tensor]":
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def emit(prefix: str, p: Mapping[str, Any], s: Mapping[str, Any]):
        for name, sub in p.items():
            base = prefix + _torch_name(name)
            if not isinstance(sub, Mapping):
                # a GAT conv's, an LSTM cell's and the infomax
                # discriminator's raw leaves keep their names; any other
                # raw array is an embedding table
                key = base if name in _RAW_LEAVES else f"{base}.weight"
                out[key] = _tensor(sub)
            elif "kernel" in sub:  # Dense
                out[f"{base}.weight"] = _tensor(np.asarray(sub["kernel"]).T)
                out[f"{base}.bias"] = _tensor(sub["bias"])
            elif "scale" in sub:  # MaskedBatchNorm
                st = s[name]
                out[f"{base}.weight"] = _tensor(sub["scale"])
                out[f"{base}.bias"] = _tensor(sub["bias"])
                out[f"{base}.running_mean"] = _tensor(st["mean"])
                out[f"{base}.running_var"] = _tensor(st["var"])
                out[f"{base}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.long)
            else:
                emit(base + ".", sub, s.get(name, {}))

    emit("", params, batch_stats)
    return out
