"""Importer for the reference's processed PyG dataset files (port of
``pretrain_gnns_tpu.compat.import_pyg``; the same functions, and the same
files written through ``data.datasets``).

The reference persists every dataset as
``processed/geometric_data_processed.pt`` — a ``torch.save`` of
``(data, slices)`` where ``data`` is one ``torch_geometric.data.Data`` with
all graphs' tensors concatenated and ``slices`` maps each key to a
``[G+1]`` boundary vector (chem/loader.py:731-738; PyG 1.0.3
``InMemoryDataset.collate``). For the bio domain this file is the ONLY
ingestion path — ``BioDataset.process()`` raises by design
(bio/loader.py:193-194) and the data ships pre-processed.

The file is outside input, so none of its code may run, and PyG is not
needed. Where the JAX package parses the file with its own allow-list
unpickler (``compat/torch_reader.py``), this module reads it with torch's
own reader, ``torch.load(weights_only=True)``, in either of torch's
formats (legacy and zip): tensors and plain containers only, and PyG's
class paths (:data:`PYG_STUBS`) mapped to :class:`PygData`, an inert
attribute bag that unpickling only allocates and fills. Any other class in
the file raises ``pickle.UnpicklingError`` before it is looked up.

    python -m pretrain_gnns_tpu_torch.cli.featurize \\
        --import_pyg dataset/tox21/processed/geometric_data_processed.pt \\
        --dataset tox21

Key facts about the stored layout this relies on (verified against PyG
1.0.3 semantics): tensors are concatenated WITHOUT index offsetting
(offsets are a ``Batch.from_data_list``-time concern only); ``edge_index``
is concatenated along dim -1, everything else along dim 0; per-graph 1-D
labels (``y``, ``go_target_*``) therefore land flattened as ``[G*T]``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pretrain_gnns_tpu_torch.core.graphs import GRAPH, NODE_IDX, Graph


class PygData:
    """Inert stand-in for a PyG container in a processed file (``Data``,
    ``InMemoryDataset``): unpickling allocates it (``object.__new__``) and
    fills its ``__dict__``; no code of the original class, and none of
    this one, runs."""


# PyG class paths that may appear in processed files across the 1.x line.
PYG_STUBS = (
    "torch_geometric.data.data.Data",
    "torch_geometric.data.Data",
    "torch_geometric.data.in_memory_dataset.InMemoryDataset",
)


def load_pyg_processed(
    path: str,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """-> (key -> concatenated array, key -> [G+1] slice boundaries)."""
    with torch.serialization.safe_globals(
            [(PygData, name) for name in PYG_STUBS]):
        data, slices = torch.load(path, map_location="cpu",
                                  weights_only=True)
    arrays = {
        k: v.numpy() for k, v in vars(data).items()
        if isinstance(v, torch.Tensor)
    }
    bounds = {k: np.asarray(v).ravel() for k, v in slices.items()}
    return arrays, bounds


def _per_graph(arrays, bounds, key, i):
    s, e = int(bounds[key][i]), int(bounds[key][i + 1])
    if key == "edge_index":  # cat_dim=-1 (PyG Data.cat_dim for indices)
        return arrays[key][:, s:e]
    return arrays[key][s:e]


def pyg_to_graphs(
    arrays: Dict[str, np.ndarray],
    bounds: Dict[str, np.ndarray],
) -> Tuple[list, int, str]:
    """Slice the collated tensors back into per-graph ``Graph`` objects.

    Returns (graphs, num_tasks, domain) with domain inferred from the keys:
    ``center_node_idx`` present -> bio (bio/loader.py:50-51), else chem.
    """
    G = len(next(iter(bounds.values()))) - 1
    domain = "bio" if "center_node_idx" in arrays else "chem"
    label_key = "go_target_downstream" if domain == "bio" else "y"

    graphs = []
    num_tasks = 0
    for i in range(G):
        g = Graph(
            node_feat=_per_graph(arrays, bounds, "x", i),
            edge_index=_per_graph(arrays, bounds, "edge_index", i).astype(
                np.int64
            ),
            edge_feat=_per_graph(arrays, bounds, "edge_attr", i),
        )
        if label_key in arrays:
            y = _per_graph(arrays, bounds, label_key, i)
            g.y = np.asarray(y, np.float32)
            num_tasks = max(num_tasks, len(g.y))
        if "center_node_idx" in arrays:
            g.extras["center_node_idx"] = (
                _per_graph(arrays, bounds, "center_node_idx", i).astype(
                    np.int64
                ),
                NODE_IDX,
            )
        if "species_id" in arrays:
            g.extras["species_id"] = (
                _per_graph(arrays, bounds, "species_id", i).astype(np.int64),
                GRAPH,
            )
        if "go_target_pretrain" in arrays:
            g.extras["go_target_pretrain"] = (
                np.asarray(
                    _per_graph(arrays, bounds, "go_target_pretrain", i),
                    np.float32,
                ),
                GRAPH,
            )
        if "id" in arrays:
            g.extras["mol_id"] = (
                _per_graph(arrays, bounds, "id", i).astype(np.int64), GRAPH
            )
        graphs.append(g)
    return graphs, num_tasks, domain


def import_processed(
    path: str,
    out_dir: str,
    dataset_name: str = "imported",
    smiles_csv: Optional[str] = None,
) -> int:
    """Convert a reference processed ``.pt`` into ``<out_dir>/data.npz``.

    ``smiles_csv``: the reference's sibling ``processed/smiles.csv``
    (chem/loader.py:734-738) — when given, smiles (and Murcko scaffolds if
    RDKit is available) are carried over so scaffold splits work.
    """
    from pretrain_gnns_tpu_torch.data import datasets

    arrays, bounds = load_pyg_processed(path)
    graphs, num_tasks, domain = pyg_to_graphs(arrays, bounds)

    smiles = scaffolds = None
    if smiles_csv is not None:
        with open(smiles_csv) as f:
            smiles = [ln.strip() for ln in f if ln.strip()]
        if len(smiles) != len(graphs):
            raise ValueError(
                f"smiles.csv has {len(smiles)} rows for {len(graphs)} graphs"
            )
        try:
            from pretrain_gnns_tpu_torch.data.featurize import (
                generate_scaffold,
            )

            scaffolds = [generate_scaffold(s) for s in smiles]
        except ImportError:  # RDKit absent: import still works, random/
            scaffolds = None  # species splits remain available

    os.makedirs(out_dir, exist_ok=True)
    datasets.save_graphs(
        graphs, out_dir, scaffolds=scaffolds, smiles=smiles,
        meta={
            "num_tasks": num_tasks,
            "dataset": dataset_name,
            "domain": domain,
            "imported_from": os.path.abspath(path),
        },
    )
    return len(graphs)
