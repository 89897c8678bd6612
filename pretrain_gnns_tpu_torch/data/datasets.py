"""Dataset storage and registry (port of ``pretrain_gnns_tpu.data.datasets``;
the same files, so that either package reads what the other wrote).

The reference keeps processed datasets as torch-pickled PyG tensors
(``processed/geometric_data_processed.pt``, chem/loader.py:731-738). Here,
as in the JAX package, a processed dataset is flat arrays in one npz: every
graph's node, edge and graph arrays concatenated, with offset vectors; no
pickle. The offline featurizers (``data.featurize``,
``data.bio_featurize``) and the importer of the reference's files
(``compat.import_pyg``) write this format; :func:`load_graphs` reads it
back into host ``Graph`` lists.

Layout of ``<root>/<name>/processed_tpu/data.npz``:
  node_feat [sumN, Fn], node_offsets [G+1]
  edge_index [2, sumE], edge_attr [sumE, Fe], edge_offsets [G+1]
  y [G, T] (optional)
  extra arrays as ``extra_<key>`` + ``extra_<key>_offsets`` (+ kind map in
  meta.json)
plus ``meta.json`` and optional ``scaffolds.txt`` (one per graph, for the
chem splitters) / ``smiles.txt`` (the reference's processed/smiles.csv).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import GRAPH, Graph

# Reference downstream task counts (chem/finetune.py:125-144)
CHEM_NUM_TASKS = {
    "tox21": 12, "hiv": 1, "pcba": 128, "muv": 17, "bace": 1, "bbbp": 1,
    "toxcast": 617, "sider": 27, "clintox": 2, "mutag": 1, "ptc_mr": 1,
    "chembl_filtered": 1310,
}


def save_graphs(
    graphs: Sequence[Graph],
    directory: str,
    scaffolds: Optional[Sequence[str]] = None,
    smiles: Optional[Sequence[str]] = None,
    meta: Optional[Dict] = None,
) -> None:
    """Write ``graphs`` (with their extras), and the scaffolds and smiles
    where given, as ``directory/{data.npz,meta.json,scaffolds.txt,
    smiles.txt}``; ``meta`` joins ``num_graphs`` and the extras' kinds in
    ``meta.json``."""
    os.makedirs(directory, exist_ok=True)
    G = len(graphs)
    node_off = np.cumsum([0] + [g.num_nodes for g in graphs])
    edge_off = np.cumsum([0] + [g.num_edges for g in graphs])
    arrays = {
        "node_feat": np.concatenate([g.node_feat for g in graphs]),
        "node_offsets": node_off,
        "edge_index": np.concatenate(
            [g.edge_index for g in graphs], axis=1
        ),
        "edge_attr": np.concatenate([g.edge_feat for g in graphs]),
        "edge_offsets": edge_off,
    }
    if graphs[0].y is not None:
        arrays["y"] = np.stack([np.asarray(g.y) for g in graphs])

    extra_kinds: Dict[str, str] = {}
    keys = set()
    for g in graphs:
        keys.update(g.extras)
    for k in sorted(keys):
        vals = [np.asarray(g.extras[k][0]) for g in graphs]
        kind = graphs[0].extras[k][1]
        extra_kinds[k] = kind
        if kind == GRAPH:
            arrays[f"extra_{k}"] = np.stack(vals)
        else:
            arrays[f"extra_{k}"] = np.concatenate(vals)
            arrays[f"extra_{k}_offsets"] = np.cumsum(
                [0] + [len(v) for v in vals]
            )
    np.savez_compressed(os.path.join(directory, "data.npz"), **arrays)
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(
            {"num_graphs": G, "extra_kinds": extra_kinds, **(meta or {})},
            f,
        )
    for name, lines in (("scaffolds.txt", scaffolds), ("smiles.txt", smiles)):
        if lines is not None:
            with open(os.path.join(directory, name), "w") as f:
                f.write("\n".join(lines))


def load_graphs(
    directory: str,
) -> Tuple[List[Graph], Optional[List[str]], Dict]:
    """Returns (graphs, scaffolds-or-None, meta)."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(directory, "data.npz"), allow_pickle=False)
    no, eo = z["node_offsets"], z["edge_offsets"]
    G = meta["num_graphs"]
    y = z["y"] if "y" in z else None
    node_feat, edge_index, edge_attr = (z["node_feat"], z["edge_index"],
                                        z["edge_attr"])
    graphs = [
        Graph(
            node_feat=node_feat[no[i]: no[i + 1]],
            edge_index=edge_index[:, eo[i]: eo[i + 1]],
            edge_feat=edge_attr[eo[i]: eo[i + 1]],
            y=y[i] if y is not None else None,
        )
        for i in range(G)
    ]
    for k, kind in meta.get("extra_kinds", {}).items():
        arr = z[f"extra_{k}"]
        if kind == GRAPH:
            for i, g in enumerate(graphs):
                g.extras[k] = (arr[i], kind)
        else:
            # node and edge index extras were stored graph-local already
            off = z[f"extra_{k}_offsets"]
            for i, g in enumerate(graphs):
                g.extras[k] = (arr[off[i]: off[i + 1]], kind)
    scaffolds = None
    spath = os.path.join(directory, "scaffolds.txt")
    if os.path.exists(spath):
        with open(spath) as f:
            scaffolds = f.read().split("\n")
    return graphs, scaffolds, meta


def merge_graph_datasets(
    graphs_1: Sequence[Graph], graphs_2: Sequence[Graph]
) -> List[Graph]:
    """Naively merge two labelled graph lists by zero-padding task vectors
    (reference ``merge_dataset_objs``, chem/loader.py:741-780: used to join
    chembl_with_labels [1310 tasks] with pcba_pretrain [128 tasks] into a
    1438-task supervised pretraining set). Keeps only the structural
    arrays + padded y, like the reference."""
    t1 = len(np.asarray(graphs_1[0].y).ravel())
    t2 = len(np.asarray(graphs_2[0].y).ravel())
    out: List[Graph] = []
    for g in graphs_1:
        y = np.concatenate(
            [np.asarray(g.y, np.float32).ravel(), np.zeros(t2, np.float32)]
        )
        out.append(Graph(g.node_feat, g.edge_index, g.edge_feat, y=y))
    for g in graphs_2:
        y = np.concatenate(
            [np.zeros(t1, np.float32), np.asarray(g.y, np.float32).ravel()]
        )
        out.append(Graph(g.node_feat, g.edge_index, g.edge_feat, y=y))
    return out


def processed_dir(root: str, name: str) -> str:
    return os.path.join(root, name, "processed_tpu")


def load_dataset(
    name: str,
    root: str = "dataset",
    n_synthetic: int = 2000,
    seed: int = 0,
) -> Tuple[List[Graph], Optional[List[str]], Dict]:
    """Dataset registry: ``(graphs, scaffolds or None, meta)`` of a
    processed dataset under ``root`` (``meta["num_tasks"]`` from its
    ``meta.json``, else the reference's count), or of a synthetic
    stand-in: ``synthetic`` is ``n_synthetic`` molecules with two tasks and
    their pseudo-scaffolds, ``synthetic_bio`` ``max(n_synthetic // 4, 64)``
    ego-networks with 40 tasks, both from ``seed``. Raises
    ``FileNotFoundError`` when ``name`` is neither."""
    if name == "synthetic":
        from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset

        graphs, scaffolds = molecule_dataset(
            n_synthetic, num_tasks=2, seed=seed
        )
        return graphs, scaffolds, {"num_tasks": 2}
    if name == "synthetic_bio":
        from pretrain_gnns_tpu_torch.data.synthetic import bio_dataset

        graphs = bio_dataset(max(n_synthetic // 4, 64), seed=seed)
        return graphs, None, {"num_tasks": 40}
    d = processed_dir(root, name)
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"{d} not found — run the offline featurizer first: "
            f"python -m pretrain_gnns_tpu_torch.cli.featurize --dataset "
            f"{name} --root {root} (requires RDKit + raw downloads), or "
            "import the reference's processed file with --import_pyg"
        )
    graphs, scaffolds, meta = load_graphs(d)
    meta.setdefault("num_tasks", CHEM_NUM_TASKS.get(name))
    return graphs, scaffolds, meta
