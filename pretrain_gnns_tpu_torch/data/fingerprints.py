"""Morgan-fingerprint dataset — the reference's non-GNN baseline path
(``MoleculeFingerprintDataset``, chem/loader.py:792-925; port of
``pretrain_gnns_tpu.data.fingerprints``, the same files).

Stores per-molecule circular fingerprint bit vectors + labels as one npz
(``processed_fp_tpu/fp.npz``). RDKit is needed only at build time.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def build(
    name: str,
    root: str = "dataset",
    radius: int = 2,
    size: int = 2048,
) -> int:
    """Featurize dataset ``name`` into fingerprints (requires RDKit +
    raw csv, like the graph featurizer)."""
    from pretrain_gnns_tpu_torch.data import featurize

    _, AllChem = featurize._rdkit()
    spec = featurize.CSV_SPECS[name]
    path = os.path.join(root, name, "raw", spec.raw_file)
    smiles, mols, labels = featurize.load_csv_dataset(name, path)
    fps, ys, smiles_out = [], [], []
    for i, mol in enumerate(mols):
        if mol is None:
            continue
        fps.append(featurize.morgan_fingerprint(mol, radius, size))
        ys.append(labels[i])
        smiles_out.append(smiles[i])
    out_dir = os.path.join(root, name, "processed_fp_tpu")
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "fp.npz"),
        fingerprints=np.stack(fps),
        labels=np.stack(ys),
        radius=radius,
        size=size,
    )
    with open(os.path.join(out_dir, "smiles.txt"), "w") as f:
        f.write("\n".join(smiles_out))
    return len(fps)


def load(name: str, root: str = "dataset") -> Tuple[np.ndarray, np.ndarray]:
    """-> (fingerprints [G, size] int8, labels [G, T])."""
    z = np.load(os.path.join(root, name, "processed_fp_tpu", "fp.npz"))
    return z["fingerprints"], z["labels"]
