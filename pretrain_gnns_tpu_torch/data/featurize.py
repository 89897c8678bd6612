"""Offline featurization: raw chemistry files -> npz graph shards (port of
``pretrain_gnns_tpu.data.featurize``; the same functions, names and
defaults, writing the same files through ``data.datasets``).

Re-implements the reference's L0 featurization (chem/loader.py) as an
offline CPU pipeline. RDKit never touches the GPU and is imported
lazily — in environments without it, everything except the RDKit-dependent
entry points still works (label coding, dataset specs, storage).

Feature schema (chem/loader.py:22-100):
- atom feature  = [atomic_num - 1 (index into 1..118), chirality tag 0-3]
- bond feature  = [bond type 0-3 (single/double/triple/aromatic),
                   bond dir 0-2 (none/end-up-right/end-down-right)]
- every bond emitted in BOTH directions consecutively (pair ordering is
  load-bearing for masking/edgepred, chem/util.py:209-213)
- labels stored in {-1, 0, +1} with 0 = missing (0 -> -1, NaN -> 0,
  chem/loader.py:941-944)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import Graph

# ---------------------------------------------------------------------------
# RDKit gate
# ---------------------------------------------------------------------------
def _rdkit():
    try:
        from rdkit import Chem
        from rdkit.Chem import AllChem

        return Chem, AllChem
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "RDKit is required for offline featurization but is not "
            "installed in this environment. Featurized npz shards can be "
            "produced elsewhere and dropped into "
            "<root>/<dataset>/processed_tpu/."
        ) from e


NUM_BOND_FEATURES = 2


def _chirality_list(Chem):
    return [
        Chem.rdchem.ChiralType.CHI_UNSPECIFIED,
        Chem.rdchem.ChiralType.CHI_TETRAHEDRAL_CW,
        Chem.rdchem.ChiralType.CHI_TETRAHEDRAL_CCW,
        Chem.rdchem.ChiralType.CHI_OTHER,
    ]


def _bond_type_list(Chem):
    return [
        Chem.rdchem.BondType.SINGLE,
        Chem.rdchem.BondType.DOUBLE,
        Chem.rdchem.BondType.TRIPLE,
        Chem.rdchem.BondType.AROMATIC,
    ]


def _bond_dir_list(Chem):
    return [
        Chem.rdchem.BondDir.NONE,
        Chem.rdchem.BondDir.ENDUPRIGHT,
        Chem.rdchem.BondDir.ENDDOWNRIGHT,
    ]


def mol_to_graph(mol) -> Graph:
    """chem/loader.py:53-100 exactly (atomic numbers 1..118 -> 0..117)."""
    Chem, _ = _rdkit()
    chirality = _chirality_list(Chem)
    bonds = _bond_type_list(Chem)
    dirs = _bond_dir_list(Chem)

    x = np.array(
        [
            [atom.GetAtomicNum() - 1, chirality.index(atom.GetChiralTag())]
            for atom in mol.GetAtoms()
        ],
        np.int64,
    )
    ei, ea = [], []
    for bond in mol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        feat = [bonds.index(bond.GetBondType()),
                dirs.index(bond.GetBondDir())]
        ei += [(i, j), (j, i)]
        ea += [feat, feat]
    edge_index = (
        np.array(ei, np.int64).T if ei else np.zeros((2, 0), np.int64)
    )
    edge_attr = (
        np.array(ea, np.int64)
        if ea
        else np.zeros((0, NUM_BOND_FEATURES), np.int64)
    )
    return Graph(x, edge_index, edge_attr)


def graph_to_mol(g: Graph):
    """Inverse mapping (chem/loader.py:102-137), for debugging/round-trips."""
    Chem, _ = _rdkit()
    chirality = _chirality_list(Chem)
    bonds = _bond_type_list(Chem)
    dirs = _bond_dir_list(Chem)
    mol = Chem.RWMol()
    for row in g.node_feat:
        atom = Chem.Atom(int(row[0]) + 1)
        atom.SetChiralTag(chirality[int(row[1])])
        mol.AddAtom(atom)
    seen = set()
    for k in range(g.num_edges):
        i, j = int(g.edge_index[0, k]), int(g.edge_index[1, k])
        if (min(i, j), max(i, j)) in seen:
            continue
        seen.add((min(i, j), max(i, j)))
        idx = mol.AddBond(i, j, bonds[int(g.edge_feat[k, 0])]) - 1
        mol.GetBondWithIdx(idx).SetBondDir(dirs[int(g.edge_feat[k, 1])])
    return mol.GetMol()


def graph_to_nx_simple(g: Graph):
    """``Graph`` -> undirected networkx graph with per-node
    ``atom_num_idx``/``chirality_tag_idx`` and per-edge
    ``bond_type_idx``/``bond_dir_idx`` attributes (reference
    ``graph_data_obj_to_nx_simple``, chem/loader.py:146-177; even-index
    edges only, since bonds are stored direction-paired)."""
    import networkx as nx

    G = nx.Graph()
    for i, row in enumerate(np.asarray(g.node_feat)):
        G.add_node(i, atom_num_idx=int(row[0]),
                   chirality_tag_idx=int(row[1]))
    ei = np.asarray(g.edge_index)
    ea = np.asarray(g.edge_feat)
    for j in range(0, ei.shape[1], 2):
        b, e = int(ei[0, j]), int(ei[1, j])
        if not G.has_edge(b, e):
            G.add_edge(b, e, bond_type_idx=int(ea[j, 0]),
                       bond_dir_idx=int(ea[j, 1]))
    return G


def nx_to_graph_simple(G) -> Graph:
    """Inverse of :func:`graph_to_nx_simple` (reference
    ``nx_to_graph_data_obj_simple``, chem/loader.py:179-221): nodes assumed
    labeled 0..N-1; each nx edge re-emitted in both directions
    consecutively."""
    x = np.array(
        [[n["atom_num_idx"], n["chirality_tag_idx"]]
         for _, n in G.nodes(data=True)],
        np.int64,
    )
    ei, ea = [], []
    for i, j, edge in G.edges(data=True):
        feat = [edge["bond_type_idx"], edge["bond_dir_idx"]]
        ei += [(i, j), (j, i)]
        ea += [feat, feat]
    edge_index = (
        np.array(ei, np.int64).T if ei else np.zeros((2, 0), np.int64)
    )
    edge_attr = (
        np.array(ea, np.int64)
        if ea
        else np.zeros((0, NUM_BOND_FEATURES), np.int64)
    )
    return Graph(x, edge_index, edge_attr)


def generate_scaffold(smiles: str, include_chirality: bool = True) -> str:
    """Bemis-Murcko scaffold SMILES (chem/splitters.py:11-20)."""
    from rdkit.Chem.Scaffolds import MurckoScaffold

    return MurckoScaffold.MurckoScaffoldSmiles(
        smiles=smiles, includeChirality=include_chirality
    )


# -- standardization utils (chem/loader.py:223-258, 779-790, 1258-1293) -----
def check_smiles_validity(smiles: str) -> bool:
    Chem, _ = _rdkit()
    try:
        return Chem.MolFromSmiles(smiles) is not None
    except Exception:
        return False


def split_rdkit_mol_obj(mol):
    """Split multi-species mol into valid per-species mols."""
    Chem, AllChem = _rdkit()
    smiles = AllChem.MolToSmiles(mol)
    return [
        AllChem.MolFromSmiles(s)
        for s in smiles.split(".")
        if check_smiles_validity(s)
    ]


def get_largest_mol(mols):
    sizes = [m.GetNumAtoms() for m in mols]
    return mols[sizes.index(max(sizes))]


def create_standardized_mol_id(smiles: str) -> Optional[str]:
    """InChI of the largest species with stereo kept (used as the dedup /
    leakage key, chem/loader.py:241-258)."""
    Chem, AllChem = _rdkit()
    if not check_smiles_validity(smiles):
        return None
    smiles = AllChem.MolToSmiles(
        AllChem.MolFromSmiles(smiles), isomericSmiles=True
    )
    mol = AllChem.MolFromSmiles(smiles)
    if mol is None:
        return None
    if "." in smiles:
        mols = split_rdkit_mol_obj(mol)
        if not mols:
            return None
        mol = get_largest_mol(mols)
    return AllChem.MolToInchi(mol)


def get_gasteiger_partial_charges(mol, n_iter: int = 12):
    """Per-atom Gasteiger partial charges (chem/loader.py:223-237):
    computes charges in place and returns the float list."""
    Chem, _ = _rdkit()
    from rdkit.Chem import rdPartialCharges

    rdPartialCharges.ComputeGasteigerCharges(
        mol, nIter=n_iter, throwOnParamFailure=True
    )
    return [
        float(a.GetProp("_GasteigerCharge")) for a in mol.GetAtoms()
    ]


def morgan_fingerprint(mol, radius: int = 2, size: int = 2048) -> np.ndarray:
    """Circular fingerprint bits (MoleculeFingerprintDataset analogue,
    chem/loader.py:792-925)."""
    from rdkit.Chem.rdMolDescriptors import GetMorganFingerprintAsBitVect

    fp = GetMorganFingerprintAsBitVect(mol, radius, nBits=size)
    return np.array(list(fp), np.int8)


# ---------------------------------------------------------------------------
# CSV dataset specs (table-driven version of chem/loader.py:928-1177)
# ---------------------------------------------------------------------------
@dataclass
class CsvSpec:
    raw_file: str
    smiles_col: str
    tasks: Optional[Sequence[str]]  # None = all columns but smiles
    coding: str  # "binary" {0,1}->{-1,1}+nan->0 | "regression" raw
    fillna: bool = True  # nan -> 0 after recoding
    canonicalize: bool = False  # re-emit canonical smiles (bbbp/clintox/...)


TOX21_TASKS = ["NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER",
               "NR-ER-LBD", "NR-PPAR-gamma", "SR-ARE", "SR-ATAD5",
               "SR-HSE", "SR-MMP", "SR-p53"]
MUV_TASKS = ["MUV-466", "MUV-548", "MUV-600", "MUV-644", "MUV-652",
             "MUV-689", "MUV-692", "MUV-712", "MUV-713", "MUV-733",
             "MUV-737", "MUV-810", "MUV-832", "MUV-846", "MUV-852",
             "MUV-858", "MUV-859"]
SIDER_TASKS = None  # all columns except smiles

CSV_SPECS: Dict[str, CsvSpec] = {
    "tox21": CsvSpec("tox21.csv", "smiles", TOX21_TASKS, "binary"),
    "hiv": CsvSpec("HIV.csv", "smiles", ["HIV_active"], "binary",
                   fillna=False),
    "bace": CsvSpec("bace.csv", "mol", ["Class"], "binary", fillna=False),
    "bbbp": CsvSpec("BBBP.csv", "smiles", ["p_np"], "binary",
                    fillna=False, canonicalize=True),
    "clintox": CsvSpec("clintox.csv", "smiles",
                       ["FDA_APPROVED", "CT_TOX"], "binary",
                       fillna=False, canonicalize=True),
    "muv": CsvSpec("muv.csv", "smiles", MUV_TASKS, "binary"),
    "sider": CsvSpec("sider.csv", "smiles", SIDER_TASKS, "binary",
                     fillna=False),
    "toxcast": CsvSpec("toxcast_data.csv", "smiles", None, "binary",
                       canonicalize=True),
    "esol": CsvSpec("delaney-processed.csv", "smiles",
                    ["measured log solubility in mols per litre"],
                    "regression"),
    "freesolv": CsvSpec("SAMPL.csv", "smiles", ["expt"], "regression"),
    "lipophilicity": CsvSpec("Lipophilicity.csv", "smiles", ["exp"],
                             "regression"),
}


def encode_labels(df, spec: CsvSpec) -> np.ndarray:
    """Pure label coding (no RDKit): {0,1} -> {-1,+1}, NaN -> 0 missing."""
    tasks = (
        list(spec.tasks)
        if spec.tasks is not None
        else [c for c in df.columns if c != spec.smiles_col]
    )
    labels = df[tasks]
    if spec.coding == "binary":
        labels = labels.replace(0, -1)
        if spec.fillna:
            labels = labels.fillna(0)
        return labels.values.astype(np.float32)
    return labels.values.astype(np.float32).reshape(len(df), -1)


def load_csv_dataset(name: str, path: str):
    """-> (smiles list, mol list (None for invalid), labels [G, T])."""
    import pandas as pd

    Chem, AllChem = _rdkit()
    spec = CSV_SPECS[name]
    df = pd.read_csv(path, sep=",")
    smiles = list(df[spec.smiles_col])
    mols = [AllChem.MolFromSmiles(s) for s in smiles]
    if spec.canonicalize:
        smiles = [
            AllChem.MolToSmiles(m) if m is not None else None for m in mols
        ]
    labels = encode_labels(df, spec)
    return smiles, mols, labels


def process_dataset(
    name: str,
    root: str = "dataset",
    downstream_dirs: Sequence[str] = (),
) -> int:
    """Featurize one dataset into <root>/<name>/processed_tpu
    (MoleculeDataset.process, chem/loader.py:318-738). Returns graph count.

    ``zinc_standard_agent``: zinc_id parsed from the csv, invalid smiles
    skipped (chem/loader.py:322-347). ``chembl_filtered``: see
    :func:`process_chembl_filtered`.
    """
    from pretrain_gnns_tpu_torch.data import datasets

    _, AllChem = _rdkit()
    out_dir = datasets.processed_dir(root, name)

    if name == "zinc_standard_agent":
        import pandas as pd

        path = os.path.join(root, name, "raw", "zinc_combined_apr_8_2019.csv.gz")
        df = pd.read_csv(path, sep=",", compression="gzip", dtype="str")
        graphs, smiles_out, ids = [], [], []
        for s, zid in zip(df["smiles"], df["zinc_id"]):
            try:
                mol = AllChem.MolFromSmiles(s)
                if mol is None:
                    continue
                g = mol_to_graph(mol)
                g.y = np.array(
                    [int(zid.split("ZINC")[1].lstrip("0"))], np.float32
                )
                graphs.append(g)
                smiles_out.append(s)
            except Exception:
                continue
        datasets.save_graphs(graphs, out_dir, smiles=smiles_out,
                             meta={"num_tasks": 0, "dataset": name})
        return len(graphs)

    if name == "chembl_filtered":
        return process_chembl_filtered(root, downstream_dirs)

    if name in ("mutag", "ptc_mr"):
        return _process_mutag_ptc(name, root)

    if name in ("pcba", "pcba_pretrain"):
        return _process_pcba(name, root)

    spec = CSV_SPECS[name]
    path = os.path.join(root, name, "raw", spec.raw_file)
    smiles, mols, labels = load_csv_dataset(name, path)
    graphs, smiles_out, scaffolds = [], [], []
    for i, (s, mol) in enumerate(zip(smiles, mols)):
        if mol is None:
            continue
        g = mol_to_graph(mol)
        g.y = labels[i]
        graphs.append(g)
        smiles_out.append(s)
        scaffolds.append(generate_scaffold(s))
    datasets.save_graphs(
        graphs, out_dir, scaffolds=scaffolds, smiles=smiles_out,
        meta={"num_tasks": int(labels.shape[1]), "dataset": name},
    )
    return len(graphs)


def _process_mutag_ptc(name: str, root: str) -> int:
    """mutag / ptc_mr CV datasets (chem/loader.py:661-720): mutag reads a
    space-separated ``.can`` smiles file plus a one-column target file;
    ptc_mr a headerless csv ``id,label,smiles``. Labels are kept raw
    ({-1,+1}; the CV fine-tune metric is sign accuracy,
    chem/finetune_mutag_ptc.py:65-78). Invalid molecules are skipped."""
    import pandas as pd

    from pretrain_gnns_tpu_torch.data import datasets

    _, AllChem = _rdkit()
    raw = os.path.join(root, name, "raw")
    if name == "mutag":
        smiles_list = pd.read_csv(
            os.path.join(raw, "mutag_188_data.can"), sep=" ", header=None
        )[0]
        labels = pd.read_csv(
            os.path.join(raw, "mutag_188_target.txt"), header=None
        )[0].values
    else:
        df = pd.read_csv(
            os.path.join(raw, "ptc_MR.csv"), sep=",", header=None,
            names=["id", "label", "smiles"],
        )
        smiles_list, labels = df["smiles"], df["label"].values

    graphs, smiles_out, scaffolds = [], [], []
    for i, s in enumerate(smiles_list):
        mol = AllChem.MolFromSmiles(s)
        if mol is None:
            continue
        g = mol_to_graph(mol)
        g.y = np.array([labels[i]], np.float32)
        graphs.append(g)
        smiles_out.append(s)
        scaffolds.append(generate_scaffold(s))
    out_dir = datasets.processed_dir(root, name)
    datasets.save_graphs(
        graphs, out_dir, scaffolds=scaffolds, smiles=smiles_out,
        meta={"num_tasks": 1, "dataset": name},
    )
    return len(graphs)


def _process_pcba(name: str, root: str) -> int:
    """pcba / pcba_pretrain (chem/loader.py:593-637). NOTE: the reference
    calls ``_load_pcba_dataset`` which is never defined anywhere in its
    repo (a dead code path); this reconstructs it from the MoleculeNet
    pcba.csv layout (PCBA-* task columns + mol_id + smiles) with the same
    muv-style label coding (0 -> -1, NaN -> 0). ``pcba_pretrain`` applies
    the reference's leakage filters (chem/loader.py:617-625): single
    species only (no '.'), MW in [50, 900], standardized InChI not in the
    ``downstream_mol_inchi_may_24_2019`` exclusion list."""
    import pandas as pd

    from pretrain_gnns_tpu_torch.data import datasets

    _, AllChem = _rdkit()
    raw_path = os.path.join(root, name, "raw", "pcba.csv")
    if not os.path.exists(raw_path):
        raw_path += ".gz"
    df = pd.read_csv(raw_path, sep=",")
    tasks = [c for c in df.columns if c not in ("mol_id", "smiles")]
    labels = df[tasks].replace(0, -1).fillna(0).values.astype(np.float32)
    smiles_list = list(df["smiles"])

    excluded = None
    if name == "pcba_pretrain":
        from rdkit.Chem import Descriptors

        excl_path = os.path.join(
            root, name, "downstream_mol_inchi_may_24_2019"
        )
        excluded = set(pd.read_csv(excl_path, sep=",", header=None)[0])

    graphs, smiles_out = [], []
    for i, s in enumerate(smiles_list):
        mol = AllChem.MolFromSmiles(s)
        if mol is None:
            continue
        if excluded is not None:
            if "." in s:
                continue
            from rdkit.Chem import Descriptors

            if not (50 <= Descriptors.MolWt(mol) <= 900):
                continue
            inchi = create_standardized_mol_id(s)
            if inchi is None or inchi in excluded:
                continue
        g = mol_to_graph(mol)
        g.y = labels[i]
        graphs.append(g)
        smiles_out.append(s)
    out_dir = datasets.processed_dir(root, name)
    datasets.save_graphs(
        graphs, out_dir, smiles=smiles_out,
        meta={"num_tasks": len(tasks), "dataset": name},
    )
    return len(graphs)


def process_chembl_filtered(root: str, downstream_dirs: Sequence[str]) -> int:
    """Supervised-pretraining set with leakage control
    (chem/loader.py:349-426): ChEMBL molecules with MW in [50, 900],
    excluding any molecule whose standardized InChI matches a val/test
    scaffold-split member of any downstream dataset."""
    from rdkit.Chem import Descriptors

    from pretrain_gnns_tpu_torch.data import datasets, splitters

    _, AllChem = _rdkit()

    # collect excluded InChIs from downstream val/test scaffold splits
    excluded = set()
    for d in downstream_dirs:
        graphs, scaffolds, _ = datasets.load_graphs(d)
        smiles_path = os.path.join(d, "smiles.txt")
        smiles = open(smiles_path).read().split("\n")
        _, va, te = splitters.scaffold_split(scaffolds)
        for i in list(va) + list(te):
            mid = create_standardized_mol_id(smiles[i])
            if mid:
                excluded.add(mid)

    smiles, mols, labels = _load_chembl_raw(root)
    graphs, smiles_out = [], []
    for i, mol in enumerate(mols):
        if mol is None:
            continue
        mw = Descriptors.MolWt(mol)
        if not (50 <= mw <= 900):
            continue
        inchi = create_standardized_mol_id(AllChem.MolToSmiles(mol))
        if inchi is None or inchi in excluded:
            continue
        g = mol_to_graph(mol)
        g.y = labels[i].astype(np.float32)
        graphs.append(g)
        smiles_out.append(AllChem.MolToSmiles(mol))
    out_dir = datasets.processed_dir(root, "chembl_filtered")
    datasets.save_graphs(
        graphs, out_dir, smiles=smiles_out,
        meta={"num_tasks": int(labels.shape[1]),
              "dataset": "chembl_filtered"},
    )
    return len(graphs)


def _load_chembl_raw(root: str):
    """chem/loader.py:1179-1256: the ChEMBL-with-labels pickles. They hold
    RDKit molecules, which no restricted unpickler rebuilds, so they are
    read with ``pickle`` itself: give it only the files of the reference's
    download."""
    import pickle

    Chem, _ = _rdkit()
    raw = os.path.join(root, "chembl_filtered", "raw")
    with open(os.path.join(raw, "folds0.pckl"), "rb") as f:
        folds = pickle.load(f)
    with open(os.path.join(raw, "labelsHard.pckl"), "rb") as f:
        targetMat = pickle.load(f)
        sampleAnnInd = pickle.load(f)
        _ = pickle.load(f)
    targetMat = targetMat.copy().tocsr()
    targetMat.sort_indices()
    with open(os.path.join(raw, "chembl20LSTM.pckl"), "rb") as f:
        rdkit_arr = pickle.load(f)
    # {-1, 0, +1}; ``.toarray()`` where the JAX package reads ``.A``, which
    # SciPy's sparse matrices no longer have (removed in SciPy 1.14)
    denseOutput = targetMat.toarray()
    mols = list(rdkit_arr)
    smiles = [
        Chem.MolToSmiles(m) if m is not None else None for m in mols
    ]
    return smiles, mols, denseOutput
