"""Offline ingest of the port against the JAX package's, on the same
inputs: ``data/featurize.py`` (label coding, the spec table, the
16-dataset dispatch with zinc-id parsing and the pcba and chembl leakage
filters, the standardisation, Gasteiger, Morgan and networkx helpers,
``graph_to_mol``), ``data/bio_featurize.py`` (``nx_to_graph``,
``graph_to_nx``, ``process_bio_dataset``, the species rosters),
``data/fingerprints.py`` and ``compat/import_pyg.py`` with
``cli.featurize --import_pyg`` (the reference's processed files in torch's
legacy and zip formats, chem and bio; a file that names any other class
raises and none of its code runs).

RDKit is not installed: the fake RDKit of ``tests/test_featurize_gated.py``
(its ``fake_rdkit`` fixture and mol stand-ins, imported) serves both
packages, with the few calls more that the helpers make added here. PyG is
not installed either: the processed files are written by ``torch.save``
with the stand-in ``Data`` class of
``tests/test_bio_featurize_and_import.py``.

Tolerance: every stored array, dtype, label, scaffold, smiles line and
meta entry exactly equal between the packages. About 10 s alone."""

import gzip
import json
import os
import pickle
import shutil
import sys
import types

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import test_featurize_gated as gated
from pretrain_gnns_tpu.compat import import_pyg as jimport
from pretrain_gnns_tpu.data import bio_featurize as jbio
from pretrain_gnns_tpu.data import datasets as jdatasets
from pretrain_gnns_tpu.data import featurize as jfeat
from pretrain_gnns_tpu.data import fingerprints as jfp
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu_torch.cli import featurize as feat_cli
from pretrain_gnns_tpu_torch.compat import import_pyg as timport
from pretrain_gnns_tpu_torch.core.graphs import Graph
from pretrain_gnns_tpu_torch.data import bio_featurize as tbio
from pretrain_gnns_tpu_torch.data import datasets as tdatasets
from pretrain_gnns_tpu_torch.data import featurize as tfeat
from pretrain_gnns_tpu_torch.data import fingerprints as tfp
from pretrain_gnns_tpu_torch.data import splitters
from test_bio_featurize_and_import import _chem_fixture, _ego
from test_bio_featurize_and_import import _fake_pyg_data_cls
from test_featurize_gated import fake_rdkit  # noqa: F401  (a fixture)

FEAT = {"jax": jfeat, "torch": tfeat}


@pytest.fixture
def rdkit(fake_rdkit, monkeypatch):  # noqa: F811
    """``fake_rdkit`` with what the standardisation, Gasteiger, Morgan and
    ``graph_to_mol`` helpers call besides: ``MolToSmiles(...,
    isomericSmiles=)``, ``MolToInchi``, ``GetNumAtoms``,
    ``rdPartialCharges``, ``rdMolDescriptors`` and an ``RWMol``."""
    chem = fake_rdkit["_chem"]
    allchem = sys.modules["rdkit.Chem.AllChem"]
    to_smiles = lambda m, isomericSmiles=True: m.smiles  # noqa: E731
    for mod in (chem, allchem):
        monkeypatch.setattr(mod, "MolToSmiles", to_smiles)
    monkeypatch.setattr(allchem, "MolToInchi", lambda m: "InChI=" + m.smiles,
                        raising=False)
    monkeypatch.setattr(gated._Mol, "GetNumAtoms",
                        lambda self: len(self.atoms), raising=False)

    def gasteiger(mol, nIter=12, throwOnParamFailure=True):
        for i, a in enumerate(mol.atoms):
            a.props = {"_GasteigerCharge": repr(0.125 * (i + 1) - nIter)}

    monkeypatch.setattr(gated._Atom, "GetProp",
                        lambda self, key: self.props[key], raising=False)
    charges = types.ModuleType("rdkit.Chem.rdPartialCharges")
    charges.ComputeGasteigerCharges = gasteiger
    descriptors = types.ModuleType("rdkit.Chem.rdMolDescriptors")
    descriptors.GetMorganFingerprintAsBitVect = (
        lambda mol, radius, nBits: [
            int((i * 7 + len(mol.atoms) * radius) % 5 == 0)
            for i in range(nBits)])

    class RWMol:
        def __init__(self):
            self.atoms, self.bonds = [], []

        def AddAtom(self, atom):
            self.atoms.append(atom)
            return len(self.atoms) - 1

        def AddBond(self, i, j, bond_type):
            self.bonds.append(gated._Bond(i, j, bond_type,
                                          chem.rdchem.BondDir.NONE))
            return len(self.bonds)

        def GetBondWithIdx(self, idx):
            return self.bonds[idx]

        def GetMol(self):
            return gated._Mol(self.atoms, self.bonds, "rw")

    def set_dir(self, d):
        self._bd = d

    def set_tag(self, tag):
        self._c = tag

    monkeypatch.setattr(gated._Bond, "SetBondDir", set_dir, raising=False)
    monkeypatch.setattr(gated._Atom, "SetChiralTag", set_tag, raising=False)
    monkeypatch.setattr(chem, "RWMol", RWMol, raising=False)
    monkeypatch.setattr(
        chem, "Atom",
        lambda num: gated._Atom(num, chem.rdchem.ChiralType.CHI_UNSPECIFIED),
        raising=False)
    for name, mod in (("rdkit.Chem.rdPartialCharges", charges),
                      ("rdkit.Chem.rdMolDescriptors", descriptors)):
        monkeypatch.setitem(sys.modules, name, mod)
        monkeypatch.setattr(chem, name.rsplit(".", 1)[1], mod, raising=False)
    return fake_rdkit


def _mol(registry, smiles, n_atoms, mw=300.0):
    """A registered chain with every chirality tag, bond type and bond
    direction of the schema along it."""
    c = registry["_chem"].rdchem
    tags = [c.ChiralType.CHI_UNSPECIFIED, c.ChiralType.CHI_TETRAHEDRAL_CW,
            c.ChiralType.CHI_TETRAHEDRAL_CCW, c.ChiralType.CHI_OTHER]
    types_ = [c.BondType.SINGLE, c.BondType.DOUBLE, c.BondType.TRIPLE,
              c.BondType.AROMATIC]
    dirs = [c.BondDir.NONE, c.BondDir.ENDUPRIGHT, c.BondDir.ENDDOWNRIGHT]
    atoms = [gated._Atom(6 + i % 3, tags[i % 4]) for i in range(n_atoms)]
    bonds = [gated._Bond(i, i + 1, types_[i % 4], dirs[i % 3])
             for i in range(n_atoms - 1)]
    registry[smiles] = gated._Mol(atoms, bonds, smiles, mw)
    return registry[smiles]


def _assert_same_store(a, b):
    """Two processed directories: the same npz arrays and text files."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    za, zb = np.load(os.path.join(a, "data.npz")), np.load(
        os.path.join(b, "data.npz"))
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k])
    for name in os.listdir(a):
        if name != "data.npz":
            with open(os.path.join(a, name)) as fa, \
                    open(os.path.join(b, name)) as fb:
                assert fa.read() == fb.read(), name


# --- label coding and the spec table -----------------------------------------


def test_label_coding_and_spec_table_equal_jax():
    df = pd.DataFrame({"smiles": ["C", "CC", "CCC"],
                       "A": [1.0, 0.0, np.nan], "B": [0.0, np.nan, 1.0],
                       "expt": [-3.2, 0.5, 1.25]})
    specs = [
        tfeat.CsvSpec("x.csv", "smiles", ["A", "B"], "binary"),
        tfeat.CsvSpec("x.csv", "smiles", ["A"], "binary", fillna=False),
        tfeat.CsvSpec("x.csv", "smiles", None, "binary"),
        tfeat.CsvSpec("x.csv", "smiles", ["expt"], "regression"),
    ]
    for spec in specs:
        jspec = jfeat.CsvSpec(**vars(spec))
        got, want = tfeat.encode_labels(df, spec), jfeat.encode_labels(
            df, jspec)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert {k: vars(v) for k, v in tfeat.CSV_SPECS.items()} == {
        k: vars(v) for k, v in jfeat.CSV_SPECS.items()}
    assert (tfeat.TOX21_TASKS, tfeat.MUV_TASKS, tfeat.NUM_BOND_FEATURES) == (
        jfeat.TOX21_TASKS, jfeat.MUV_TASKS, jfeat.NUM_BOND_FEATURES)
    if "rdkit" not in sys.modules:
        with pytest.raises(ImportError, match="RDKit is required"):
            tfeat.mol_to_graph(None)


# --- the dataset dispatch ----------------------------------------------------


def _csv_rows(name, spec, rng):
    tasks = list(spec.tasks) if spec.tasks is not None else ["t1", "t2"]
    smiles = ["CCO", "BAD", "CCCC", "C=CN"]
    rows = []
    for s in smiles:
        if spec.coding == "binary":
            vals = rng.choice(["0", "1", ""], size=len(tasks))
        else:
            vals = [f"{v:.3f}" for v in rng.normal(size=len(tasks))]
        rows.append([s, *vals])
    return [spec.smiles_col, *tasks], rows


def _write_raw(root, name, registry):
    """The raw files of ``name`` under ``root``, in the reference's
    layout, with valid and invalid molecules."""
    for s, n, mw in (("CCO", 3, 60.0), ("CCCC", 4, 58.0), ("C=CN", 5, 43.0),
                     ("KEEP", 3, 300.0), ("HEAVY", 3, 1200.0),
                     ("LIGHT", 2, 10.0), ("A.B", 4, 300.0),
                     ("LEAK", 3, 300.0)):
        _mol(registry, s, n, mw)
    registry["BAD"] = None
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(len(name))
    if name in tfeat.CSV_SPECS:
        spec = tfeat.CSV_SPECS[name]
        header, rows = _csv_rows(name, spec, rng)
        with open(os.path.join(raw, spec.raw_file), "w") as f:
            f.write("\n".join(",".join(r) for r in [header, *rows]) + "\n")
    elif name == "zinc_standard_agent":
        with gzip.open(os.path.join(raw, "zinc_combined_apr_8_2019.csv.gz"),
                       "wt") as f:
            f.write("zinc_id,smiles\nZINC000001234567,CCO\nZINC00000089,BAD"
                    "\nZINC000000000042,CCCC\n")
    elif name == "mutag":
        with open(os.path.join(raw, "mutag_188_data.can"), "w") as f:
            f.write("CCO 1\nBAD 2\nCCCC 3\n")
        with open(os.path.join(raw, "mutag_188_target.txt"), "w") as f:
            f.write("1\n-1\n-1\n")
    elif name == "ptc_mr":
        with open(os.path.join(raw, "ptc_MR.csv"), "w") as f:
            f.write("m1,1,CCO\nm2,-1,BAD\nm3,-1,C=CN\n")
    else:  # pcba, pcba_pretrain
        with open(os.path.join(raw, "pcba.csv"), "w") as f:
            f.write("mol_id,smiles,PCBA-1,PCBA-2\nm0,KEEP,1,0\nm1,HEAVY,0,1\n"
                    "m2,LIGHT,1,\nm3,A.B,0,0\nm4,LEAK,1,1\nm5,CCO,,1\n")
        with open(os.path.join(root, name,
                               "downstream_mol_inchi_may_24_2019"), "w") as f:
            f.write("InChI=LEAK\n")


DISPATCH = sorted(tfeat.CSV_SPECS) + [
    "zinc_standard_agent", "mutag", "ptc_mr", "pcba", "pcba_pretrain"]


@pytest.mark.parametrize("name", DISPATCH)
def test_process_dataset_equals_jax(rdkit, tmp_path, name):
    """Each dataset of the dispatch (chembl_filtered below): the same raw
    files through both packages give the same store."""
    out = {}
    for package, feat in FEAT.items():
        root = str(tmp_path / package)
        _write_raw(root, name, rdkit)
        n = feat.process_dataset(name, root)
        out[package] = (n, tdatasets.processed_dir(root, name))
    assert out["jax"][0] == out["torch"][0] > 0
    _assert_same_store(out["jax"][1], out["torch"][1])
    graphs, _, meta = tdatasets.load_dataset(name, str(tmp_path / "torch"))
    if name == "zinc_standard_agent":
        assert [int(g.y[0]) for g in graphs] == [1234567, 42]
    if name == "pcba_pretrain":  # single species, MW in range, not leaked
        assert len(graphs) == 2 and meta["num_tasks"] == 2
    if name == "bace":
        assert [g.num_nodes for g in graphs] == [3, 4, 5]


def test_chembl_filtered_equals_jax(rdkit, tmp_path, monkeypatch):
    """The supervised set drops molecules that match a downstream
    dataset's validation or test scaffold-split members, and those outside
    MW [50, 900]; a train member's duplicate stays."""
    down_smiles = [f"D{i}" for i in range(10)]
    for s in down_smiles:
        _mol(rdkit, s, 3)
    scaffolds = ["s0"] * 6 + ["s1"] * 2 + ["s2"] * 2
    down = str(tmp_path / "down" / "processed_tpu")
    dgraphs, _ = jsyn.molecule_dataset(10, num_tasks=1, seed=0)
    jdatasets.save_graphs(dgraphs, down, scaffolds=scaffolds,
                          smiles=down_smiles, meta={"num_tasks": 1})
    tr, va, te = splitters.scaffold_split(scaffolds)
    leak = down_smiles[(list(va) + list(te))[0]]
    train = down_smiles[list(tr)[0]]
    _mol(rdkit, "FRESH", 4, mw=200)
    _mol(rdkit, "HEAVY", 3, mw=2000)
    mols = [rdkit["FRESH"], rdkit[leak], rdkit[train], rdkit["HEAVY"], None]
    labels = np.array([[1, -1], [1, 0], [0, 1], [1, 1], [0, 0]], np.float64)
    out = {}
    for package, feat in FEAT.items():
        monkeypatch.setattr(
            feat, "_load_chembl_raw",
            lambda root: ([m.smiles if m else None for m in mols], mols,
                          labels))
        root = str(tmp_path / package)
        out[package] = feat.process_chembl_filtered(root, [down])
    assert out["jax"] == out["torch"] == 2
    _assert_same_store(*(tdatasets.processed_dir(str(tmp_path / p),
                                                 "chembl_filtered")
                         for p in FEAT))
    with open(os.path.join(tdatasets.processed_dir(
            str(tmp_path / "torch"), "chembl_filtered"), "smiles.txt")) as f:
        assert f.read().split("\n") == ["FRESH", train]


def test_load_chembl_raw_reads_the_reference_pickles(rdkit, tmp_path):
    """The ChEMBL-with-labels pickles (chem/loader.py:1179-1256): a sparse
    {-1, 0, +1} target matrix and the molecules, None where RDKit failed."""
    raw = tmp_path / "chembl_filtered" / "raw"
    raw.mkdir(parents=True)
    dense = np.array([[1, 0, -1], [0, 0, 1]], np.float32)
    mols = [_mol(rdkit, "CCO", 3), None]
    with open(raw / "folds0.pckl", "wb") as f:
        pickle.dump([np.array([0]), np.array([1])], f)
    with open(raw / "labelsHard.pckl", "wb") as f:
        pickle.dump(sp.csr_matrix(dense), f)
        pickle.dump(np.arange(3), f)
        pickle.dump(None, f)
    with open(raw / "chembl20LSTM.pckl", "wb") as f:
        pickle.dump(np.array(mols, dtype=object), f)
    smiles, got_mols, labels = tfeat._load_chembl_raw(str(tmp_path))
    assert smiles == ["CCO", None] and got_mols[1] is None
    np.testing.assert_array_equal(labels, dense)


# --- the helpers -------------------------------------------------------------


def test_mol_helpers_equal_jax(rdkit):
    mol = _mol(rdkit, "CCN", 6)
    _mol(rdkit, "C", 1)
    _mol(rdkit, "CCCC", 4)
    _mol(rdkit, "C.CCCC", 5)
    got, want = tfeat.mol_to_graph(mol), jfeat.mol_to_graph(mol)
    for field in ("node_feat", "edge_index", "edge_feat"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.node_feat[:, 1].tolist() == [0, 1, 2, 3, 0, 1]
    np.testing.assert_array_equal(got.edge_index[:, 0::2],
                                  got.edge_index[::-1, 1::2])
    # graph -> mol -> graph, both packages
    back = {p: f.mol_to_graph(f.graph_to_mol(got)) for p, f in FEAT.items()}
    for g in back.values():
        for field in ("node_feat", "edge_index", "edge_feat"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(got, field))
    empty = tfeat.mol_to_graph(gated._Mol([], [], "", 0.0))
    assert empty.edge_index.shape == (2, 0) and empty.edge_feat.shape == (0, 2)
    for s in ("CCN", "BAD", "C.CCCC", "NOPE"):
        rdkit.setdefault("BAD", None)
        assert tfeat.check_smiles_validity(s) == jfeat.check_smiles_validity(s)
        assert (tfeat.create_standardized_mol_id(s)
                == jfeat.create_standardized_mol_id(s))
    # a mixture's largest species
    assert tfeat.create_standardized_mol_id("C.CCCC") == "InChI=CCCC"
    assert tfeat.generate_scaffold("CCN") == jfeat.generate_scaffold("CCN")
    assert (tfeat.get_gasteiger_partial_charges(mol, n_iter=5)
            == jfeat.get_gasteiger_partial_charges(mol, n_iter=5))
    for radius, size in ((2, 64), (3, 2048)):
        a = tfeat.morgan_fingerprint(mol, radius, size)
        b = jfeat.morgan_fingerprint(mol, radius, size)
        assert a.dtype == b.dtype == np.int8
        np.testing.assert_array_equal(a, b)


def test_networkx_helpers_equal_jax():
    x = np.array([[5, 0], [7, 1], [5, 2], [6, 0]], np.int64)
    ei = np.array([[0, 1, 1, 2, 2, 3], [1, 0, 2, 1, 3, 2]], np.int64)
    ea = np.array([[0, 0], [0, 0], [1, 2], [1, 2], [3, 1], [3, 1]], np.int64)
    g = Graph(x, ei, ea)
    G = tfeat.graph_to_nx_simple(g)
    J = jfeat.graph_to_nx_simple(g)
    assert list(G.nodes(data=True)) == list(J.nodes(data=True))
    assert list(G.edges(data=True)) == list(J.edges(data=True))
    a, b = tfeat.nx_to_graph_simple(G), jfeat.nx_to_graph_simple(J)
    for field in ("node_feat", "edge_index", "edge_feat"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        np.testing.assert_array_equal(getattr(a, field), getattr(g, field))
    lone = nx.Graph()
    lone.add_node(0, atom_num_idx=5, chirality_tag_idx=0)
    assert tfeat.nx_to_graph_simple(lone).edge_index.shape == (2, 0)


def test_fingerprints_build_and_load_equal_jax(rdkit, tmp_path):
    out = {}
    for package, fp in (("jax", jfp), ("torch", tfp)):
        root = str(tmp_path / package)
        _write_raw(root, "bbbp", rdkit)
        n = fp.build("bbbp", root, radius=2, size=128)
        out[package] = (n, *fp.load("bbbp", root))
        with open(os.path.join(root, "bbbp", "processed_fp_tpu",
                               "smiles.txt")) as f:
            out[package] += (f.read(),)
    (n, fps, labels, smiles), want = out["torch"], out["jax"]
    assert n == want[0] == 3 and smiles == want[3]
    assert fps.shape == (3, 128) and fps.dtype == want[1].dtype
    np.testing.assert_array_equal(fps, want[1])
    np.testing.assert_array_equal(labels, want[2])


# --- bio ---------------------------------------------------------------------


def test_bio_featurize_equals_jax(tmp_path):
    egos = [_ego() for _ in range(3)]
    g, center = egos[0]
    lone = nx.Graph()
    lone.add_node("7.Q0")
    down = [f"GO:{i}" for i in range(5)]
    pre = [f"GO:{i}" for i in range(8)]
    labels = {center: ["GO:1", "GO:3", "GO:7"]}
    for args in ((g, center), (g, center, down, pre, labels),
                 (g, center, down, pre, {"other": ["GO:1"]}),
                 (lone, "7.Q0")):
        a, b = tbio.nx_to_graph(*args), jbio.nx_to_graph(*args)
        for field in ("node_feat", "edge_index", "edge_feat"):
            va, vb = getattr(a, field), getattr(b, field)
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)
        assert (a.y is None) == (b.y is None)
        if a.y is not None:
            np.testing.assert_array_equal(a.y, b.y)
        assert a.extras.keys() == b.extras.keys()
        for k in a.extras:
            assert a.extras[k][1] == b.extras[k][1]
            np.testing.assert_array_equal(a.extras[k][0], b.extras[k][0])
        ta, tb = tbio.graph_to_nx(a), jbio.graph_to_nx(b)
        assert list(ta.edges(data=True)) == list(tb.edges(data=True))
    assert int(tbio.nx_to_graph(lone, "7.Q0").extras["species_id"][0][0]) == 7
    assert tbio.SUPERVISED_SPECIES == jbio.SUPERVISED_SPECIES
    assert tbio.UNSUPERVISED_SPECIES == jbio.UNSUPERVISED_SPECIES
    assert len(tbio.UNSUPERVISED_SPECIES) == 50
    outs = []
    for mod, sub in ((jbio, "jax"), (tbio, "torch")):
        d = str(tmp_path / sub)
        n = mod.process_bio_dataset([e for e, _ in egos], [c for _, c in egos],
                                    d, down, pre, labels,
                                    data_type="supervised")
        outs.append((n, d))
    assert outs[0][0] == outs[1][0] == 3
    _assert_same_store(outs[0][1], outs[1][1])
    graphs, _, meta = tdatasets.load_graphs(outs[1][1])
    assert meta["domain"] == "bio" and meta["num_tasks"] == 5
    assert graphs[0].y.tolist() == [0, 1, 0, 1, 0]


# --- the reference's processed files -----------------------------------------


def _bio_fixture(path, legacy):
    Data = _fake_pyg_data_cls()
    d = Data()
    d.x = torch.ones(7, 1)
    d.edge_index = torch.tensor(
        [[0, 1, 1, 2, 0, 1, 2, 3], [1, 0, 2, 1, 1, 0, 3, 2]])
    ea = torch.zeros(8, 9)
    ea[:, 0] = 1
    ea[2:4, 6] = 1
    d.edge_attr = ea
    d.center_node_idx = torch.tensor([0, 1])
    d.species_id = torch.tensor([9606, 10090])
    d.go_target_downstream = torch.tensor([0.0, 1.0, 1.0, 0.0])
    d.go_target_pretrain = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    slices = {
        "x": torch.tensor([0, 3, 7]),
        "edge_index": torch.tensor([0, 4, 8]),
        "edge_attr": torch.tensor([0, 4, 8]),
        "center_node_idx": torch.tensor([0, 1, 2]),
        "species_id": torch.tensor([0, 1, 2]),
        "go_target_downstream": torch.tensor([0, 2, 4]),
        "go_target_pretrain": torch.tensor([0, 3, 6]),
    }
    torch.save((d, slices), path, _use_new_zipfile_serialization=not legacy)


@pytest.mark.parametrize("legacy", [True, False],
                         ids=["legacy", "zip"])
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_import_pyg_equals_jax(tmp_path, domain, legacy):
    """``load_pyg_processed``, ``pyg_to_graphs`` and ``import_processed``
    against the JAX importer on the same file; ``cli.featurize
    --import_pyg`` writes the same store (with ``--smiles_csv`` for
    chem)."""
    pt = str(tmp_path / "geometric_data_processed.pt")
    (_chem_fixture if domain == "chem" else _bio_fixture)(pt, legacy)
    arrays, bounds = timport.load_pyg_processed(pt)
    jarrays, jbounds = jimport.load_pyg_processed(pt)
    assert arrays.keys() == jarrays.keys() and bounds.keys() == jbounds.keys()
    for k in arrays:
        assert arrays[k].dtype == jarrays[k].dtype
        np.testing.assert_array_equal(arrays[k], jarrays[k])
    for k in bounds:
        np.testing.assert_array_equal(bounds[k], jbounds[k])
    graphs, tasks, dom = timport.pyg_to_graphs(arrays, bounds)
    jgraphs, jtasks, jdom = jimport.pyg_to_graphs(jarrays, jbounds)
    assert (tasks, dom) == (jtasks, jdom) and dom == domain
    assert len(graphs) == len(jgraphs) == 2
    csv = None
    if domain == "chem":
        csv = str(tmp_path / "smiles.csv")
        with open(csv, "w") as f:
            f.write("CCO\nCC\n")
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jimport.import_processed(pt, jout, "toy", smiles_csv=csv) == 2
    assert timport.import_processed(pt, tout, "toy", smiles_csv=csv) == 2
    _assert_same_store_but_origin(jout, tout)
    # the CLI, into <root>/<dataset>/processed_tpu
    argv = ["--import_pyg", pt, "--dataset", "toy", "--root",
            str(tmp_path / "root")]
    feat_cli.main(argv + (["--smiles_csv", csv] if csv else []))
    _assert_same_store_but_origin(
        jout, tdatasets.processed_dir(str(tmp_path / "root"), "toy"))
    got, _, meta = tdatasets.load_dataset("toy", str(tmp_path / "root"))
    assert meta["domain"] == domain and len(got) == 2


def _assert_same_store_but_origin(a, b):
    """As :func:`_assert_same_store`, with meta.json read as JSON and its
    ``imported_from`` (the absolute path of the file read) the same."""
    with open(os.path.join(a, "meta.json")) as fa, \
            open(os.path.join(b, "meta.json")) as fb:
        ma, mb = json.load(fa), json.load(fb)
    assert ma == mb
    tmp = b + "_meta_checked"
    shutil.copytree(b, tmp)
    shutil.copy(os.path.join(a, "meta.json"), os.path.join(tmp, "meta.json"))
    _assert_same_store(a, tmp)


class _Payload:
    """A class the import allow-list does not name: unpickling it would
    run ``__setstate__``."""

    ran = []

    def __setstate__(self, state):
        _Payload.ran.append(state)


def _payload_reduce():
    _Payload.ran.append("reduce")
    return "ran"


class _Reducer:
    def __reduce__(self):
        return (_payload_reduce, ())


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "zip"])
@pytest.mark.parametrize("kind", ["class", "callable"])
def test_import_refuses_other_classes_and_runs_no_code(tmp_path, kind,
                                                       legacy):
    """A processed file that names anything outside the allow-list (here a
    class with ``__setstate__``, or a function pickled to be called) raises
    ``UnpicklingError`` and runs none of it; the allow-listed ``Data`` is
    an inert attribute bag."""
    Data = _fake_pyg_data_cls()
    d = Data()
    d.x = torch.ones(2, 1)
    bad = _Payload() if kind == "class" else _Reducer()
    if kind == "class":
        bad.payload = 1
    d.payload = bad
    pt = str(tmp_path / "evil.pt")
    torch.save((d, {"x": torch.tensor([0, 2])}), pt,
               _use_new_zipfile_serialization=not legacy)
    _Payload.ran.clear()
    with pytest.raises(pickle.UnpicklingError):
        timport.load_pyg_processed(pt)
    with pytest.raises(pickle.UnpicklingError):
        feat_cli.main(["--import_pyg", pt, "--dataset", "evil", "--root",
                       str(tmp_path)])
    assert _Payload.ran == []
    assert not os.path.exists(tdatasets.processed_dir(str(tmp_path), "evil"))
    assert "__setstate__" not in vars(timport.PygData)
