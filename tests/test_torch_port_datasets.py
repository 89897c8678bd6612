"""The on-disk dataset store (data/datasets.py of the port against
``pretrain_gnns_tpu.data.datasets``) and ``--data_root`` in both CLIs.

Either package reads the directory the other wrote, to equal arrays: chem
with scaffolds and smiles, bio with a node-index extra and graph extras.
``merge_graph_datasets`` and ``load_dataset`` (``synthetic``,
``synthetic_bio`` and a stored name) equal the JAX functions'. Then
``cli.pretrain`` and ``cli.finetune`` train on a stored dataset through
``--data_root``, the scaffold split read from its ``scaffolds.txt``.

Every file is one the test writes; 2 layers, emb 16. Tolerance: arrays,
dtypes, labels, scaffolds, smiles and meta exactly equal; a CLI run on a
stored dataset exactly the run on the same graphs in memory. About 10 s
alone."""

import json
import os

import numpy as np
import pytest

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import datasets as jdatasets
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu_torch.cli import finetune as ft_cli
from pretrain_gnns_tpu_torch.cli import pretrain as pt_cli
from pretrain_gnns_tpu_torch.core import graphs as tg
from pretrain_gnns_tpu_torch.data import datasets as tdatasets
from pretrain_gnns_tpu_torch.data import splitters
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.train import pretrain

PACKAGES = {"jax": (jdatasets, jsyn, jg), "torch": (tdatasets, tsyn, tg)}
SMALL = ["--device", "cpu", "--num_layer", "2", "--emb_dim", "16",
         "--batch_size", "16", "--epochs", "1"]


def _dataset(package, domain, n=24):
    """``(graphs, scaffolds, smiles, meta)`` of one package's generator;
    bio graphs carry ``center_node_idx`` (a node index) and the graph
    extras ``species_id`` and ``go_target_pretrain``."""
    _, syn, _ = PACKAGES[package]
    if domain == "bio":
        return (syn.bio_dataset(n, seed=3), None, None,
                {"num_tasks": 40, "domain": "bio"})
    graphs, scaffolds = syn.molecule_dataset(n, num_tasks=3, seed=3,
                                             mean_atoms=12)
    return (graphs, scaffolds, [f"C{i}O" for i in range(n)],
            {"num_tasks": 3, "dataset": "toy"})


def _assert_same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for field in ("node_feat", "edge_index", "edge_feat"):
            va, vb = getattr(ga, field), getattr(gb, field)
            assert va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)
        assert (ga.y is None) == (gb.y is None)
        if ga.y is not None:
            assert ga.y.dtype == gb.y.dtype
            np.testing.assert_array_equal(ga.y, gb.y)
        assert ga.extras.keys() == gb.extras.keys()
        for k, (va, kind) in ga.extras.items():
            vb, kind_b = gb.extras[k]
            assert kind == kind_b and va.dtype == vb.dtype
            np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_either_package_reads_the_others_store(tmp_path, domain, writer,
                                               reader):
    graphs, scaffolds, smiles, meta = _dataset(writer, domain)
    d = str(tmp_path / "processed_tpu")
    PACKAGES[writer][0].save_graphs(graphs, d, scaffolds=scaffolds,
                                    smiles=smiles, meta=meta)
    got, got_scaffolds, got_meta = PACKAGES[reader][0].load_graphs(d)
    want, want_scaffolds, want_meta = PACKAGES[writer][0].load_graphs(d)
    _assert_same_graphs(got, graphs)
    _assert_same_graphs(got, want)
    assert got_scaffolds == want_scaffolds == scaffolds
    assert got_meta == want_meta and got_meta["num_graphs"] == len(graphs)
    if domain == "bio":
        assert got_meta["extra_kinds"] == {
            "center_node_idx": tg.NODE_IDX, "go_target_pretrain": tg.GRAPH,
            "species_id": tg.GRAPH}
    else:
        with open(os.path.join(d, "smiles.txt")) as f:
            assert f.read().split("\n") == smiles


def test_the_same_files_from_either_writer(tmp_path):
    """The port writes the JAX package's files: the same npz entries,
    meta.json and text files."""
    out = {}
    for package in PACKAGES:
        graphs, scaffolds, smiles, meta = _dataset(package, "chem")
        d = str(tmp_path / package)
        PACKAGES[package][0].save_graphs(graphs, d, scaffolds=scaffolds,
                                         smiles=smiles, meta=meta)
        z = np.load(os.path.join(d, "data.npz"))
        out[package] = ({k: z[k] for k in z.files},
                        *(open(os.path.join(d, n)).read()
                          for n in ("meta.json", "scaffolds.txt",
                                    "smiles.txt")))
    (ja, *jtext), (ta, *ttext) = out["jax"], out["torch"]
    assert ja.keys() == ta.keys() and jtext == ttext
    for k in ja:
        assert ja[k].dtype == ta[k].dtype
        np.testing.assert_array_equal(ja[k], ta[k])


def test_merge_graph_datasets_equals_jax():
    a = {p: PACKAGES[p][1].molecule_dataset(5, num_tasks=3, seed=1)[0]
         for p in PACKAGES}
    b = {p: PACKAGES[p][1].molecule_dataset(4, num_tasks=2, seed=2)[0]
         for p in PACKAGES}
    got = tdatasets.merge_graph_datasets(a["torch"], b["torch"])
    want = jdatasets.merge_graph_datasets(a["jax"], b["jax"])
    _assert_same_graphs(got, want)
    assert got[0].y.shape == (5,) and got[-1].y[:3].tolist() == [0, 0, 0]


@pytest.mark.parametrize("name", ["synthetic", "synthetic_bio", "tox21"])
def test_load_dataset_equals_jax(tmp_path, name):
    """The registry: the synthetic stand-ins, and a stored dataset whose
    meta.json lacks a task count (the reference's count, 12 for tox21)."""
    root = str(tmp_path)
    if name == "tox21":
        graphs, scaffolds, smiles, _ = _dataset("jax", "chem")
        jdatasets.save_graphs(graphs, jdatasets.processed_dir(root, name),
                              scaffolds=scaffolds, smiles=smiles)
    got = tdatasets.load_dataset(name, root, 96, seed=5)
    want = jdatasets.load_dataset(name, root, 96, seed=5)
    _assert_same_graphs(got[0], want[0])
    assert got[1:] == want[1:]
    assert tdatasets.CHEM_NUM_TASKS == jdatasets.CHEM_NUM_TASKS
    assert tdatasets.processed_dir(root, name) == jdatasets.processed_dir(
        root, name)
    if name == "tox21":
        assert got[2]["num_tasks"] == 12
    with pytest.raises(FileNotFoundError,
                       match="pretrain_gnns_tpu_torch.cli.featurize"):
        tdatasets.load_dataset("bbbp", root)


def _store(root, name, domain, n):
    graphs, scaffolds, smiles, meta = _dataset("torch", domain, n)
    tdatasets.save_graphs(graphs, tdatasets.processed_dir(root, name),
                          scaffolds=scaffolds, smiles=smiles, meta=meta)
    return graphs, scaffolds


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_cli_pretrain_on_a_stored_dataset(tmp_path, domain):
    """``--dataset <name> --data_root <root>`` trains on the stored graphs:
    the history of ``run_pretrain`` on the same graphs in memory."""
    graphs, _ = _store(str(tmp_path), "stored", domain, 48)
    history = pt_cli.main([*SMALL, "--domain", domain, "--dataset",
                           "stored", "--data_root", str(tmp_path)])
    # the CLI's --mask_edge defaults to 0
    cfg = pretrain.PretrainConfig(domain=domain, num_layer=2, emb_dim=16,
                                  batch_size=16, epochs=1, mask_edge=False)
    want = pretrain.run_pretrain(cfg, graphs, log=None, device="cpu")
    assert history == want["history"] and history[0]["steps"] == 3
    # --dataset synthetic means synthetic_bio under --domain bio, as in the
    # JAX CLI
    if domain == "bio":
        history = pt_cli.main([*SMALL, "--domain", "bio", "--n_synthetic",
                               "256"])
        assert history[0]["steps"] == 64 // 16


def test_cli_finetune_on_a_stored_dataset(tmp_path):
    """``cli.finetune --dataset <name> --data_root <root>``: the task count
    from meta.json, the scaffold split from the stored scaffolds.txt."""
    graphs, scaffolds = _store(str(tmp_path), "stored", "chem", 64)
    seen = {}
    real = ft_cli.split_dataset

    def split_dataset(args, g, s):
        seen["scaffolds"], seen["n"] = s, len(g)
        return real(args, g, s)

    ft_cli.split_dataset = split_dataset
    try:
        out = ft_cli.main([*SMALL, "--dataset", "stored", "--data_root",
                           str(tmp_path), "--run_dir", str(tmp_path / "run")])
    finally:
        ft_cli.split_dataset = real
    assert seen == {"scaffolds": scaffolds, "n": 64}
    tr, va, te = splitters.scaffold_split(scaffolds)
    with open(tmp_path / "run" / "stored_seed0" / "result.json") as f:
        res = json.load(f)
    assert res["dataset"] == "stored" and len(res["val"]) == 1
    assert out["best_epoch"] == 1 and len(tr) + len(va) + len(te) == 64
    assert ft_cli.build_parser().parse_args([]).data_root == "dataset"
    assert pt_cli.build_parser().parse_args([]).data_root == "dataset"
