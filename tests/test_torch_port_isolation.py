"""The PyTorch port stands alone: no module of pretrain_gnns_tpu_torch and
not chip_smoke.py imports jax, flax, optax, orbax, pretrain_gnns_tpu or
sklearn (the splitters keep their own copy of its stratified folds);
its entry points (pretraining and fine-tuning, each function and CLI) run
on CUDA unless asked for the CPU; its CLI trains and saves a
reference-layout trunk (for context prediction the substructure trunk,
``gnn_substruct``)."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.models import bio
from pretrain_gnns_tpu_torch.models.chem import GNN
from pretrain_gnns_tpu_torch.objectives.contextpred import (
    ContextPredObjective,
)
from pretrain_gnns_tpu_torch.train import pretrain

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "pretrain_gnns_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pretrain_gnns_tpu",
             "sklearn"}


def _sources():
    return (sorted(PKG.rglob("*.py"))
            + sorted((ROOT / "scripts").glob("torch_port_*.py"))
            + [ROOT / "chip_smoke.py"])


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_forbidden_imports_in_sources():
    files = _sources()
    assert len(files) > 20
    scanned = {str(p.relative_to(ROOT)) for p in files}
    assert {"pretrain_gnns_tpu_torch/native/__init__.py",
            "pretrain_gnns_tpu_torch/ops/edge_dot.py",
            "pretrain_gnns_tpu_torch/objectives/edgepred.py",
            "pretrain_gnns_tpu_torch/ops/attention.py",
            "pretrain_gnns_tpu_torch/ops/gat_conv.py",
            "pretrain_gnns_tpu_torch/ops/sorted_spmm.py",
            "pretrain_gnns_tpu_torch/models/pools.py",
            "pretrain_gnns_tpu_torch/objectives/supervised.py",
            "pretrain_gnns_tpu_torch/data/splitters.py",
            "pretrain_gnns_tpu_torch/train/metrics.py",
            "pretrain_gnns_tpu_torch/train/finetune.py",
            "pretrain_gnns_tpu_torch/train/checkpoints.py",
            "pretrain_gnns_tpu_torch/cli/finetune.py",
            "pretrain_gnns_tpu_torch/parallel/__init__.py",
            "pretrain_gnns_tpu_torch/parallel/dp.py",
            "pretrain_gnns_tpu_torch/parallel/mesh.py",
            "pretrain_gnns_tpu_torch/parallel/multihost.py",
            "scripts/torch_port_kernel_micro.py",
            "scripts/torch_port_multihost_smoke.py",
            "scripts/torch_port_profile.py",
            "chip_smoke.py"} <= scanned
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pretrain_gnns_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import torch_port_kernel_micro\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_pretrain_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    graphs, _ = molecule_dataset(16)
    cfg = pretrain.PretrainConfig(num_layer=2, emb_dim=16, batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.run_pretrain(cfg, graphs, log=None, epochs=1)


def test_finetuning_defaults_to_cuda():
    """``run_finetune`` and ``cli.finetune`` without ``device`` (the CLI's
    default ``--device cuda``) raise where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    from pretrain_gnns_tpu_torch.cli import finetune as ft_cli
    from pretrain_gnns_tpu_torch.train import finetune

    graphs, _ = molecule_dataset(24, num_tasks=2)
    cfg = finetune.FinetuneConfig(num_tasks=2, num_layer=2, emb_dim=16,
                                  epochs=1, batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.run_finetune(cfg, graphs[:16], graphs[16:20], graphs[20:],
                              log=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft_cli.main(["--num_layer", "2", "--emb_dim", "16", "--epochs", "1",
                     "--n_synthetic", "32"])


def test_standard_packing_and_unported_options():
    graphs, _ = molecule_dataset(8)
    cfg = pretrain.PretrainConfig(num_layer=2, emb_dim=16, batch_size=8,
                                  packing="standard")
    batch = next(iter(pretrain.build_loader(cfg, graphs,
                                            torch.device("cpu"))))
    assert batch.block_nodes == 0
    # context prediction builds in both domains: two trunks, the context
    # trunk csize deep in chem and 3 deep in bio
    for domain, gnn_type, depth in (("chem", "gcn", 2), ("chem", "gin", 2),
                                    ("bio", "gin", 3)):
        model = pretrain.build_objective(pretrain.PretrainConfig(
            objective="contextpred", domain=domain, gnn_type=gnn_type,
            num_layer=3, emb_dim=16, csize=2))
        assert isinstance(model, ContextPredObjective)
        assert isinstance(model.gnn_substruct,
                          bio.GNN if domain == "bio" else GNN)
        assert (model.gnn_substruct.num_layer,
                model.gnn_context.num_layer) == (3, depth)
    with pytest.raises(NotImplementedError, match="not ported"):
        pretrain.build_objective(pretrain.PretrainConfig(domain="dna"))


def test_cli_trains_one_epoch_on_cpu(tmp_path):
    out = tmp_path / "trunk"
    history = cli.main([
        "--device", "cpu", "--epochs", "1", "--num_layer", "2",
        "--emb_dim", "32", "--batch_size", "16", "--n_synthetic", "64",
        "--output_model_file", str(out),
    ])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] == 4 and history[0]["edges"] > 0
    trunk = torch.load(str(out) + ".pth")
    GNN(num_layer=2, emb_dim=32).load_state_dict(trunk, strict=True)


@pytest.mark.parametrize("flags", [["--dataset", "bbbp"],
                                   ["--objective", "supervised",
                                    "--gnn_type", "gine"]])
def test_cli_rejects_what_is_not_ported(flags, tmp_path):
    """A conv family the port lacks exits; a dataset name that is not
    stored under ``--data_root`` raises, naming the port's featurizer."""
    argv = ["--device", "cpu", "--epochs", "1", "--data_root",
            str(tmp_path), *flags]
    if flags[0] == "--dataset":
        with pytest.raises(FileNotFoundError,
                           match="pretrain_gnns_tpu_torch.cli.featurize"):
            cli.main(argv)
    else:
        with pytest.raises(SystemExit, match="not ported"):
            cli.main(argv)


@pytest.mark.parametrize("domain,mode", [("chem", "cbow"),
                                         ("chem", "skipgram"),
                                         ("bio", "cbow"),
                                         ("bio", "skipgram")])
def test_cli_trains_contextpred_on_cpu(tmp_path, domain, mode):
    """One CPU epoch of ``--objective contextpred``; the saved trunk is
    ``gnn_substruct`` and loads strictly into the domain's trunk."""
    out = tmp_path / "trunk"
    history = cli.main([
        "--objective", "contextpred", "--domain", domain, "--mode", mode,
        "--device", "cpu", "--epochs", "1", "--num_layer", "3",
        "--csize", "2", "--emb_dim", "16", "--batch_size", "16",
        "--n_synthetic", "64", "--output_model_file", str(out)])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] >= 2 and history[0]["edges"] > 0
    assert 0.0 <= history[0]["acc"] <= 1.0
    trunk = torch.load(str(out) + ".pth")
    (bio.GNN if domain == "bio" else GNN)(
        num_layer=3, emb_dim=16).load_state_dict(trunk, strict=True)


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
