"""Two data-parallel ranks of the port's ``run_pretrain`` (gloo, one
subprocess a rank, scripts/torch_port_multihost_smoke.py) against the JAX
``run_pretrain(dp_devices=2)`` on a 2-device mesh of tests/conftest.py's
virtual CPU devices, and a resumed 2-rank run against an uninterrupted
one.

- Three epochs from the JAX run's initial weights: chem masking per step
  (``device_dataset="off"``, eager steps and the host loader, rank r
  training on batch ``2g + r``), chem masking in the epoch trainer
  (``device_dataset="on"``, ``scan_steps=2``: the descriptors' columns,
  ``shard_cols``), bio masking per step and supervised chem per step.
  Per-epoch losses within TRAJ_TOL (rtol 2e-4, atol 2e-5,
  tests/test_torch_trajectory.py:202); ``edges`` and ``steps`` count every
  column's batches of the whole groups, as the single-process loader's
  batches give them (and, in the epoch trainer, as the JAX history's
  ``edges``). The JAX run draws its first batch before its first epoch
  (ROADMAP F11), so the ranks' loaders start one pass on.
- Three epochs with a checkpoint each (the epoch trainer, atoms drawn in
  the step, dropout 0.2, so that each rank's streams matter), against two
  epochs and a resumed third from rank 0's checkpoint: bit for bit.

Sizes: 2 layers, emb 16, batches of 16 graphs, 96 graphs (three
data-parallel steps an epoch); the JAX side in float32 on XLA."""

import contextlib
import json
import sys

import jax
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.telemetry import ThroughputMeter
from test_torch_port_dp import (
    SMOKE, np_tree, rank_env, run_ranks, store, write_worker,
)

LAYERS, EMB, BATCH, GRAPHS, EPOCHS = 2, 16, 16, 96, 3
TRAJ_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_trajectory.py:202
CPU = torch.device("cpu")

# the smoke script with the JAX run's initial weights and its loader one
# pass on (F11)
RUN_WORKER = """
import torch
from pretrain_gnns_tpu_torch.train import pretrain as tp

weights = torch.load(os.environ["PORT_INIT"], weights_only=True)
build_objective, build_loader = tp.build_objective, tp.build_loader


def objective(cfg):
    model = build_objective(cfg)
    model.load_state_dict(weights, strict=True)
    return model


def loader(*a, **k):
    out = build_loader(*a, **k)
    start = out.set_epoch
    out.set_epoch = lambda e: start(e + 1)
    return out


tp.build_objective, tp.build_loader = objective, loader
from scripts.torch_port_multihost_smoke import main
main(sys.argv[1:])
"""


@contextlib.contextmanager
def jax_float32():
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend("xla")
    jspmm.set_compute_dtype("float32")
    try:
        yield
    finally:
        jspmm.set_backend(backend)
        jspmm.set_compute_dtype(dtype)


def _graphs(domain, objective, lib):
    graphs = (lib.bio_dataset(GRAPHS, seed=0) if domain == "bio" else
              lib.molecule_dataset(GRAPHS, num_tasks=1, seed=0,
                                   mean_atoms=18)[0])
    if objective != "supervised":
        return graphs, 1
    return tpretrain.supervised_graphs(graphs, domain)


def _cfg(lib, objective, domain, tasks, **kw):
    return lib.PretrainConfig(
        objective=objective, domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, mask_edge=False, num_tasks=tasks,
        packing="standard", transform_device="batch", **kw)


def _jax_initial_variables(jcfg, jgraphs):
    """The variables the JAX ``run_pretrain`` starts from: its key split,
    initialised on its loader's first batch (a device loader's first
    descriptor's batch)."""
    loader = jpretrain.build_loader(jcfg, jgraphs)
    first = next(iter(loader))
    if hasattr(loader, "prepare"):
        first = loader.prepare(first)
    first = first if isinstance(first, tuple) else (first,)
    model = jpretrain.build_objective(jcfg)
    _, init_rng, mask_rng = jax.random.split(
        jax.random.PRNGKey(jcfg.seed), 3)
    variables = dict(model.init({"params": init_rng, "mask": mask_rng},
                                *first, train=False))
    variables.setdefault("batch_stats", {})
    return variables


def _column_counts(cfg, graphs, world=2):
    """Each epoch's (edges, steps) of whole groups of ``world`` batches of
    the single-process loader, passes 1..EPOCHS (the JAX run's)."""
    loader = tpretrain.build_loader(cfg, graphs, CPU)
    out = []
    for epoch in range(1, EPOCHS + 1):
        loader.set_epoch(epoch)
        counts = [ThroughputMeter.counts_of(b) for b in loader]
        n = len(counts) // world * world
        out.append((sum(c["edges"] for c in counts[:n]), n))
    return out


def _two_ranks(tmp_path, flags, env=None, tag="run"):
    out = str(tmp_path / tag)
    at = store(tmp_path)
    run_ranks([[sys.executable, *flags, "--device", "cpu", "--coordinator",
                at, "--num_processes", "2", "--process_id", str(r),
                "--num_layer", str(LAYERS), "--emb_dim", str(EMB),
                "--batch_size", str(BATCH), "--n_graphs", str(GRAPHS)]
               + (["--out", out] if r == 0 else []) for r in (0, 1)],
              [rank_env(**(env or {}))] * 2)
    with open(out + ".json") as f:
        return json.load(f), dict(np.load(out + ".npz"))


RUNS = {
    "chem_masking_per_step": ("masking", "chem",
                              dict(device_dataset="off", scan_steps=1)),
    "chem_masking_epoch_trainer": ("masking", "chem",
                                   dict(device_dataset="on", scan_steps=2)),
    "bio_masking_per_step": ("masking", "bio",
                             dict(device_dataset="off", scan_steps=1)),
    "chem_supervised_per_step": ("supervised", "chem",
                                 dict(device_dataset="off", scan_steps=1)),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_two_ranks_match_jax_run_pretrain_dp(tmp_path, case):
    objective, domain, kw = RUNS[case]
    jgraphs, tasks = _graphs(domain, objective, jsyn)
    tgraphs, _ = _graphs(domain, objective, tsyn)
    jcfg = _cfg(jpretrain, objective, domain, tasks, dp_devices=2, **kw)
    with jax_float32():
        variables = _jax_initial_variables(jcfg, jgraphs)
        jres = jpretrain.run_pretrain(jcfg, jgraphs, log=None,
                                      epochs=EPOCHS)
    torch.save(state_dict_from_jax(np_tree(variables["params"]),
                                   np_tree(variables["batch_stats"])),
               tmp_path / "init.pt")
    worker = write_worker(tmp_path, RUN_WORKER)
    hist, _ = _two_ranks(
        tmp_path, [worker, "--objective", objective, "--domain", domain,
                   "--epochs", str(EPOCHS), "--device_dataset",
                   kw["device_dataset"], "--scan_steps",
                   str(kw["scan_steps"])],
        env={"PORT_INIT": tmp_path / "init.pt"})
    jh = jres["history"]
    assert len(hist["losses"]) == len(jh) == EPOCHS
    assert len({round(x, 6) for x in hist["losses"]}) > 1  # it moved
    np.testing.assert_allclose(hist["losses"], [h["loss"] for h in jh],
                               **TRAJ_TOL)
    want = _column_counts(_cfg(tpretrain, objective, domain, tasks, **kw),
                          tgraphs)
    assert list(zip(hist["edges"], hist["steps"])) == want
    if kw["device_dataset"] == "on":
        assert hist["edges"] == [h["edges"] for h in jh]
        assert hist["replays"] > 0


def _same_streams(a, b):
    """Two ``TrainState.dropout_states()`` alike, generator for
    generator."""
    flat = [[t for name in sorted(d) for _, t in sorted(d[name].items())]
            for d in (a, b)]
    return len(flat[0]) == len(flat[1]) > 0 and all(
        torch.equal(x, y) for x, y in zip(*flat))


def test_resumed_two_rank_run_is_bit_equal(tmp_path):
    """Rank 0 writes each epoch's checkpoint with both ranks' random
    streams; a 2-rank run of two epochs resumed for a third equals three
    uninterrupted epochs bit for bit (rank 0's parameters, statistics and
    the third epoch's loss)."""
    flags = [SMOKE, "--transform_device", "device", "--dropout_ratio",
             "0.2", "--scan_steps", "2", "--checkpoint_every", "1"]
    full, full_sd = _two_ranks(
        tmp_path, flags + ["--epochs", "3", "--checkpoint_dir",
                           str(tmp_path / "a")], tag="full")
    part = flags + ["--checkpoint_dir", str(tmp_path / "b")]
    _two_ranks(tmp_path, part + ["--epochs", "2"], tag="part")
    saved = torch.load(sorted((tmp_path / "b").glob("step_*.pt"))[-1],
                       weights_only=True)
    ranks = saved["rank_dropout"]
    assert len(ranks) == 2 and _same_streams(ranks[0], saved["dropout"])
    assert not _same_streams(ranks[1], ranks[0])
    resumed, resumed_sd = _two_ranks(tmp_path, part + ["--epochs", "3"],
                                     tag="resumed")
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["edges"] == full["edges"][2:]
    assert sorted(resumed_sd) == sorted(full_sd)
    for name, v in full_sd.items():
        np.testing.assert_array_equal(resumed_sd[name], v, err_msg=name)
