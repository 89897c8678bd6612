"""Step checkpoints with resume (train/checkpoints.CheckpointManager,
``TrainState.state_dict``/``load_state_dict``, ``run_pretrain(
checkpoint_dir=, checkpoint_every=)``, ``cli.pretrain --checkpoint_dir``).

A resumed run must equal the uninterrupted run bit for bit (``torch.equal``
on every parameter, batch-norm statistic, Adam moment and step, the dropout
generators' states, the history rows of the resumed epochs and the written
trunk): the loader starts at the resumed epoch, which the JAX package's
resume does not do (its loader starts over at the first epoch's order,
ROADMAP F11). The JAX package's own contract
(``tests/test_pipeline.py::test_epoch_mode_checkpoint_resume``: the resumed
history's epochs and the final step count) is held by both packages.

Sizes: 2 layers, emb 16, 64 graphs, batches of 16 (4 steps an epoch), the
CPU. About 25 s alone."""

import copy
import os
import re
import zipfile

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.core.graphs import PackedPair
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.train import checkpoints, optim, pretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, GRAPHS = 2, 16, 16, 64

# (objective, domain, dropout): the trunk and transform kinds a resume
# must carry over; supervised with dropout carries the mask generators,
# contextpred two trunks and a context variant chosen by epoch
CASES = {
    "chem masking": ("masking", "chem", 0.0),
    "bio masking": ("masking", "bio", 0.0),
    "chem supervised dropout": ("supervised", "chem", 0.2),
    "chem contextpred": ("contextpred", "chem", 0.0),
}


def _graphs(domain):
    if domain == "bio":
        return tsyn.bio_dataset(GRAPHS, seed=0)
    return tsyn.molecule_dataset(GRAPHS, num_tasks=3, seed=0,
                                 mean_atoms=12)[0]


def _cfg(objective="masking", domain="chem", dropout=0.0, scan_steps=1):
    return pretrain.PretrainConfig(
        objective=objective, domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, dropout_ratio=dropout, num_tasks=3,
        scan_steps=scan_steps, csize=2)


def _assert_same_state(a, b):
    """Two ``TrainState.state_dict()``s, bit for bit."""
    assert sorted(a) == sorted(b)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
    assert a["model"].keys() == b["model"].keys()
    for name, t in a["model"].items():
        assert torch.equal(t, b["model"][name]), name
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for name in sa[i]:
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)
    assert a["dropout"].keys() == b["dropout"].keys()
    for name in a["dropout"]:
        da, db = a["dropout"][name], b["dropout"][name]
        assert da.keys() == db.keys()
        for dev in da:
            assert torch.equal(da[dev], db[dev]), (name, dev)


def _trunk(res, cfg, path):
    checkpoints.save_trunk_reference_format(
        pretrain.trunk_module(res["model"], pretrain.trunk_path(cfg)), path)
    return checkpoints.load_trunk_any(path)


@pytest.mark.parametrize("scan_steps", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_equals_the_uninterrupted_run(tmp_path, case, scan_steps):
    """3 epochs in one run against 2 epochs with a checkpoint each epoch,
    then a fresh run to 3 from the same directory. At ``scan_steps`` 4 the
    resumed epoch starts with the warm-up's eager steps, where the
    uninterrupted run's third epoch is one group: the same steps."""
    objective, domain, dropout = CASES[case]
    cfg = _cfg(objective, domain, dropout, scan_steps)
    graphs = _graphs(domain)
    if objective == "supervised":
        graphs, cfg.num_tasks = pretrain.supervised_graphs(graphs, domain)
    if objective == "contextpred":
        graphs = pretrain.presample_context(cfg, graphs)
    whole = pretrain.run_pretrain(cfg, graphs, log=None, epochs=3,
                                  device="cpu")
    ck = str(tmp_path / "ck")
    first = pretrain.run_pretrain(cfg, graphs, log=None, epochs=2,
                                  device="cpu", checkpoint_dir=ck,
                                  checkpoint_every=1)
    assert [h["epoch"] for h in first["history"]] == [1, 2]
    logs = []
    resumed = pretrain.run_pretrain(cfg, graphs, log=logs.append, epochs=3,
                                    device="cpu", checkpoint_dir=ck,
                                    checkpoint_every=1)
    steps = whole["state"].step
    assert steps == 3 * (GRAPHS // BATCH) and resumed["state"].step == steps
    assert logs[0] == f"resumed from step {2 * steps // 3} (epoch 3)"
    assert resumed["start_epoch"] == 3
    assert resumed["history"] == whole["history"][2:]
    _assert_same_state(resumed["state"].state_dict(),
                       whole["state"].state_dict())
    if dropout:  # the mask generator's state came along
        assert resumed["state"].state_dict()["dropout"]["pred.gnn"]
    ta = _trunk(whole, cfg, tmp_path / "whole.pth")
    tb = _trunk(resumed, cfg, tmp_path / "resumed.pth")
    assert ta.keys() == tb.keys()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    # the directory holds epochs 1-3, the newest three steps
    mgr = checkpoints.CheckpointManager(ck)
    assert mgr.all_steps() == [steps // 3, 2 * steps // 3, steps]


def _state(cfg):
    model = pretrain.build_objective(cfg)
    return TrainState(model, optim.adam(model.parameters(), cfg.lr))


def _trained(epochs=1, dropout=0.0):
    cfg = _cfg("supervised", dropout=dropout)
    graphs, cfg.num_tasks = pretrain.supervised_graphs(_graphs("chem"),
                                                       "chem")
    return pretrain.run_pretrain(cfg, graphs, log=None, epochs=epochs,
                                 device="cpu")["state"], cfg


def test_manager_save_latest_restore_and_retention(tmp_path):
    state, cfg = _trained(dropout=0.2)
    mgr = checkpoints.CheckpointManager(tmp_path / "ck")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(cfg))
    saved = {}
    for step in range(1, 6):
        state.step = step
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        mgr.save(step, state)
        saved[step] = copy.deepcopy(state.state_dict())
    names = sorted(os.listdir(mgr.directory))
    assert names == [f"step_{s:09d}.pt" for s in (3, 4, 5)]
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    for step in (4, None):
        fresh = _state(cfg)
        assert mgr.restore(fresh, step) is fresh
        _assert_same_state(fresh.state_dict(), saved[step or 5])
    mgr.close()


def test_partial_and_stray_files_are_not_steps(tmp_path):
    state, cfg = _trained()
    mgr = checkpoints.CheckpointManager(tmp_path)
    mgr.save(4, state)
    whole = open(mgr.path(4), "rb").read()
    assert zipfile.is_zipfile(mgr.path(4))
    # a write cut short under a step's name, an interrupted write's
    # temporary file and files of other names
    with open(mgr.path(9), "wb") as f:
        f.write(whole[: len(whole) // 2])
    with open(os.path.join(mgr.directory, ".step_x1y2.tmp"), "wb") as f:
        f.write(whole)
    for name in ("step_7.pt.tmp", "step_x.pt", "notes.txt"):
        with open(os.path.join(mgr.directory, name), "wb") as f:
            f.write(whole)
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    mgr.restore(_state(cfg))
    # a save leaves no temporary file behind
    mgr.save(5, state)
    assert not [n for n in os.listdir(mgr.directory)
                if re.match(r"^\.step_.*\.tmp$", n) and n != ".step_x1y2.tmp"]


def test_restore_raises_on_another_model_or_a_missing_entry(tmp_path):
    state, cfg = _trained()
    mgr = checkpoints.CheckpointManager(tmp_path)
    mgr.save(4, state)
    wider = _cfg("supervised")
    wider.emb_dim, wider.num_tasks = EMB + 2, cfg.num_tasks
    with pytest.raises(RuntimeError, match="size mismatch"):
        mgr.restore(_state(wider))
    deeper = _cfg("supervised")
    deeper.num_layer, deeper.num_tasks = LAYERS + 1, cfg.num_tasks
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        mgr.restore(_state(deeper))
    saved = state.state_dict()
    fresh = _state(cfg)
    for drop in ("optimizer", "dropout"):
        with pytest.raises(KeyError):
            fresh.load_state_dict({k: v for k, v in saved.items()
                                   if k != drop})
    missing = dict(saved, model={k: v for k, v in saved["model"].items()
                                 if "graph_pred_linear" not in k})
    with pytest.raises(RuntimeError, match="Missing key"):
        fresh.load_state_dict(missing)
    moments = {i: dict(m) for i, m in saved["optimizer"]["state"].items()}
    moments[0]["exp_avg"] = moments[0]["exp_avg"][:1]
    with pytest.raises(ValueError, match="shape"):
        fresh.load_state_dict(dict(saved, optimizer=dict(
            saved["optimizer"], state=moments)))


def test_a_card_checkpoint_continues_on_the_cpu(tmp_path):
    """A file written on the card carries ``capturable=True`` Adam groups
    and CUDA dropout generators. Restored on the CPU, the run keeps its own
    groups' flags (capturable Adam raises on CPU parameters) and takes the
    moments and step counts; the CUDA generator's state is left out, so
    the CPU masks start from the seed."""
    state, cfg = _trained(dropout=0.2)
    saved = state.state_dict()
    card = dict(saved, optimizer=dict(
        saved["optimizer"], param_groups=[
            dict(g, capturable=True)
            for g in saved["optimizer"]["param_groups"]]),
        dropout={"pred.gnn": {"cuda:0": torch.tensor(
            [7, 0, 0, 0, 0, 0, 0, 0, 16, 0, 0, 0, 0, 0, 0, 0],
            dtype=torch.uint8)}})
    path = tmp_path / "step_000000004.pt"
    torch.save(card, path)
    fresh = _state(cfg)
    checkpoints.CheckpointManager(tmp_path).restore(fresh)
    assert not any(g["capturable"] for g in fresh.optimizer.param_groups)
    got = fresh.optimizer.state_dict()["state"]
    for i, m in saved["optimizer"]["state"].items():
        for name, t in m.items():
            assert torch.equal(got[i][name], t)
    assert fresh.state_dict()["dropout"]["pred.gnn"] == {}
    graphs, _ = pretrain.supervised_graphs(_graphs("chem"), "chem")
    batch = next(iter(pretrain.build_loader(cfg, graphs, "cpu")))
    loss, _ = pretrain.train_step(fresh, batch.to("cpu"))
    assert np.isfinite(float(loss)) and fresh.step == state.step + 1


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_resume_contract_of_the_jax_package(tmp_path, package):
    """``tests/test_pipeline.py:141-166``: an interrupted run of 2 epochs,
    resumed to 4 from the same directory, logs a resume, trains epochs
    [3, 4] and ends at the uninterrupted run's step count, in either
    package."""
    if package == "jax":
        from pretrain_gnns_tpu.data.synthetic import molecule_dataset
        from pretrain_gnns_tpu.train import pretrain as run

        cfg = run.PretrainConfig(objective="masking", num_layer=LAYERS,
                                 emb_dim=EMB, batch_size=BATCH,
                                 mask_edge=False, seed=0, scan_steps=1,
                                 packing="standard")
        kw = {}
    else:
        molecule_dataset, run = tsyn.molecule_dataset, pretrain
        cfg = _cfg(scan_steps=1)
        kw = {"device": "cpu"}
    graphs, _ = molecule_dataset(GRAPHS, num_tasks=1, seed=0, mean_atoms=12)
    ck = str(tmp_path / "ck")
    r1 = run.run_pretrain(cfg, graphs, log=None, epochs=2,
                          checkpoint_dir=ck, checkpoint_every=1, **kw)
    steps_per_epoch = GRAPHS // BATCH
    assert int(r1["state"].step) == 2 * steps_per_epoch
    logs = []
    r2 = run.run_pretrain(cfg, graphs, log=logs.append, epochs=4,
                          checkpoint_dir=ck, checkpoint_every=1, **kw)
    assert any("resumed" in s for s in logs)
    assert [h["epoch"] for h in r2["history"]] == [3, 4]
    assert int(r2["state"].step) == 4 * steps_per_epoch


def test_cli_resume(tmp_path, capsys):
    """``cli.pretrain --checkpoint_dir D --checkpoint_every 1 --epochs 2``,
    then ``--epochs 3`` in the same directory: the log names the resume and
    the trunk equals an uninterrupted 3-epoch run's."""
    flags = ["--device", "cpu", "--num_layer", str(LAYERS), "--emb_dim",
             str(EMB), "--batch_size", str(BATCH), "--n_synthetic",
             str(GRAPHS), "--dropout_ratio", "0.2"]
    whole = cli.main([*flags, "--epochs", "3", "--output_model_file",
                      str(tmp_path / "whole")])
    ck = ["--checkpoint_dir", str(tmp_path / "ck"), "--checkpoint_every",
          "1"]
    cli.main([*flags, *ck, "--epochs", "2"])
    capsys.readouterr()
    resumed = cli.main([*flags, *ck, "--epochs", "3", "--output_model_file",
                        str(tmp_path / "resumed")])
    out = capsys.readouterr().out
    assert "resumed from step 8 (epoch 3)" in out
    assert resumed == whole[2:]
    a, b = (checkpoints.load_trunk_any(tmp_path / f"{n}.pth")
            for n in ("whole", "resumed"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    parser = cli.build_parser()
    assert (parser.parse_args([]).checkpoint_dir,
            parser.parse_args([]).checkpoint_every) == ("", 0)


def test_cpu_batches_own_their_memory():
    """``PackedGraphs.to("cpu")`` copies every leaf into torch's memory:
    MKL's products on rows at numpy's alignment vary in their last bits
    with the host's allocation history, and a resumed run would not repeat
    the uninterrupted one."""
    cfg = _cfg(domain="bio")
    host = next(iter(pretrain.build_loader(cfg, _graphs("bio"), "cpu")))
    for batch in (host, PackedPair(host, host)):
        on_cpu = batch.to("cpu")
        for name, t in on_cpu.leaves().items():
            src = batch.leaves()[name]
            assert isinstance(t, torch.Tensor)
            assert t.data_ptr() != src.__array_interface__["data"][0], name
            assert t.data_ptr() % 64 == 0, name
            np.testing.assert_array_equal(t.numpy(), src)
