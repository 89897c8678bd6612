"""The device-resident dataset's run on the CPU (train/pretrain.py:
use_device_dataset, the device branches of build_loader, the epoch
trainer run_epoch_mode and resolve_epoch_group; cli/pretrain.py's
--device_dataset).

- The epoch trainer (``scan_steps`` 4, ``epoch_group`` 1 and 2, epochs
  padded to ``steps_cap`` and epochs that overflow it) equals per-step
  mode (``scan_steps`` 1) bit for bit: history, parameters, statistics
  (after tests/test_epoch_scan.py).
- A 4-epoch ``device_dataset="on"`` run matches the JAX ``run_pretrain``
  with ``device_dataset="on"`` from the same initial weights, for chem
  masking (``batch``), bio masking, edge prediction (the C++ sampler's
  negatives in the descriptors), infomax, supervised and context
  prediction: losses rtol 2e-4, atol 2e-5
  (tests/test_torch_trajectory.py:202).
- A resumed epoch-trainer run equals an uninterrupted one bit for bit,
  the mask stream of ``transform_device="device"`` included.
- The loaders, the resolution and the CLI flags against the JAX package's.

Sizes: 2 layers, emb 16, batches of 8 graphs; the JAX side in float32
on XLA."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.cli import pretrain as jcli
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu_torch.cli import pretrain as tcli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import device_pack
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.telemetry import seconds_between

LAYERS, EMB, BATCH = 2, 16, 8
TRAJ_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_trajectory.py:202
CPU = torch.device("cpu")


def _graphs(domain, lib, n=48):
    if domain == "bio":
        return lib.bio_dataset(n, seed=1)
    return lib.molecule_dataset(n, seed=1)[0]


def _cfg(lib, objective="masking", domain="chem", **kw):
    return lib.PretrainConfig(
        objective=objective, domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, csize=2,
        **{"packing": "standard", "device_dataset": "on", **kw})


def _same_runs(a, b):
    assert a["history"] == b["history"]
    ref = a["model"].state_dict()
    for name, v in b["model"].state_dict().items():
        assert torch.equal(v, ref[name]), name


# --- the epoch trainer against per-step mode ---------------------------------

@pytest.mark.parametrize("shift", [0, 2, -2], ids=["exact", "padded",
                                                    "overflow"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("objective,domain,kw", [
    ("masking", "chem", dict(mask_edge=True)),
    ("masking", "chem", dict(transform_device="device")),
    ("edgepred", "bio", dict(packing="blocked",
                             transform_device="device")),
    ("contextpred", "chem", {}),
])
def test_epoch_trainer_equals_per_step(monkeypatch, objective, domain, kw,
                                       group, shift):
    """Three epochs at ``scan_steps`` 4 through the epoch trainer against
    ``scan_steps`` 1, bit for bit. ``shift`` moves ``steps_cap`` (the
    loader's length) off the epochs' batch counts: their stacks are
    padded with steps that are not launched, or their surplus runs as
    overflow right after them."""
    graphs = _graphs(domain, tsyn)
    per_step = tpretrain.run_pretrain(
        _cfg(tpretrain, objective, domain, scan_steps=1, **kw), graphs,
        log=None, epochs=3, device="cpu")
    stacks = []
    for cls in (device_pack.DeviceBatchLoader,
                tpretrain.DeviceContextLoader):
        length, stack = cls.__len__, cls.epoch_stack
        monkeypatch.setattr(cls, "__len__",
                            lambda self, f=length: max(f(self) + shift, 1))
        monkeypatch.setattr(
            cls, "epoch_stack",
            lambda self, *a, f=stack, **k: stacks.append(f(self, *a, **k))
            or stacks[-1])
    logged = []
    grouped = tpretrain.run_pretrain(
        _cfg(tpretrain, objective, domain, scan_steps=4, epoch_group=group,
             **kw), graphs, log=logged.append, epochs=3, device="cpu")
    assert grouped["replays"] > 0 and len(stacks) == 3
    if shift > 0:
        assert not all(s["valid"].all() for s in stacks)
    if shift < 0:
        assert all(s["overflow"] for s in stacks)
    assert "epoch trainer" in logged[0] and len(logged) == 4
    _same_runs(per_step, grouped)


@pytest.mark.parametrize("scan_steps,group,epochs,want", [
    (1, 0, 3, [1, 2, 3]),  # the per-step loop: a mark an epoch
    (4, 1, 3, [1, 2, 3]),
    (4, 2, 5, [2, 4, 5]),  # the epoch trainer: a mark a group
], ids=["per_step", "group1", "group2"])
def test_run_marks_each_epoch_or_group(scan_steps, group, epochs, want):
    """``run_pretrain``'s ``marks`` close the epochs or the groups the
    trainer queued (the last group short), count the replays queued
    before them, and on the CPU hold no event and stand in time order;
    ``epoch_group`` names the epoch trainer's group, None for the
    per-step loop."""
    res = tpretrain.run_pretrain(
        _cfg(tpretrain, scan_steps=scan_steps, epoch_group=group),
        _graphs("chem", tsyn), log=None, epochs=epochs, device="cpu")
    marks = res["marks"]
    assert [m.epoch for m in marks] == want
    assert res["epoch_group"] == (group if scan_steps > 1 else None)
    replays = [m.replays for m in marks]
    assert replays == sorted(replays) and replays[-1] == res["replays"]
    assert all(m.event is None for m in marks)
    assert all(seconds_between(a, b) >= 0 for a, b in zip(marks, marks[1:]))


def test_resolve_epoch_group_matches_jax():
    for cap in (1, 16, 32, 100, 300):
        assert tpretrain.resolve_epoch_group(0, cap, "cpu") == (
            jpretrain.resolve_epoch_group(0, cap)) == 1
        assert tpretrain.resolve_epoch_group(0, cap, "cuda") == max(
            1, min(8, 256 // cap))
        assert tpretrain.resolve_epoch_group(3, cap, "cuda") == 3


# --- resume -------------------------------------------------------------------

@pytest.mark.parametrize("transform", ["batch", "device"])
def test_resumed_epoch_trainer_is_bit_equal(tmp_path, transform):
    """Three epochs with a checkpoint each epoch, against two epochs and a
    fresh call to three from the same directory: the resumed run logs its
    resume, takes pass 2 of the loader (``set_epoch``) and the saved mask
    stream, and ends where the uninterrupted run ended, bit for bit."""
    graphs = _graphs("chem", tsyn)
    cfg = _cfg(tpretrain, scan_steps=4, epoch_group=2,
               transform_device=transform)
    full = tpretrain.run_pretrain(cfg, graphs, log=None, epochs=3,
                                  device="cpu",
                                  checkpoint_dir=str(tmp_path / "a"),
                                  checkpoint_every=1)
    tpretrain.run_pretrain(cfg, graphs, log=None, epochs=2, device="cpu",
                           checkpoint_dir=str(tmp_path / "b"),
                           checkpoint_every=1)
    logged = []
    resumed = tpretrain.run_pretrain(cfg, graphs, log=logged.append,
                                     epochs=3, device="cpu",
                                     checkpoint_dir=str(tmp_path / "b"),
                                     checkpoint_every=1)
    assert resumed["start_epoch"] == 3 and logged[0].startswith(
        "resumed from step")
    assert resumed["history"] == full["history"][2:]
    ref = full["model"].state_dict()
    for name, v in resumed["model"].state_dict().items():
        assert torch.equal(v, ref[name]), name
    assert resumed["state"].step == full["state"].step


# --- against the JAX run_pretrain ---------------------------------------------

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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(objective, domain, syn):
    """The run's graphs (three batches' worth for context prediction, whose
    graphs without a context drop out) and its task count; the supervised
    labels moved into ``y`` by the port's ``supervised_graphs``, on either
    package's graphs."""
    graphs = _graphs(domain, syn, 3 * BATCH if objective == "contextpred"
                     else BATCH)
    if objective != "supervised":
        return graphs, {}
    graphs, tasks = tpretrain.supervised_graphs(graphs, domain)
    return graphs, {"num_tasks": tasks}


TRAJECTORIES = [("masking", "chem"), ("masking", "bio"),
                ("edgepred", "chem"), ("infomax", "bio"),
                ("supervised", "chem"), ("contextpred", "chem")]


@pytest.mark.parametrize("objective,domain", TRAJECTORIES)
def test_trajectory_matches_jax_run_pretrain(monkeypatch, objective,
                                             domain):
    """Four epochs through both ``run_pretrain``s with ``device_dataset=
    "on"`` from the JAX run's initial weights (its key split, initialised
    on its first descriptor's batch): the per-epoch losses. The JAX run
    draws its first descriptor before its first epoch (ROADMAP F11), so
    its epoch E takes the loader's pass E; the port's loader is started
    one pass on to match."""
    jgraphs, extra = _data(objective, domain, jsyn)
    tgraphs, _ = _data(objective, domain, tsyn)
    jcfg = _cfg(jpretrain, objective, domain, **extra)
    cfg = _cfg(tpretrain, objective, domain, **extra)
    with jax_float32():
        jm = jpretrain.build_objective(jcfg)
        loader = jpretrain.build_loader(jcfg, jgraphs)
        assert type(loader).__name__.startswith("Device")
        out = loader.prepare(next(iter(loader)))
        out = out if isinstance(out, tuple) else (out,)
        rng, init_rng, mask_rng = jax.random.split(
            jax.random.PRNGKey(jcfg.seed), 3)
        variables = dict(jm.init({"params": init_rng, "mask": mask_rng},
                                 *out, train=False))
        variables.setdefault("batch_stats", {})
        jres = jpretrain.run_pretrain(jcfg, jgraphs, log=None, epochs=4)
    build_loader, build_objective = (tpretrain.build_loader,
                                     tpretrain.build_objective)

    def port_model(c):
        model = build_objective(c)
        model.load_state_dict(state_dict_from_jax(
            _np_tree(variables["params"]),
            _np_tree(variables["batch_stats"])), strict=True)
        return model

    def one_pass_on(*a, **k):
        loader = build_loader(*a, **k)
        assert type(loader).__name__.startswith("Device")
        start = loader.set_epoch
        loader.set_epoch = lambda e: start(e + 1)
        return loader

    monkeypatch.setattr(tpretrain, "build_objective", port_model)
    monkeypatch.setattr(tpretrain, "build_loader", one_pass_on)
    tres = tpretrain.run_pretrain(cfg, tgraphs, log=None, epochs=4,
                                  device="cpu")
    th, jh = tres["history"], jres["history"]
    assert len(th) == len(jh) == 4 and all(h["steps"] for h in th)
    assert len({round(h["loss"], 6) for h in th}) > 1  # it moved
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], **TRAJ_TOL)


# --- the loaders, the resolution and the CLI ---------------------------------

@pytest.mark.parametrize("objective,domain", [
    (o, d) for o in tpretrain.PORTED_OBJECTIVES for d in ("chem", "bio")])
def test_device_loaders_and_resolution_match_jax(objective, domain):
    """``use_device_dataset`` on the CPU as the JAX function resolves it
    there for every choice ("auto" off, "host" transforms off), and the
    loader ``build_loader`` picks, by class, for "on"."""
    for choice in tpretrain.DEVICE_DATASETS:
        for transform in ("batch", "device"):
            kw = dict(device_dataset=choice, transform_device=transform)
            assert tpretrain.use_device_dataset(
                _cfg(tpretrain, objective, domain, **kw), CPU) == (
                jpretrain.use_device_dataset(
                    _cfg(jpretrain, objective, domain, **kw)))
    assert not tpretrain.use_device_dataset(
        _cfg(tpretrain, objective, domain, transform_device="host"), CPU)
    assert not tpretrain.use_device_dataset(
        _cfg(tpretrain, objective, domain, device_dataset="auto"), CPU)
    graphs, extra = _data(objective, domain, tsyn)
    jgraphs, _ = _data(objective, domain, jsyn)
    t = tpretrain.build_loader(_cfg(tpretrain, objective, domain, **extra),
                               graphs, CPU)
    j = jpretrain.build_loader(_cfg(jpretrain, objective, domain, **extra),
                               jgraphs)
    assert type(t).__name__ == type(j).__name__


def test_unflattened_graphs_fall_back_and_say_why(capsys):
    graphs = _graphs("chem", tsyn, 16)
    graphs[0].extras = {"odd": (np.zeros(3), "raw")}
    with pytest.warns(UserWarning, match="do not flatten"):
        loader = tpretrain.build_loader(_cfg(tpretrain), graphs, CPU)
    assert not type(loader).__name__.startswith("Device")
    assert "device-resident dataset unavailable" in capsys.readouterr().out


def test_cli_flags_match_jax():
    """``--device_dataset``, ``--transform_device`` and ``--dp_devices``:
    the JAX CLI's types, choices and defaults."""
    for dest in ("device_dataset", "transform_device", "dp_devices"):
        t, j = (next(a for a in p._actions if a.dest == dest)
                for p in (tcli.build_parser(), jcli.build_parser()))
        assert (t.default, t.type, t.choices and list(t.choices)) == (
            j.default, j.type, j.choices and list(j.choices))
    assert tcli.build_parser().parse_args([]).device_dataset == "auto"
    assert tcli.build_parser().parse_args([]).dp_devices == 1
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--device_dataset", "maybe"])


@pytest.mark.parametrize("flags", [
    ["--device_dataset", "on", "--scan_steps", "4"],
    ["--device_dataset", "on", "--transform_device", "device"],
    ["--device_dataset", "off", "--transform_device", "device"],
    ["--device_dataset", "auto", "--objective", "edgepred",
     "--transform_device", "device", "--packing", "blocked"],
])
def test_cli_runs_on_cpu(tmp_path, flags):
    history = tcli.main([
        "--device", "cpu", "--epochs", "1", "--num_layer", str(LAYERS),
        "--emb_dim", str(EMB), "--batch_size", str(BATCH),
        "--n_synthetic", "64", "--output_model_file", str(tmp_path / "t"),
        *flags])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] >= 3 and history[0]["edges"] > 0


# --- the fine-tuning scan step ------------------------------------------------

def test_finetune_scan_step_and_stack_batches():
    """``make_scan_train_step``: K = 2 fine-tune steps a call on the CPU
    equal two eager ``make_train_step`` steps bit for bit (losses,
    parameters, statistics); ``stack_batches`` stacks every leaf as the
    JAX ``stack_batches`` does."""
    from pretrain_gnns_tpu.core import graphs as jg
    from pretrain_gnns_tpu.train import finetune as jft
    from pretrain_gnns_tpu_torch.data.packing import make_loader
    from pretrain_gnns_tpu_torch.train import finetune as tft

    graphs = tsyn.molecule_dataset(32, num_tasks=3, seed=1)[0]
    batches = list(make_loader(graphs, BATCH, 512, 1024, seed=0))[:2]
    cfg = tft.FinetuneConfig(num_layer=LAYERS, emb_dim=EMB, num_tasks=3)
    losses, states = [], []
    for scan in (False, True):
        model = tft.build_model(cfg)
        state = tft.init_state(cfg, model, device="cpu")
        if scan:
            step = tft.make_scan_train_step(state, batches[0], 2)
            out = step([b.to(CPU) for b in batches])[0]
        else:
            step = tft.make_train_step()
            out = torch.stack([step(state, b.to(CPU)) for b in batches])
        losses.append(out)
        states.append(state)
    assert torch.equal(losses[0], losses[1])
    assert states[0].step == states[1].step == 2
    ref = states[0].model.state_dict()
    for name, v in states[1].model.state_dict().items():
        assert torch.equal(v, ref[name]), name
    stacked = tft.stack_batches(batches)
    jstacked = jft.stack_batches([jg.PackedGraphs(
        **{f: getattr(b, f) for f in ("node_feat", "edge_feat", "senders",
                                      "receivers", "node_graph", "node_mask",
                                      "edge_mask", "graph_mask", "y")},
        extras=dict(b.extras)) for b in batches])
    for name, v in stacked.leaves().items():
        want = (np.asarray(jstacked.extras[name[7:]]) if name.startswith(
            "extras/") else np.asarray(getattr(jstacked, name)))
        assert v.shape[0] == 2 and v.dtype == want.dtype, name
        np.testing.assert_array_equal(v, want, err_msg=name)
