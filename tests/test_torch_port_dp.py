"""Data parallelism of the PyTorch port (pretrain_gnns_tpu_torch/parallel:
multihost, mesh, dp) on the CPU, against the JAX package's.

- ``multihost.initialize`` is a no-op without its variables and raises as
  the JAX function does without a coordinator or a process id
  (tests/test_multihost.py); ``local_cols`` and ``make_mesh`` at a world
  of one.
- A world of one (gloo, a ``file://`` store, in this process): a
  data-parallel step, a per-step run and an epoch-trainer run equal their
  counterparts without data parallelism bit for bit.
- Two ranks (subprocesses over gloo), one step on two different local
  batches: ``make_dp_train_step`` with SGD against the JAX
  ``dp.make_dp_train_step`` on a 2-device mesh (chem ``masked_task_bce``,
  bio ``plain_bce``; atol 1e-5, tests/test_parallel.py), and
  ``make_dp_pretrain_step`` with Adam against ``dp.make_dp_pretrain_step``
  (loss rtol 1e-5; parameters within Adam's first-step sign-flip bound
  2.2e-3, 99.5% of them within 1e-5, tests/test_multihost.py); both
  ranks end with the same parameters and statistics, bit for bit.
- Device-drawn masks (``transform_device="device"``): rank 0 draws what
  the single-process run draws, rank 1 its own.
- The device loaders' ``shard_cols``: a rank's descriptors are the
  single-process loader's for its column, the other columns stubs.
- The CLI: ``--dp_devices`` (also in tests/test_torch_port_epoch_mode.py's
  flag test), ``multihost.initialize`` at the start of both CLIs, two
  ranks of ``cli.pretrain`` under the ``PGT_*`` variables: rank 0 alone
  prints epoch rows and writes the trunk.

Sizes: 2 layers, emb 16, batches of 8 graphs; the JAX side in float32 on
XLA over tests/conftest.py's 8 virtual CPU devices. The 2-rank runs of
``run_pretrain`` against the JAX ``run_pretrain(dp_devices=2)`` are in
tests/test_torch_port_dp_runs.py."""

import contextlib
import os
import subprocess
import sys
import uuid

import jax
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives import losses as jlosses
from pretrain_gnns_tpu.objectives.masking import (
    MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.parallel import dp as jdp
from pretrain_gnns_tpu.parallel import mesh as jmesh
from pretrain_gnns_tpu.parallel import multihost as jmultihost
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.cli import pretrain as tcli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.data.batch_transforms import BatchMaskAtom
from pretrain_gnns_tpu_torch.objectives import masking as tmasking
from pretrain_gnns_tpu_torch.parallel import dp, mesh, multihost
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "scripts", "torch_port_multihost_smoke.py")
LAYERS, EMB, BATCH = 2, 16, 8
CPU = torch.device("cpu")
PGT_VARS = ("PGT_COORDINATOR", "PGT_NUM_PROCESSES", "PGT_PROCESS_ID",
            "PGT_CPU_DEVICES")


# --- helpers the run tests share ---------------------------------------------

def rank_env(**extra):
    """A rank subprocess's environment: this one's, without the JAX
    flags and the PGT_* variables, the repository as ``PORT_REPO``."""
    env = {k: v for k, v in os.environ.items()
           if k not in PGT_VARS and k != "XLA_FLAGS"}
    env["PORT_REPO"] = REPO
    env.update({k: str(v) for k, v in extra.items()})
    return env


def store(tmp_path) -> str:
    """A fresh ``file://`` rendezvous for one group."""
    return f"file://{tmp_path}/store_{uuid.uuid4().hex}"


def run_ranks(cmds, envs, timeout=300):
    """Starts one process a rank, waits for all; returns their outputs
    (stdout and stderr) and asserts every rank exited 0."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for cmd, env in zip(cmds, envs)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def pgt_ranks(tmp_path, world=2):
    """The PGT_* variables of each of ``world`` ranks of one group."""
    at = store(tmp_path)
    return [dict(PGT_COORDINATOR=at, PGT_NUM_PROCESSES=world,
                 PGT_PROCESS_ID=r) for r in range(world)]


def write_worker(tmp_path, body: str) -> str:
    path = tmp_path / f"worker_{uuid.uuid4().hex}.py"
    path.write_text("import os, sys\n"
                    "sys.path.insert(0, os.environ['PORT_REPO'])\n" + body)
    return str(path)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_batch(p):
    """A port ``PackedGraphs`` as the JAX package's."""
    from pretrain_gnns_tpu.core import graphs as jg

    return jg.PackedGraphs(
        node_feat=p.node_feat, edge_feat=p.edge_feat, senders=p.senders,
        receivers=p.receivers, node_graph=p.node_graph,
        node_mask=p.node_mask, edge_mask=p.edge_mask,
        graph_mask=p.graph_mask, y=p.y, extras=dict(p.extras),
        block_nodes=p.block_nodes, block_edges=p.block_edges)


@contextlib.contextmanager
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, left at the end."""
    multihost.init_group(store(tmp_path), 1, 0, "cpu")
    try:
        yield
    finally:
        multihost.shutdown()


def same_runs(a, b):
    assert a["history"] == b["history"]
    ref = a["model"].state_dict()
    for name, v in b["model"].state_dict().items():
        assert torch.equal(v, ref[name]), name


# --- multihost and mesh ------------------------------------------------------

def test_initialize_is_a_noop_without_variables_and_raises_as_jax(
        monkeypatch):
    for v in PGT_VARS:
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() is False
    assert multihost.is_main() and multihost.process_count() == 1
    assert multihost.local_cols() == (1, 0, 1)
    multihost.sync("nothing to wait for")
    monkeypatch.setenv("PGT_NUM_PROCESSES", "2")
    for env in ({}, {"PGT_COORDINATOR": "127.0.0.1:1"},
                {"PGT_PROCESS_ID": "0"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            for fn in (multihost.initialize, jmultihost.initialize):
                with pytest.raises(ValueError, match="coordinator_address "
                                   "and process_id"):
                    fn()
    monkeypatch.setenv("PGT_NUM_PROCESSES", "1")
    assert multihost.initialize() is False
    with pytest.raises(ValueError, match="one device"):
        multihost.initialize(cpu_devices_per_process=4)
    monkeypatch.setenv("PGT_CPU_DEVICES", "2")
    with pytest.raises(ValueError, match="one device"):
        multihost.initialize()


def test_local_cols_and_mesh_at_a_world_of_one(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh.make_mesh(2)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        jmesh.make_mesh(9)
    with world_of_one(tmp_path):
        m = mesh.make_mesh()
        assert m.size() == 1 and m.mesh_dim_names == ("data",)
        assert m.device_type == "cpu"
        assert multihost.local_cols(m) == (1, 0, 1)
        assert multihost.is_main() and multihost.process_count() == 1
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            mesh.make_mesh(2)
        multihost.sync("one")
    assert not torch.distributed.is_initialized()


def test_dp_world_resolution(tmp_path):
    """``dp_world``: 0 without a group at ``dp_devices`` 0 or 1; a group
    makes every run data-parallel; the JAX run's errors."""
    cfg = tpretrain.PretrainConfig
    assert tpretrain.dp_world(cfg()) == 0
    assert tpretrain.dp_world(cfg(dp_devices=0)) == 0
    with pytest.raises(RuntimeError, match="PGT_NUM_PROCESSES"):
        tpretrain.dp_world(cfg(dp_devices=2))
    with world_of_one(tmp_path):
        assert tpretrain.dp_world(cfg()) == 1
        assert tpretrain.dp_world(cfg(dp_devices=0)) == 1
        with pytest.raises(ValueError, match="span all 1"):
            tpretrain.dp_world(cfg(dp_devices=2))
        assert not tpretrain.use_device_dataset(
            cfg(device_dataset="on", scan_steps=1), CPU)
        assert tpretrain.use_device_dataset(
            cfg(device_dataset="on", scan_steps=2), CPU)


# --- a world of one equals the run without data parallelism ------------------

def _masking_batches(n_batches=3):
    graphs, _ = tsyn.molecule_dataset(BATCH * n_batches, seed=3,
                                      mean_atoms=14)
    blocks = tpk.block_layout(graphs, BATCH, block_nodes=64,
                              block_edges=192)
    mn, me = blocks[0] * blocks[1], blocks[0] * blocks[2]
    post = BatchMaskAtom(mask_rate=0.15, mask_edge=True,
                         node_budget=int(mn * 0.15) + BATCH + 8,
                         edge_budget=me // 2)
    return list(tpk.PackedLoader(graphs, BATCH, seed=0, blocks=blocks,
                                 drop_last=True, post_transform=post))


def test_world_of_one_dp_step_is_bit_equal(tmp_path):
    """Three ``make_dp_pretrain_step`` steps at a world of one against
    three ``train_step``s from the same seeded objective: losses,
    metrics, parameters, statistics and Adam's moments bit for bit."""
    batches = [b.to("cpu") for b in _masking_batches()]
    cfg = tpretrain.PretrainConfig(num_layer=LAYERS, emb_dim=EMB,
                                   batch_size=BATCH, dropout_ratio=0.3)
    ref = TrainState(tpretrain.build_objective(cfg), None)
    ref.optimizer = optim.adam(ref.model.parameters(), 1e-3)
    want = [tpretrain.train_step(ref, b) for b in batches]
    model = tpretrain.build_objective(cfg)
    opt = optim.adam(model.parameters(), 1e-3)
    with world_of_one(tmp_path):
        step = dp.make_dp_pretrain_step(model, opt)
        got = [step(b) for b in batches]
        assert step.sync.calls == 3 and step.sync.world == 1
    for (gl, gm), (wl, wm) in zip(got, want):
        assert torch.equal(gl, wl) and gl.shape == wl.shape == ()
        assert gm.keys() == wm.keys()
        assert all(torch.equal(gm[k], wm[k]) for k in wm)
    want_sd = ref.model.state_dict()
    for name, v in model.state_dict().items():
        assert torch.equal(v, want_sd[name]), name
    for a, b in zip(opt.state.values(), ref.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("kw", [
    dict(device_dataset="off"),
    dict(device_dataset="on", scan_steps=4, epoch_group=2),
    dict(device_dataset="on", scan_steps=4, transform_device="device",
         dropout_ratio=0.3),
], ids=["per_step", "epoch_trainer", "epoch_trainer_device_draws"])
def test_world_of_one_run_is_bit_equal(tmp_path, kw):
    """``run_pretrain`` in a group of one (``dp_devices`` 1 and 0) against
    the same run without a group: history, parameters and statistics bit
    for bit."""
    graphs = tsyn.molecule_dataset(48, seed=1)[0]
    cfg = tpretrain.PretrainConfig(num_layer=LAYERS, emb_dim=EMB,
                                   batch_size=BATCH, seed=0,
                                   packing="standard", **kw)
    alone = tpretrain.run_pretrain(cfg, graphs, log=None, epochs=3,
                                   device="cpu")
    with world_of_one(tmp_path):
        for dp_devices in (1, 0):
            cfg.dp_devices = dp_devices
            res = tpretrain.run_pretrain(cfg, graphs, log=None, epochs=3,
                                         device="cpu")
            same_runs(alone, res)
    if kw["device_dataset"] == "on":
        assert res["replays"] > 0 and res["epoch_group"]


# --- two ranks, one step, against the JAX data-parallel steps ----------------

STEP_WORKER = """
import torch
from pretrain_gnns_tpu_torch.models import bio, chem
from pretrain_gnns_tpu_torch.objectives import losses
from pretrain_gnns_tpu_torch.objectives.masking import MaskingObjective
from pretrain_gnns_tpu_torch.parallel import dp, multihost
from pretrain_gnns_tpu_torch.train import optim

cases = torch.load(sys.argv[1], weights_only=False)
multihost.initialize(device="cpu")
rank = multihost.process_index()
out = {}
for name, case in cases.items():
    batch = case["batches"][rank].to("cpu")
    if name == "masking":
        model = MaskingObjective(**case["kw"])
        model.load_state_dict(case["state"])
        step = dp.make_dp_pretrain_step(
            model, optim.adam(model.parameters(), 1e-3))
        loss, metrics = step(batch)
    else:
        mod = bio if name == "bio" else chem
        model = mod.GNNGraphPred(**case["kw"])
        model.load_state_dict(case["state"])
        loss_of = losses.plain_bce if name == "bio" else losses.masked_task_bce
        step = dp.make_dp_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.1), loss_of)
        loss = step(batch)
    out[name] = {"loss": loss, "state": model.state_dict()}
torch.save(out, sys.argv[2] + f".{rank}")
multihost.shutdown()
"""


def _graphpred_case(domain):
    """Two local batches and a JAX ``GNNGraphPred`` of the domain with its
    variables (tests/test_parallel.py's sizes)."""
    if domain == "bio":
        graphs = tsyn.bio_dataset(32, seed=2, num_pretrain=3)
        graphs, tasks = tpretrain.supervised_graphs(graphs, "bio")
        sizes = dict(extra_pad={"center_node_idx": BATCH})
    else:
        graphs, _ = tsyn.molecule_dataset(64, num_tasks=2, seed=0)
        tasks, sizes = 2, dict(max_nodes=512, max_edges=1280)
    batches = list(tpk.PackedLoader(graphs, BATCH, shuffle=False,
                                    drop_last=True, **sizes))[:2]
    kw = dict(num_layer=LAYERS, emb_dim=EMB, num_tasks=tasks,
              gnn_type="gin", drop_ratio=0.0)
    jm = (jbio if domain == "bio" else jchem).GNNGraphPred(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jax_batch(batches[0]),
                        train=False)
    return batches, kw, jm, dict(variables)


def _assert_close(want, got, atol):
    for name, v in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def test_two_ranks_one_step_match_jax_dp_steps(tmp_path):
    """One step of two ranks on two different local batches against the
    JAX data-parallel steps on a 2-device mesh; both ranks' states bit for
    bit equal."""
    mesh2 = jmesh.make_mesh(2)
    cases, want = {}, {}
    for domain in ("chem", "bio"):
        batches, kw, jm, variables = _graphpred_case(domain)
        tx = optax.sgd(0.1)
        state = JaxState.create(variables, tx, jax.random.PRNGKey(1))
        loss_of = (jlosses.plain_bce if domain == "bio"
                   else jlosses.masked_task_bce)
        step = jdp.make_dp_train_step(jm, tx, mesh2, loss_of=loss_of)
        gb = jdp.shard_global_batch(jdp.stack_local_batches(
            [jax_batch(b) for b in batches]), mesh2)
        new, loss = step(state, gb)
        cases[domain] = {"batches": batches, "kw": kw,
                         "state": state_dict_from_jax(
                             np_tree(variables["params"]),
                             np_tree(variables["batch_stats"]))}
        want[domain] = (float(loss), state_dict_from_jax(
            np_tree(new.params), np_tree(new.batch_stats)))

    batches = _masking_batches(2)
    jm = JaxMasking(num_layer=LAYERS, emb_dim=EMB, mask_edge=True)
    variables = jm.init({"params": jax.random.PRNGKey(0),
                         "mask": jax.random.PRNGKey(1)},
                        jax_batch(batches[0]), train=False)
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    state = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    gb = jdp.shard_global_batch(jdp.stack_local_batches(
        [jax_batch(b) for b in batches]), mesh2)
    new, loss, _ = jdp.make_dp_pretrain_step(jm, tx, mesh2)(state, gb)
    cases["masking"] = {"batches": batches,
                        "kw": dict(num_layer=LAYERS, emb_dim=EMB,
                                   mask_edge=True),
                        "state": state_dict_from_jax(
                            np_tree(variables["params"]),
                            np_tree(variables["batch_stats"]))}
    want["masking"] = (float(loss), state_dict_from_jax(
        np_tree(new.params), np_tree(new.batch_stats)))

    torch.save(cases, tmp_path / "cases.pt")
    worker = write_worker(tmp_path, STEP_WORKER)
    out = str(tmp_path / "out")
    run_ranks([[sys.executable, worker, str(tmp_path / "cases.pt"), out]] * 2,
              [rank_env(**e) for e in pgt_ranks(tmp_path)])
    got = [torch.load(f"{out}.{r}", weights_only=False) for r in (0, 1)]
    for name in ("chem", "bio", "masking"):
        a, b = got[0][name], got[1][name]
        assert torch.equal(a["loss"], b["loss"]), name
        for key, v in a["state"].items():
            assert torch.equal(v, b["state"][key]), (name, key)
        jloss, jstate = want[name]
        if name == "masking":
            np.testing.assert_allclose(float(a["loss"]), jloss, rtol=1e-5)
            # Adam's first step moves an element by about +-lr: where the
            # gradient is near 0 the order of the sums can flip its sign
            diffs = np.concatenate([
                np.abs(v.numpy() - jstate[k].numpy()).ravel()
                for k, v in a["state"].items()
                if not k.endswith("num_batches_tracked")])
            assert diffs.max() <= 2.2e-3, diffs.max()
            assert (diffs <= 1e-5).mean() >= 0.995
        else:
            np.testing.assert_allclose(float(a["loss"]), jloss, rtol=1e-5)
            _assert_close(jstate, a["state"], atol=1e-5)


def test_dp_eval_step_gathers_every_rank_in_order(tmp_path):
    """``make_dp_eval_step`` at a world of one: ``[1, G, T]``, the
    eval-mode logits of the rank's batch."""
    batches, kw, _, _ = _graphpred_case("chem")
    from pretrain_gnns_tpu_torch.models import chem as tchem

    model = tchem.GNNGraphPred(**kw)
    tpretrain.init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(batches[0].to("cpu"), train=False)
    with world_of_one(tmp_path):
        got = dp.make_dp_eval_step(model)(batches[0].to("cpu"))
    assert got.shape == (1, BATCH, 2) and torch.equal(got[0], want)


# --- the ranks' random streams -----------------------------------------------

SPY = """
import torch
from pretrain_gnns_tpu_torch.objectives import masking
draw = masking.sample_masked_nodes
seen = []

def spy(node_graph, node_mask, G, rate, gen):
    state = gen.get_state().clone()
    out = draw(node_graph, node_mask, G, rate, gen)
    seen.append((state, out.nonzero().flatten()))
    return out

masking.sample_masked_nodes = spy
"""

DRAWS_WORKER = SPY + """
from scripts.torch_port_multihost_smoke import main
main(sys.argv[1:])
import torch
torch.save(seen, os.environ["SPY_OUT"] + "." + sys.argv[sys.argv.index(
    "--process_id") + 1])
"""

DRAW_FLAGS = ["--device", "cpu", "--transform_device", "device",
              "--device_dataset", "off", "--scan_steps", "1", "--epochs",
              "1", "--n_graphs", "64", "--emb_dim", str(EMB),
              "--num_layer", str(LAYERS), "--batch_size", str(BATCH)]


def test_device_drawn_masks_differ_by_rank(tmp_path, monkeypatch):
    """Chem masking with the atoms drawn in the step, two ranks: rank 0's
    first draw (generator state and atoms) is the single-process run's
    first, on the same batch (column 0 of the first group is batch 0);
    rank 1 draws from a stream of its own."""
    worker = write_worker(tmp_path, DRAWS_WORKER)
    at = store(tmp_path)
    run_ranks([[sys.executable, worker, *DRAW_FLAGS, "--coordinator", at,
                "--num_processes", "2", "--process_id", str(r)]
               for r in (0, 1)],
              [rank_env(SPY_OUT=tmp_path / "seen")] * 2)
    ranks = [torch.load(f"{tmp_path}/seen.{r}", weights_only=False)
             for r in (0, 1)]
    seen = []
    draw = tmasking.sample_masked_nodes

    def spy(node_graph, node_mask, G, rate, gen):
        state = gen.get_state().clone()
        out = draw(node_graph, node_mask, G, rate, gen)
        seen.append((state, out.nonzero().flatten()))
        return out

    monkeypatch.setattr(tmasking, "sample_masked_nodes", spy)
    graphs, _ = tsyn.molecule_dataset(64, num_tasks=1, seed=0,
                                      mean_atoms=18)
    cfg = tpretrain.PretrainConfig(
        num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=False,
        transform_device="device", device_dataset="off", scan_steps=1,
        packing="auto")
    tpretrain.run_pretrain(cfg, graphs, log=None, epochs=1, device="cpu")
    assert len(ranks[0]) == len(ranks[1]) == len(seen) // 2
    assert torch.equal(ranks[0][0][0], seen[0][0])
    assert torch.equal(ranks[0][0][1], seen[0][1])
    assert not any(torch.equal(ranks[1][0][0], s) for s, _ in seen)
    assert not torch.equal(ranks[1][0][0], ranks[0][0][0])
    assert not torch.equal(ranks[1][1][0], ranks[0][1][0])


def test_rank_streams_keep_rank_zero_seeds():
    cfg = tpretrain.PretrainConfig(objective="contextpred",
                                   dropout_ratio=0.2, num_layer=LAYERS,
                                   emb_dim=EMB)
    a, b = (tpretrain.build_objective(cfg) for _ in range(2))
    dp.seed_rank_streams(a, 0)
    dp.seed_rank_streams(b, 3)
    for (name, ma), mb in zip(a.named_modules(), b.modules()):
        if hasattr(ma, "_dropout_seed"):
            assert ma._dropout_seed + 3 * dp.RANK_SEED_STRIDE == (
                mb._dropout_seed), name
    assert a.gnn_context._dropout_seed == a.gnn_substruct._dropout_seed + 1


# --- the CLI -----------------------------------------------------------------

def test_cli_dp_devices_and_bootstrap(monkeypatch):
    """``--dp_devices`` with the JAX default; both CLIs call
    ``multihost.initialize`` first (a missing coordinator raises before
    any work); ``dp_devices`` 2 without a group says how to launch."""
    assert tcli.build_parser().parse_args([]).dp_devices == 1
    from pretrain_gnns_tpu_torch.cli import finetune as tft_cli

    for v in PGT_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("PGT_NUM_PROCESSES", "2")
    for main in (tcli.main, tft_cli.main):
        with pytest.raises(ValueError, match="PGT_COORDINATOR"):
            main(["--device", "cpu"])
    monkeypatch.delenv("PGT_NUM_PROCESSES")
    with pytest.raises(RuntimeError, match="PGT_PROCESS_ID"):
        tcli.main(["--device", "cpu", "--dp_devices", "2", "--epochs", "1",
                   "--n_synthetic", "32", "--num_layer", str(LAYERS),
                   "--emb_dim", str(EMB)])


def test_cli_two_ranks_rank_zero_logs_and_writes(tmp_path):
    """``cli.pretrain`` as two ranks under the PGT_* variables, each told
    to write its own trunk file: only rank 0 prints epoch rows and writes
    its trunk; the trunk loads into the reference layout."""
    cmds = [[sys.executable, "-m", "pretrain_gnns_tpu_torch.cli.pretrain",
             "--device", "cpu", "--dp_devices", "2", "--epochs", "2",
             "--num_layer", str(LAYERS), "--emb_dim", str(EMB),
             "--batch_size", str(BATCH), "--n_synthetic", "64",
             "--output_model_file", str(tmp_path / f"trunk{r}")]
            for r in (0, 1)]
    outs = run_ranks(cmds, [rank_env(**e) for e in pgt_ranks(tmp_path)])
    assert outs[0].count("epoch=") == 2 and "data parallel over 2" in outs[0]
    assert "epoch=" not in outs[1] and "saved trunk" not in outs[1]
    assert (tmp_path / "trunk0.pth").exists()
    assert not (tmp_path / "trunk1.pth").exists()
    from pretrain_gnns_tpu_torch.train.checkpoints import load_trunk_any

    assert "x_embedding1.weight" in load_trunk_any(tmp_path / "trunk0.pth")


# --- the device loaders' columns -------------------------------------------

@pytest.mark.parametrize("objective", ["masking", "contextpred"])
def test_shard_cols_make_the_single_loaders_descriptors(objective):
    """``shard_cols = (2, r, r + 1)`` on ``DeviceBatchLoader`` and
    ``DeviceContextLoader``: column r's descriptors equal the
    single-process loader's batches ``b % 2 == r`` element for element
    (draws keyed by seed, epoch and batch), the others are stubs that
    count their graphs and edges, the epoch's statistics are those of every
    column, and ``epoch_stack(n_dev=2)`` keeps whole pairs with the rank's
    column."""
    graphs = tsyn.molecule_dataset(120, seed=1)[0]
    cfg = tpretrain.PretrainConfig(
        objective=objective, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, packing="standard", csize=2,
        device_dataset="on")
    if objective == "contextpred":
        graphs = tpretrain.presample_context(cfg, graphs)
    loaders = [tpretrain.build_loader(cfg, graphs, CPU) for _ in range(3)]
    assert type(loaders[0]).__name__.startswith("Device")
    single = list(loaders[0])
    for r, loader in enumerate(loaders[1:]):
        loader.shard_cols = (2, r, r + 1)
        got = list(loader)
        assert len(got) == len(single)
        assert loader.last_epoch_stats == loaders[0].last_epoch_stats
        for b, (d, want) in enumerate(zip(got, single)):
            if b % 2 != r:
                assert d == {"_stub": (want.counts()["graphs"],
                                       want.counts()["edges"])}
                continue
            assert sorted(d) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(d[key], want[key], key)
        loader.set_epoch(0)
        pack = loader.epoch_stack(n_dev=2)
        n = len(single) // 2
        assert pack["n_steps"] == n
        assert pack["stats"]["batches"] == 2 * n
        assert pack["stats"]["edges"] == sum(
            s.counts()["edges"] for s in single[:2 * n])
        first = single[r]
        for key in first:
            np.testing.assert_array_equal(pack["stacked"][key][0, 0],
                                          first[key], key)
