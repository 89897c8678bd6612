"""The port's bio attribute-masking slice (data/synthetic.bio_dataset,
data/batch_transforms.BatchMaskEdge, models/bio.py, objectives/masking.
BioMaskEdgeObjective, train/pretrain and the CLI with --domain bio)
against the JAX package, on the same seeded data and the same batches.

Parameters are carried over with compat.from_jax.state_dict_from_jax
(strict). The JAX trunk runs on its XLA path and, where stated, on its
Pallas K2 in interpret mode and float32 (the JAX default compute dtype is
bfloat16, which would hide real differences). Sizes: 2 layers, emb 32,
batches of 16 ego-networks, blocks of 128 nodes / 384 edge slots."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.compat import import_params
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import batch_transforms as jbt
from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.objectives.masking import (
    BioMaskEdgeObjective as JaxBioMasking,
)
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.objectives.masking import BioMaskEdgeObjective
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, N_GRAPHS = 2, 32, 16, 32
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py
FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
          "node_mask", "edge_mask", "graph_mask", "y")


def _cfg(packing="blocked"):
    return tpretrain.PretrainConfig(domain="bio", num_layer=LAYERS,
                                    emb_dim=EMB, batch_size=BATCH,
                                    packing=packing, seed=0)


@pytest.fixture(scope="module")
def graphs():
    return tsyn.bio_dataset(N_GRAPHS, seed=3)


@pytest.fixture(scope="module")
def batches(graphs):
    return list(tpretrain.build_loader(_cfg(), graphs, torch.device("cpu")))


@contextlib.contextmanager
def jax_backend(name):
    """The JAX spmm dispatch on ``name``; "pallas" also pins float32."""
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend(name)
    jspmm.set_compute_dtype("float32")
    try:
        yield
    finally:
        jspmm.set_backend(backend)
        jspmm.set_compute_dtype(dtype)


def _jax_batch(p):
    return jg.PackedGraphs(
        node_feat=jnp.asarray(p.node_feat), edge_feat=jnp.asarray(p.edge_feat),
        senders=jnp.asarray(p.senders), receivers=jnp.asarray(p.receivers),
        node_graph=jnp.asarray(p.node_graph),
        node_mask=jnp.asarray(p.node_mask),
        edge_mask=jnp.asarray(p.edge_mask),
        graph_mask=jnp.asarray(p.graph_mask),
        y=None if p.y is None else jnp.asarray(p.y),
        extras={k: jnp.asarray(v) for k, v in p.extras.items()},
        block_nodes=p.block_nodes, block_edges=p.block_edges,
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_batch(port, ref):
    for f in FIELDS:
        a, b = np.asarray(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert sorted(port.extras) == sorted(ref.extras)
    for k in ref.extras:
        a, b = np.asarray(port.extras[k]), np.asarray(ref.extras[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (port.block_nodes, port.block_edges) == (ref.block_nodes,
                                                    ref.block_edges)


@pytest.mark.parametrize("seed", [0, 5])
def test_bio_dataset_identical(seed):
    port = tsyn.bio_dataset(24, seed=seed)
    ref = jsyn.bio_dataset(24, seed=seed)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in ("node_feat", "edge_index", "edge_feat", "y"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert sorted(a.extras) == sorted(b.extras)
        for k, (arr, kind) in b.extras.items():
            assert a.extras[k][1] == kind
            np.testing.assert_array_equal(a.extras[k][0], arr, err_msg=k)


@pytest.mark.parametrize("packing", ["blocked", "standard"])
def test_mask_edge_batches_match_jax(graphs, packing):
    """Two epochs of the port's bio masking loader against the JAX
    package's pipeline for it, make_loader (its FlatLoader) +
    BatchMaskEdge, with the same seed and layout: values and dtypes."""
    cfg = _cfg(packing)
    port = tpretrain.build_loader(cfg, graphs, torch.device("cpu"))
    blocks = port.blocks
    assert (blocks is None) == (packing == "standard")
    me = port.max_edges
    ref = jpk.make_loader(
        graphs=jsyn.bio_dataset(N_GRAPHS, seed=3), batch_size=BATCH,
        max_nodes=port.max_nodes, max_edges=me, seed=0, blocks=blocks,
        drop_last=True, extra_pad={"center_node_idx": BATCH},
        post_transform=jbt.BatchMaskEdge(
            0.15, budget=int(me // 2 * 0.15) + BATCH + 8))
    for _ in range(2):
        pb, rb = list(port), list(ref)
        assert len(pb) == len(rb) == N_GRAPHS // BATCH
        for p, r in zip(pb, rb):
            _assert_same_batch(p, r)
            assert p.extras["masked_edge_idx_mask"].sum() > 0


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("jk", ["last", "sum"])
def test_trunk_forward_matches_jax(batches, backend, jk):
    """Eval-mode trunk (running statistics) on a masked batch."""
    batch = batches[0]
    jgnn = jbio.GNN(num_layer=LAYERS, emb_dim=EMB, jk=jk)
    variables = jgnn.init(jax.random.PRNGKey(4), _jax_batch(batch),
                          train=False)
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype) / v.shape[0],
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    with jax_backend(backend):
        href = jgnn.apply(variables, _jax_batch(batch), train=False)
    tgnn = tbio.GNN(num_layer=LAYERS, emb_dim=EMB, jk=jk)
    tgnn.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    with torch.no_grad():
        h = tgnn(batch.to("cpu"), train=False)
    np.testing.assert_allclose(h.numpy(), np.asarray(href), **GRAD_TOL)


def _pair(batch0):
    """JAX objective + variables, and the port's objective holding the
    same parameters (strict load)."""
    jm = JaxBioMasking(num_layer=LAYERS, emb_dim=EMB)
    variables = jm.init({"params": jax.random.PRNGKey(0)},
                        _jax_batch(batch0), train=False)
    tm = BioMaskEdgeObjective(num_layer=LAYERS, emb_dim=EMB)
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_train_step_loss_grads_and_bn_stats_match_jax(batches, backend):
    batch = batches[0]
    jm, variables, tm = _pair(batch)

    def loss_fn(params):
        (loss, metrics), mutated = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            _jax_batch(batch), train=True, mutable=["batch_stats"])
        return loss, (metrics, mutated)

    with jax_backend(backend):
        (jloss, (jmetrics, mutated)), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    tloss, tmetrics = tm(batch.to("cpu"), train=True)
    tloss.backward()

    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    assert sorted(tmetrics) == sorted(jmetrics) == ["acc_edge"]
    np.testing.assert_allclose(float(tmetrics["acc_edge"]),
                               float(jmetrics["acc_edge"]), **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    names = [n for n, _ in tm.named_parameters()]
    assert "gnn.gnns.0.input_node_embeddings.weight" in names
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    stats = [n for n, _ in tm.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * LAYERS
    for name, b in tm.named_buffers():
        if name in stats:
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


def test_adam_trajectory_matches_jax(batches):
    """Four Adam steps over two masked batches: the losses agree."""
    jm, variables, tm = _pair(batches[0])
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    jstep = jpretrain.make_pretrain_step(jm, tx)
    tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    jl, tl = [], []
    with jax_backend("xla"):
        for s in range(4):
            b = batches[s % len(batches)]
            jstate, loss, _ = jstep(jstate, _jax_batch(b))
            jl.append(float(loss))
            loss, _ = tpretrain.train_step(tstate, b.to("cpu"))
            tl.append(float(loss))
    assert tstate.step == 4
    assert len(set(np.round(tl, 6))) > 1  # the trajectory moved
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)


def test_state_dict_from_jax_matches_bio_trunk_export(batches):
    """The bio keys equal the JAX package's reference-layout export and
    the reference names, and load strictly into the port's trunk."""
    _, variables, _ = _pair(batches[0])
    params = _np_tree(variables["params"])
    stats = _np_tree(variables["batch_stats"])
    sd = state_dict_from_jax(params, stats)
    trunk = {k[len("gnn."):]: v for k, v in sd.items()
             if k.startswith("gnn.")}
    ref = import_params.trunk_to_torch(
        {"params": params["gnn"], "batch_stats": stats["gnn"]})
    assert set(trunk) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(trunk[k].numpy(), np.asarray(v),
                                      err_msg=k)
    want = {"gnns.0.input_node_embeddings.weight"}
    for k in range(LAYERS):
        want |= {f"gnns.{k}.edge_encoder.{p}" for p in ("weight", "bias")}
        want |= {f"gnns.{k}.mlp.{i}.{p}" for i in (0, 3)
                 for p in ("weight", "bias")}
        want |= {f"gnns.{k}.mlp.1.{p}" for p in (
            "weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")}
    assert set(trunk) == want
    assert {k for k in sd if not k.startswith("gnn.")} == {
        "linear_pred_edges.weight", "linear_pred_edges.bias"}
    tbio.GNN(num_layer=LAYERS, emb_dim=EMB).load_state_dict(trunk,
                                                           strict=True)


def test_unported_bio_options_raise():
    with pytest.raises(NotImplementedError):
        tpretrain.build_objective(tpretrain.PretrainConfig(
            domain="bio", objective="contextpred", gnn_type="gat"))
    with pytest.raises(NotImplementedError):
        tpretrain.build_objective(
            tpretrain.PretrainConfig(domain="bio", objective="contextpred"))
    with pytest.raises(ValueError, match="JK"):
        tbio.GNN(num_layer=2, emb_dim=16, jk="concat")


def test_cli_bio_one_epoch_on_cpu(tmp_path):
    out = tmp_path / "bio_trunk"
    history = cli.main([
        "--domain", "bio", "--device", "cpu", "--epochs", "1",
        "--num_layer", "2", "--emb_dim", "32", "--batch_size", "16",
        "--n_synthetic", "256", "--packing", "blocked",
        "--output_model_file", str(out),
    ])
    # max(256 // 4, 64) = 64 ego-networks -> 4 steps of 16
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] == 4 and history[0]["edges"] > 0
    assert "acc_edge" in history[0]
    trunk = torch.load(str(out) + ".pth")
    tbio.GNN(num_layer=2, emb_dim=32).load_state_dict(trunk, strict=True)
