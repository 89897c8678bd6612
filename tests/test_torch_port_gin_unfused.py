"""The chem GIN's unfused route of the port (``ops/gin_conv.set_fused("off")``:
``spmm.gather_scatter`` with the bond one-hots, the self term and the MLP's
two ``nn.Linear``) against the JAX package's unfused ``GINConv``
(``pallas_gin.set_fused("off")``, the XLA composition, float32), on the
same seeded batches; and the port's two routes against each other.

Parameters are carried over with compat.from_jax.state_dict_from_jax
(strict): both routes own the same parameters. Sizes: 2 layers, emb 32,
blocks of 64 nodes / 192 edge slots, two batches of 16 molecules."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives.masking import (
    MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.ops import pallas_gin
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.ops import blocked_spmm, gin_conv
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, N_GRAPHS = 2, 32, 16, 32
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py


def _cfg():
    return tpretrain.PretrainConfig(
        num_layer=LAYERS, emb_dim=EMB, batch_size=BATCH, mask_edge=True,
        packing="blocked", seed=0)


@pytest.fixture(scope="module")
def batches():
    graphs, _ = tsyn.molecule_dataset(N_GRAPHS, seed=3, mean_atoms=20)
    out = list(tpretrain.build_loader(_cfg(), graphs, torch.device("cpu")))
    assert len(out) == N_GRAPHS // BATCH and out[0].block_nodes > 0
    return out


@pytest.fixture
def unfused():
    """Both packages' chem GINConv on the unfused route, the JAX side in
    float32; every switch restored afterwards."""
    was = (pallas_gin._FUSED_ENV, jspmm._DTYPE, gin_conv.fused_enabled())
    pallas_gin.set_fused("off")
    jspmm.set_compute_dtype("float32")
    gin_conv.set_fused("off")
    try:
        yield
    finally:
        pallas_gin.set_fused(was[0])
        jspmm.set_compute_dtype(was[1])
        gin_conv.set_fused("on" if was[2] else "off")


@contextlib.contextmanager
def port_fused(mode):
    was = gin_conv.fused_enabled()
    gin_conv.set_fused(mode)
    try:
        yield
    finally:
        gin_conv.set_fused("on" if was else "off")


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


def _pair(batch0):
    """JAX masking objective + variables, and the port's objective (built
    as ``run_pretrain`` builds it) holding the same parameters."""
    jm = JaxMasking(num_layer=LAYERS, emb_dim=EMB, mask_edge=True)
    variables = dict(jm.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        _jax_batch(batch0), train=False))
    tm = tpretrain.build_objective(_cfg())
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    return jm, variables, tm


def test_set_fused_switch():
    assert gin_conv.fused_enabled()  # the default
    with port_fused("off"):
        assert not gin_conv.fused_enabled()
    assert gin_conv.fused_enabled()
    with pytest.raises(ValueError, match="'on' or 'off'"):
        gin_conv.set_fused("auto")


def test_trunk_forward_matches_jax(batches, unfused):
    """Eval-mode trunk with non-trivial running statistics."""
    batch = batches[1]
    jgnn = jchem.GNN(num_layer=LAYERS, emb_dim=EMB)
    variables = jgnn.init(jax.random.PRNGKey(4), _jax_batch(batch),
                          train=False)
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype) / v.shape[0],
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    href = jgnn.apply(variables, _jax_batch(batch), train=False)
    tgnn = tchem.GNN(num_layer=LAYERS, emb_dim=EMB)
    tgnn.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    with torch.no_grad():
        h = tgnn(batch.to("cpu"), train=False)
    assert not h[~torch.from_numpy(batch.node_mask)].any()
    np.testing.assert_allclose(h.numpy(), np.asarray(href), **FWD_TOL)


def test_train_step_matches_jax(batches, unfused):
    """One train-mode masking step: loss, metrics, every gradient and the
    batch-norm statistics."""
    batch = batches[0]
    jm, variables, tm = _pair(batch)

    def loss_fn(params, stats, jb):
        (loss, metrics), mutated = jm.apply(
            {"params": params, "batch_stats": stats}, jb, train=True,
            mutable=["batch_stats"])
        return loss, (metrics, mutated)

    # jitted: op by op, the JAX step takes three times as long
    (jloss, (jmetrics, mutated)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], _jax_batch(batch))
    tloss, tmetrics = tm(batch.to("cpu"), train=True)
    tloss.backward()

    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **FWD_TOL)
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   **FWD_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    names = {n for n, _ in tm.named_parameters()}
    assert {"gnn.gnns.0.mlp.0.weight", "gnn.gnns.1.mlp.2.bias",
            "gnn.gnns.0.edge_embedding2.weight"} <= names
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


def test_adam_trajectory_matches_jax(batches, unfused):
    """Four Adam steps over the two masked batches: the losses agree."""
    jm, variables, tm = _pair(batches[0])
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    jstep = jpretrain.make_pretrain_step(jm, tx)
    tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    jl, tl = [], []
    for s in range(4):
        b = batches[s % len(batches)]
        jstate, loss, _ = jstep(jstate, _jax_batch(b))
        jl.append(float(loss))
        loss, _ = tpretrain.train_step(tstate, b.to("cpu"))
        tl.append(float(loss))
    assert tstate.step == 4
    assert len(set(np.round(tl, 6))) > 1  # the trajectory moved
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)


def test_port_routes_agree_on_cpu(batches):
    """The fused route (K1's plain version) and the unfused one give the
    same loss, gradients and statistics from the same weights, and the
    unfused route launches no kernel on the CPU."""
    batch = batches[0].to("cpu")
    results = {}
    for mode in ("on", "off"):
        tm = tpretrain.build_objective(_cfg())
        before = (dict(gin_conv.launches), dict(blocked_spmm.launches))
        with port_fused(mode):
            loss, _ = tm(batch, train=True)
        loss.backward()
        assert (dict(gin_conv.launches), dict(blocked_spmm.launches)) == before
        results[mode] = (float(loss.detach()),
                         {n: p.grad for n, p in tm.named_parameters()},
                         dict(tm.named_buffers()))
    (l_on, g_on, b_on), (l_off, g_off, b_off) = results["on"], results["off"]
    np.testing.assert_allclose(l_off, l_on, **FWD_TOL)
    for name, g in g_on.items():
        np.testing.assert_allclose(g_off[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in b_on.items():
        np.testing.assert_allclose(b_off[name].numpy(), b.numpy(),
                                   err_msg=name, **GRAD_TOL)
