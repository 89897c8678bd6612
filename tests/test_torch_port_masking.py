"""The whole slice of the port (chem attribute masking: trunk, masked batch
norm, heads, loss, Adam) against the JAX package, with parameters carried
over by pretrain_gnns_tpu_torch.compat.from_jax.state_dict_from_jax and
the same packed, masked batches fed to both (2 layers, emb 32, blocks
64/192, float32 on the CPU)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pretrain_gnns_tpu.compat import import_params
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives.masking import (
    MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data.batch_transforms import BatchMaskAtom
from pretrain_gnns_tpu_torch.data.synthetic import molecule_dataset
from pretrain_gnns_tpu_torch.models.chem import GNN
from pretrain_gnns_tpu_torch.objectives.masking import MaskingObjective
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train.pretrain import train_step
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH = 2, 32, 32
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py


def _batches(mask_edge, n_batches=2):
    graphs, _ = molecule_dataset(BATCH * n_batches, seed=3, mean_atoms=20)
    blocks = tpk.block_layout(graphs, BATCH, block_nodes=64,
                              block_edges=192)
    mn, me = blocks[0] * blocks[1], blocks[0] * blocks[2]
    post = BatchMaskAtom(mask_rate=0.15, mask_edge=mask_edge,
                         node_budget=int(mn * 0.15) + BATCH + 8,
                         edge_budget=me // 2)
    return list(tpk.PackedLoader(graphs, BATCH, seed=0, blocks=blocks,
                                 drop_last=True, post_transform=post))


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


def _pair(mask_edge, batch0, jk="last"):
    """JAX objective + variables, and the port's objective holding the
    same parameters."""
    jm = JaxMasking(num_layer=LAYERS, emb_dim=EMB, jk=jk,
                    mask_edge=mask_edge)
    variables = jm.init({"params": jax.random.PRNGKey(0),
                         "mask": jax.random.PRNGKey(1)},
                        _jax_batch(batch0), train=False)
    tm = MaskingObjective(num_layer=LAYERS, emb_dim=EMB, jk=jk,
                          mask_edge=mask_edge)
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    return jm, variables, tm


@pytest.mark.parametrize("mask_edge", [False, True])
def test_train_step_loss_grads_and_bn_stats_match_jax(mask_edge):
    batch = _batches(mask_edge)[0]
    jm, variables, tm = _pair(mask_edge, batch)

    def loss_fn(params):
        (loss, metrics), mutated = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            _jax_batch(batch), train=True, mutable=["batch_stats"])
        return loss, (metrics, mutated)

    (jloss, (jmetrics, mutated)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    tloss, tmetrics = tm(batch.to("cpu"), train=True)
    tloss.backward()

    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("jk", ["last", "concat", "max", "sum"])
def test_trunk_forward_matches_jax(jk):
    """Eval-mode trunk (running statistics) for every JK mode."""
    batch = _batches(False)[0]
    jgnn = jchem.GNN(num_layer=LAYERS, emb_dim=EMB, jk=jk)
    variables = jgnn.init(jax.random.PRNGKey(4), _jax_batch(batch),
                          train=False)
    # non-trivial running statistics
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype) / v.shape[0],
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    href = jgnn.apply(variables, _jax_batch(batch), train=False)
    tgnn = GNN(num_layer=LAYERS, emb_dim=EMB, jk=jk)
    tgnn.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    with torch.no_grad():
        h = tgnn(batch.to("cpu"), train=False)
    np.testing.assert_allclose(h.numpy(), np.asarray(href), **GRAD_TOL)


def test_adam_trajectory_matches_jax():
    """Four Adam steps over two masked batches: the losses agree."""
    batches = _batches(True)
    jm, variables, tm = _pair(True, batches[0])
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    jstep = jpretrain.make_pretrain_step(jm, tx)
    tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    jl, tl = [], []
    for s in range(4):
        b = batches[s % len(batches)]
        jstate, loss, _ = jstep(jstate, _jax_batch(b))
        jl.append(float(loss))
        loss, _ = train_step(tstate, b.to("cpu"))
        tl.append(float(loss))
    assert tstate.step == 4
    assert len(set(np.round(tl, 6))) > 1  # the trajectory moved
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)


def test_state_dict_from_jax_matches_trunk_export():
    """The trunk keys and values equal the JAX package's reference-layout
    export, and load strictly into the port's trunk."""
    batch = _batches(True)[0]
    _, variables, _ = _pair(True, batch)
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
    head = {k for k in sd if not k.startswith("gnn.")}
    assert head == {"linear_pred_atoms.weight", "linear_pred_atoms.bias",
                    "linear_pred_bonds.weight", "linear_pred_bonds.bias"}
    GNN(num_layer=LAYERS, emb_dim=EMB).load_state_dict(trunk, strict=True)
