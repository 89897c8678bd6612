"""Many train steps per dispatch in the port (``scan_steps``;
train/graphed.py, train/pretrain.make_scan_pretrain_step and the grouped
loop of run_pretrain), on the CPU, where a group's K steps run in turn
through the same slots and outputs as a replay on the card:

- run_pretrain at scan_steps=4 equals scan_steps=1 bit for bit (history,
  parameters, batch-norm statistics, Adam's moments), on epochs of 9 steps,
  so that the warm-up steps and the short tails run eagerly;
- the grouped step on 4 batches against the JAX package's
  make_scan_pretrain_step on the same batches stacked, from the parameters
  that compat/from_jax.state_dict_from_jax carries over;
- resolve_scan_steps, the CLI's --scan_steps and its argparse choices, and
  a batch of another signature, which raises.

Chem and bio attribute masking, GIN, 2 layers, emb 16, batches of 16
graphs, standard packing, float32. About 45 s alone."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.objectives.masking import (
    BioMaskEdgeObjective as JaxBioMasking,
)
from pretrain_gnns_tpu.objectives.masking import (
    MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data.synthetic import (
    bio_dataset, molecule_dataset,
)
from pretrain_gnns_tpu_torch.objectives.masking import (
    BioMaskEdgeObjective, MaskingObjective,
)
from pretrain_gnns_tpu_torch.train import graphed, optim, pretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH = 2, 16, 16
CPU = torch.device("cpu")
# tests/test_torch_port_masking.py's limits: the losses of a trajectory,
# and the gradients' (here: the parameters after four Adam steps)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _graphs(domain):
    # 150 graphs: 9 batches of 16 an epoch, not a multiple of 4
    if domain == "bio":
        return bio_dataset(150, seed=1)
    return molecule_dataset(150, seed=1)[0]


def _cfg(domain, **kw):
    return pretrain.PretrainConfig(**{
        "domain": domain, "num_layer": LAYERS, "emb_dim": EMB,
        "batch_size": BATCH, "packing": "standard", **kw})


def _moments(state):
    opt = state.optimizer
    return {f"{n}.{k}": v for n, p in state.model.named_parameters()
            for k, v in opt.state[p].items()}


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_scan_steps_4_equals_scan_steps_1_bit_for_bit(domain):
    graphs = _graphs(domain)
    res = {k: pretrain.run_pretrain(_cfg(domain, scan_steps=k), graphs,
                                    log=None, epochs=2, device="cpu")
           for k in (1, 4)}
    one, four = res[1], res[4]
    assert [h["steps"] for h in one["history"]] == [9, 9]
    assert four["history"] == one["history"]
    # epoch 1: 3 warm-up steps, one group, a tail of 2; epoch 2: two
    # groups and a tail of 1
    assert (four["scan_steps"], four["replays"], four["eager_steps"]) == (
        4, 3, 6)
    assert (one["scan_steps"], one["replays"], one["eager_steps"]) == (
        1, 0, 18)
    assert four["state"].step == one["state"].step == 18
    for name, v in one["model"].state_dict().items():
        assert torch.equal(four["model"].state_dict()[name], v), name
    m1, m4 = _moments(one["state"]), _moments(four["state"])
    assert m1.keys() == m4.keys()
    for name, v in m1.items():
        assert torch.equal(m4[name], v), name


@contextlib.contextmanager
def _jax_float32():
    """The JAX spmm dispatch on XLA in float32 (its default compute dtype
    is bfloat16)."""
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend("xla")
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


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_grouped_step_matches_jax_scan_step(domain):
    cfg = _cfg(domain)
    batches = list(pretrain.build_loader(cfg, _graphs(domain), CPU))[:4]
    if domain == "bio":
        jm = JaxBioMasking(num_layer=LAYERS, emb_dim=EMB)
        tm = BioMaskEdgeObjective(num_layer=LAYERS, emb_dim=EMB)
    else:
        jm = JaxMasking(num_layer=LAYERS, emb_dim=EMB)
        tm = MaskingObjective(num_layer=LAYERS, emb_dim=EMB)
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    with _jax_float32():
        variables = jm.init({"params": jax.random.PRNGKey(0),
                             "mask": jax.random.PRNGKey(1)},
                            _jax_batch(batches[0]), train=False)
        jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
        stacked = (jpretrain._stack([_jax_batch(b) for b in batches]),)
        jstate, jlosses, _ = jpretrain.make_scan_pretrain_step(jm, tx)(
            jstate, stacked)
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    state = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    scan = pretrain.make_scan_pretrain_step(state, batches[0], 4)
    losses, metrics = scan(batches)
    assert losses.shape == (4,) and state.step == 4
    assert all(v.shape == (4,) for v in metrics.values())
    assert len(set(np.round(losses.numpy(), 6))) > 1  # the steps moved
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               **TRAJ_TOL)
    ref = state_dict_from_jax(_np_tree(jstate.params),
                              _np_tree(jstate.batch_stats))
    jgrads, jlosses_1by1 = _jax_gradients(jm, tx, variables, batches)
    np.testing.assert_allclose(jlosses_1by1, np.asarray(jlosses), rtol=1e-6)
    noise = _noise(jgrads, tm)
    # the exemptions are the biases that a batch norm removes and at most
    # NOISE_SHARE of the other entries
    before_bn = BEFORE_BN[domain]
    other = [n for n, _ in tm.named_parameters() if not n.endswith(before_bn)]
    n_other = sum(noise[n].sum() for n in other)
    assert n_other <= NOISE_SHARE * sum(noise[n].size for n in other), (
        n_other)
    # the port's gradients there are float32 noise in the same steps
    for step, (jg_, tg) in enumerate(zip(
            jgrads, _port_gradients(tm, variables, batches))):
        tfloor = NOISE_FLOOR * max(np.abs(v).max() for v in tg.values())
        for name, v in tg.items():
            small = _small(jg_, name, tm)
            assert (np.abs(v[small]) <= tfloor).all(), (step, name)
    for name, v in tm.named_parameters():
        got, want = v.detach().numpy(), ref[name].numpy()
        held = ~noise[name]
        # Adam turns a gradient of float32 noise into a step of up to lr
        # whose sign is the noise's, so only the entries with a gradient
        # are compared after the steps; the others' gradients are above
        np.testing.assert_allclose(got[held], want[held], err_msg=name,
                                   **GRAD_TOL)


# a gradient entry at most this share of the step's largest is float32
# noise: a direction the loss does not depend on in exact arithmetic
NOISE_FLOOR = 1e-5
# the biases that a batch norm follows (chem GIN: mlp.2 then the layer's
# norm; bio GIN: mlp.0 then mlp.1), exempt whole
BEFORE_BN = {"chem": "mlp.2.bias", "bio": "mlp.0.bias"}
NOISE_SHARE = 0.02


def _jax_gradients(jm, tx, variables, batches):
    """The JAX gradients and losses of the four steps one by one: the body
    of ``make_scan_pretrain_step`` (``pretrain_gnns_tpu/train/pretrain.py``,
    ``_make_step_body``) from the same state, with its gradients kept."""
    grads, losses = [], []
    with _jax_float32():
        st = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
        for b in batches:
            rng, drop_rng, mask_rng = jax.random.split(st.rng, 3)

            def loss_fn(params, st=st, b=b):
                (loss, _), mutated = jm.apply(
                    {"params": params, "batch_stats": st.batch_stats},
                    _jax_batch(b), train=True, mutable=["batch_stats"],
                    rngs={"dropout": drop_rng, "mask": mask_rng})
                return loss, mutated

            (loss, mutated), g = jax.value_and_grad(
                loss_fn, has_aux=True)(st.params)
            updates, opt_state = tx.update(g, st.opt_state, st.params)
            st = st.replace(step=st.step + 1,
                            params=optax.apply_updates(st.params, updates),
                            batch_stats=mutated["batch_stats"],
                            opt_state=opt_state, rng=rng)
            sd = state_dict_from_jax(_np_tree(g),
                                     _np_tree(mutated["batch_stats"]))
            grads.append({k: v.numpy() for k, v in sd.items()})
            losses.append(float(loss))
    return grads, np.asarray(losses)


def _small(grads, name, tm):
    floor = NOISE_FLOOR * max(np.abs(grads[n]).max()
                              for n, _ in tm.named_parameters())
    a = np.abs(grads[name])
    return (a > 0) & (a <= floor)


def _noise(jgrads, tm):
    """Per parameter, the entries whose JAX gradient is float32 noise in
    some of the four steps: not 0 (an entry that no step moves is held
    like the others) and at most NOISE_FLOOR of the step's largest."""
    return {name: np.logical_or.reduce([_small(g, name, tm)
                                        for g in jgrads])
            for name, _ in tm.named_parameters()}


def _port_gradients(tm, variables, batches):
    """The port's gradients of the same four steps, one by one, on a copy
    of its objective from the same parameters."""
    model = type(tm)(num_layer=LAYERS, emb_dim=EMB)
    model.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    state = TrainState(model, optim.adam(model.parameters(), lr=1e-3))
    for b in batches:
        loss, _ = model(b.to(CPU), train=True)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        yield {name: p.grad.numpy().copy()
               for name, p in model.named_parameters()}
        state.optimizer.step()


def test_resolve_scan_steps_and_the_cli_flags():
    assert pretrain.PretrainConfig().scan_steps == 0
    assert pretrain.resolve_scan_steps(0, "cpu") == 1
    assert pretrain.resolve_scan_steps(0, torch.device("cuda")) == 16
    assert pretrain.resolve_scan_steps(4, "cpu") == 4
    assert pretrain.resolve_scan_steps(3, "cuda") == 3
    with pytest.raises(ValueError):
        pretrain.resolve_scan_steps(-1, "cpu")
    parser = cli.build_parser()
    assert parser.parse_args([]).scan_steps == 0
    assert parser.parse_args(["--scan_steps", "4"]).scan_steps == 4
    for flag, bad in (("--objective", "bogus"), ("--domain", "dna"),
                      ("--packing", "dense")):
        with pytest.raises(SystemExit):
            parser.parse_args([flag, bad])
    assert parser.parse_args(["--objective", "contextpred"]).objective == (
        "contextpred")
    history = cli.main([
        "--device", "cpu", "--epochs", "1", "--num_layer", "2",
        "--emb_dim", "16", "--batch_size", "16", "--n_synthetic", "112",
        "--scan_steps", "2",
    ])
    assert history[0]["steps"] == 7 and np.isfinite(history[0]["loss"])


def test_a_batch_of_another_signature_raises():
    cfg = _cfg("chem")
    graphs = _graphs("chem")
    batch = next(iter(pretrain.build_loader(cfg, graphs, CPU)))
    model = pretrain.build_objective(cfg)
    state = TrainState(model, optim.adam(model.parameters()))
    scan = pretrain.make_scan_pretrain_step(state, batch, 2)
    wider = next(iter(pretrain.build_loader(
        _cfg("chem", batch_size=2 * BATCH), graphs, CPU)))
    recast = batch.replace(node_feat=batch.node_feat.astype(np.int64))
    fewer = batch.replace(extras={k: v for k, v in batch.extras.items()
                                  if k != "mask_edge_label"})
    for bad in (wider, recast, fewer):
        with pytest.raises(ValueError, match="signature"):
            scan.step(bad)
        with pytest.raises(ValueError, match="signature"):
            scan([batch, bad])
    assert state.step == 0
    scan([batch, batch])
    assert (state.step, scan.replays) == (2, 1)
    assert graphed.signature(graphed.as_tensors(batch)) == scan.signature
