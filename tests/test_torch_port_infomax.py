"""The port's Deep Graph Infomax objective (objectives/infomax.py:
cycle_shift and InfomaxObjective on the chem and the bio trunk,
compat/from_jax for ``discriminator_weight``, train/pretrain and the CLI
with --objective infomax) against the JAX package, on the same seeded data
and the same batches.

Parameters are carried over with compat.from_jax.state_dict_from_jax
(strict). The JAX trunk runs on its XLA path and on its Pallas SpMM in
interpret mode and float32 (the JAX default compute dtype is bfloat16,
which would hide real differences). Sizes: 2 layers, emb 16, batches of 16
graphs, blocks of 128 nodes / 384 edge slots; 40 graphs, so the last batch
of an epoch has 8 valid graphs in 16 slots. Tolerances: loss and accuracy
rtol 1e-5, gradients and batch-norm statistics rtol 1e-4 / atol 1e-5, a
4-step Adam trajectory rtol 5e-4. About 80 s alone."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives import infomax as jinfomax
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.objectives import infomax as tinfomax
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, N_GRAPHS = 2, 16, 16, 40
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py
DOMAINS = ["chem", "bio"]
TRUNKS = {"chem": (jchem.GNN, tchem.GNN), "bio": (jbio.GNN, tbio.GNN)}


def _cfg(domain):
    return tpretrain.PretrainConfig(
        objective="infomax", domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, packing="blocked", seed=0)


@pytest.fixture(scope="module")
def batches():
    """{domain: one epoch's three blocked batches, the last with 8 of 16
    graph slots valid}."""
    out = {}
    for domain in DOMAINS:
        graphs = (tsyn.bio_dataset(N_GRAPHS, seed=1) if domain == "bio"
                  else tsyn.molecule_dataset(N_GRAPHS, seed=1)[0])
        loader = tpretrain.build_loader(_cfg(domain), graphs,
                                        torch.device("cpu"), drop_last=False)
        assert type(loader).__name__ == "FlatLoader"
        assert loader.post_transform is None
        out[domain] = list(loader)
        assert [int(b.graph_mask.sum()) for b in out[domain]] == [16, 16, 8]
    return out


@contextlib.contextmanager
def jax_backend(name):
    """The JAX spmm dispatch on ``name``, in float32."""
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


def _pair(domain, batch0):
    """JAX objective + variables, and the port's objective holding the
    same parameters (strict load)."""
    jtrunk, ttrunk = TRUNKS[domain]
    jm = jinfomax.InfomaxObjective(num_layer=LAYERS, emb_dim=EMB,
                                   trunk=jtrunk)
    variables = dict(jm.init(jax.random.PRNGKey(0), _jax_batch(batch0),
                             train=False))
    tm = tinfomax.InfomaxObjective(num_layer=LAYERS, emb_dim=EMB,
                                   trunk=ttrunk)
    sd = state_dict_from_jax(_np_tree(variables["params"]),
                             _np_tree(variables["batch_stats"]))
    assert sd["discriminator_weight"].shape == (EMB, EMB)
    tm.load_state_dict(sd, strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("num_slots", [1, 5, 16])
def test_cycle_shift_matches_jax(num_slots):
    """Every count of valid slots, 0 and 1 included, and shifts of 1 and
    more than the count."""
    for n_valid in range(num_slots + 1):
        for shift in (1, 3):
            got = tinfomax.cycle_shift(num_slots, torch.tensor(n_valid),
                                       shift)
            want = jinfomax.cycle_shift(num_slots, jnp.asarray(n_valid),
                                        shift)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert (got[n_valid:] == torch.arange(n_valid, num_slots)).all()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("which", [0, 2])
@pytest.mark.parametrize("domain", DOMAINS)
def test_step_matches_jax(batches, domain, which, backend):
    """One train-mode step on a full batch and on the one with fewer valid
    graphs than slots: loss, accuracy, every gradient (the discriminator's
    included) and the BN statistics. On "pallas" the JAX side runs K2."""
    batch = batches[domain][which]
    jm, variables, tm = _pair(domain, batch)

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
    assert sorted(tmetrics) == sorted(jmetrics) == ["acc"]
    np.testing.assert_allclose(float(tmetrics["acc"]), float(jmetrics["acc"]),
                               **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    names = [n for n, _ in tm.named_parameters()]
    assert "discriminator_weight" in names
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    stats = [n for n, _ in tm.named_buffers() if n.endswith("running_var")]
    assert stats
    for name, b in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("domain", DOMAINS)
def test_adam_trajectory_matches_jax(batches, domain):
    """Four Adam steps over the epoch's batches, the short one included:
    the losses agree."""
    bs = batches[domain]
    jm, variables, tm = _pair(domain, bs[0])
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    jstep = jpretrain.make_pretrain_step(jm, tx)
    tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    jl, tl = [], []
    with jax_backend("xla"):
        for s in range(4):
            b = bs[s % len(bs)]
            jstate, loss, _ = jstep(jstate, _jax_batch(b))
            jl.append(float(loss))
            loss, _ = tpretrain.train_step(tstate, b.to("cpu"))
            tl.append(float(loss))
    assert tstate.step == 4
    assert len(set(np.round(tl, 6))) > 1  # the trajectory moved
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)


@pytest.mark.parametrize("domain", DOMAINS)
def test_build_objective_draws_the_discriminator_from_the_seed(domain):
    """U(-1/sqrt(D), 1/sqrt(D)) on the seeded generator, after the
    trunk's draws: the same seed gives the same weights."""
    a = tpretrain.build_objective(_cfg(domain))
    b = tpretrain.build_objective(_cfg(domain))
    w = a.discriminator_weight.detach()
    assert w.shape == (EMB, EMB)
    assert float(w.abs().max()) <= EMB ** -0.5
    assert float(w.abs().max()) > 0.8 * EMB ** -0.5
    for (n, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("domain", DOMAINS)
def test_cli_infomax_one_epoch_on_cpu(tmp_path, domain):
    out = tmp_path / "trunk"
    history = cli.main([
        "--objective", "infomax", "--domain", domain, "--device", "cpu",
        "--epochs", "1", "--num_layer", "2", "--emb_dim", "16",
        "--batch_size", "16", "--n_synthetic", "64",
        "--output_model_file", str(out)])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] == 4 and 0.0 <= history[0]["acc"] <= 1.0
    trunk = torch.load(str(out) + ".pth")
    (tbio.GNN if domain == "bio" else tchem.GNN)(
        num_layer=2, emb_dim=16).load_state_dict(trunk, strict=True)
