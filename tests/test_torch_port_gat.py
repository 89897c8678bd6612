"""The port's GAT slice (models/inits.pyg_glorot, the GATConv of
models/{chem,bio}.py, compat/from_jax for GAT's raw leaves, train/pretrain
and the CLI with --gnn_type gat, ops/_build's header-aware hash) against
the JAX package, on the same seeded data and the same batches.

Parameters are carried over with compat.from_jax.state_dict_from_jax
(strict). The JAX GATConv runs in float32 (its default compute dtype is
bfloat16) under ``pallas_gin.set_fused("on")`` (the fused GAT conv K4,
interpret mode) and under ``set_fused("off")`` (the unfused composition:
K5 in interpret mode on a blocked batch with the pallas backend, the XLA
path otherwise); the port runs its plain versions on the CPU under both
settings of ``gat_conv.set_fused``. Sizes: 2 layers, emb 32, 2 heads."""

import contextlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives.edgepred import (
    EdgePredObjective as JaxEdgePred,
)
from pretrain_gnns_tpu.objectives.masking import (
    BioMaskEdgeObjective as JaxBioMasking, MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.ops import pallas_gin
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.models import inits
from pretrain_gnns_tpu_torch.ops import _build, attention, gat_conv
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, N_GRAPHS = 2, 32, 16, 32
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py
DOMAINS = ["chem", "bio"]
TRUNKS = {"chem": (jchem.GNN, tchem.GNN), "bio": (jbio.GNN, tbio.GNN)}


def _graphs(domain):
    if domain == "bio":
        return tsyn.bio_dataset(N_GRAPHS, seed=3)
    return tsyn.molecule_dataset(N_GRAPHS, seed=3, mean_atoms=20)[0]


def _cfg(domain, objective="masking", packing="blocked"):
    return tpretrain.PretrainConfig(
        objective=objective, domain=domain, gnn_type="gat", num_layer=LAYERS,
        emb_dim=EMB, batch_size=BATCH, packing=packing, seed=0)


@pytest.fixture(scope="module")
def batches():
    """{(domain, objective, packing): the two batches of one epoch}."""
    out = {}
    for domain in DOMAINS:
        for objective, packing in (("masking", "blocked"),
                                   ("masking", "standard"),
                                   ("edgepred", "blocked")):
            loader = tpretrain.build_loader(_cfg(domain, objective, packing),
                                            _graphs(domain),
                                            torch.device("cpu"))
            out[domain, objective, packing] = list(loader)
            assert len(out[domain, objective, packing]) == N_GRAPHS // BATCH
    return out


@contextlib.contextmanager
def fused(mode):
    """Both packages' GATConv on the fused conv ("on") or on the unfused
    composition ("off", the JAX attention on its Pallas kernel where the
    batch is blocked), the JAX side in float32."""
    was = (pallas_gin._FUSED_ENV, jspmm.get_backend(), jspmm._DTYPE)
    pallas_gin.set_fused(mode)
    jspmm.set_backend("pallas" if mode == "off" else was[1])
    jspmm.set_compute_dtype("float32")
    gat_conv.set_fused(mode)
    try:
        yield
    finally:
        pallas_gin.set_fused(was[0])
        jspmm.set_backend(was[1])
        jspmm.set_compute_dtype(was[2])
        gat_conv.set_fused("on")


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


def _objectives(domain, objective):
    kw = dict(num_layer=LAYERS, emb_dim=EMB, gnn_type="gat")
    if objective == "edgepred":
        jtrunk, _ = TRUNKS[domain]
        return JaxEdgePred(trunk=jtrunk, **kw)
    if domain == "bio":
        return JaxBioMasking(**kw)
    return JaxMasking(mask_edge=True, **kw)


def _pair(domain, objective, batch0):
    """JAX objective + variables, and the port's objective (built as
    ``run_pretrain`` builds it) holding the same parameters."""
    jm = _objectives(domain, objective)
    variables = dict(jm.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        _jax_batch(batch0), train=False))
    variables.setdefault("batch_stats", {})  # the bio trunk has no BN
    tm = tpretrain.build_objective(_cfg(domain, objective))
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    return jm, variables, tm


def test_pyg_glorot_bounds_and_seed():
    shape = (1, 2, 2 * EMB)
    bound = np.sqrt(6.0 / (shape[-2] + shape[-1]))
    a = inits.pyg_glorot(shape, torch.Generator().manual_seed(5))
    b = inits.pyg_glorot(shape, torch.Generator().manual_seed(5))
    assert a.shape == shape and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= bound
    big = inits.pyg_glorot((64, 300), torch.Generator().manual_seed(6))
    bound = np.sqrt(6.0 / 364)
    assert 0.9 * bound < float(big.max()) <= bound
    assert -bound <= float(big.min()) < -0.9 * bound
    np.testing.assert_allclose(float(big.std()), bound / np.sqrt(3), rtol=0.05)


@pytest.mark.parametrize("domain", DOMAINS)
def test_build_objective_draws_att_from_the_seed(domain):
    m1 = tpretrain.build_objective(_cfg(domain))
    m2 = tpretrain.build_objective(_cfg(domain))
    bound = np.sqrt(6.0 / (2 + 2 * EMB))
    for k in range(LAYERS):
        conv = m1.gnn.gnns[k]
        assert conv.att.shape == (1, 2, 2 * EMB)
        assert float(conv.att.detach().abs().max()) <= bound
        assert not conv.bias.any() and conv.bias.shape == (EMB,)
        assert torch.equal(conv.att, m2.gnn.gnns[k].att)
        assert conv.weight_linear.weight.shape == (2 * EMB, EMB)
    assert not torch.equal(m1.gnn.gnns[0].att, m1.gnn.gnns[1].att)


@pytest.mark.parametrize("packing", ["blocked", "standard"])
@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("domain", DOMAINS)
def test_trunk_forward_matches_jax(batches, domain, mode, packing):
    """Eval-mode GAT trunks on both layouts under both settings; the
    result does not depend on the setting."""
    batch = batches[domain, "masking", packing][1]
    jtrunk, ttrunk = TRUNKS[domain]
    jgnn = jtrunk(num_layer=LAYERS, emb_dim=EMB, gnn_type="gat")
    with fused(mode):
        variables = dict(jgnn.init(jax.random.PRNGKey(4), _jax_batch(batch),
                                   train=False))
        href = jgnn.apply(variables, _jax_batch(batch), train=False)
        sd = state_dict_from_jax(_np_tree(variables["params"]),
                                 _np_tree(variables.get("batch_stats", {})))
        tgnn = ttrunk(num_layer=LAYERS, emb_dim=EMB, gnn_type="gat")
        tgnn.load_state_dict(sd, strict=True)
        with torch.no_grad():
            h = tgnn(batch.to("cpu"), train=False)
    with torch.no_grad():  # fused on again
        h_on = tgnn(batch.to("cpu"), train=False)
    assert not h[~torch.from_numpy(batch.node_mask)].any()
    np.testing.assert_allclose(h.numpy(), np.asarray(href), **GRAD_TOL)
    np.testing.assert_allclose(h.numpy(), h_on.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("objective", ["masking", "edgepred"])
@pytest.mark.parametrize("domain", DOMAINS)
def test_train_step_matches_jax(batches, domain, objective, mode):
    """One train-mode step on a blocked batch: loss, metrics, every
    gradient (``att`` and ``bias`` under their own names) and the BN
    statistics. The JAX side runs K4 ("on") or K5 ("off") in interpret
    mode."""
    batch = batches[domain, objective, "blocked"][0]
    jm, variables, tm = _pair(domain, objective, batch)

    def loss_fn(params):
        (loss, metrics), mutated = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            _jax_batch(batch), train=True, mutable=["batch_stats"])
        return loss, (metrics, mutated)

    with fused(mode):
        (jloss, (jmetrics, mutated)), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        tloss, tmetrics = tm(batch.to("cpu"), train=True)
        tloss.backward()

    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated.get("batch_stats", {})))
    names = [n for n, _ in tm.named_parameters()]
    assert {"gnn.gnns.0.att", "gnn.gnns.1.bias",
            "gnn.gnns.0.weight_linear.weight"} <= set(names)
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("domain", DOMAINS)
def test_adam_trajectory_matches_jax(batches, domain):
    """Four Adam steps over the two blocked masking batches."""
    bs = batches[domain, "masking", "blocked"]
    jm, variables, tm = _pair(domain, "masking", bs[0])
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    jstep = jpretrain.make_pretrain_step(jm, tx)
    tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    jl, tl = [], []
    with fused("off"):  # the XLA-differentiable composition
        jspmm.set_backend("xla")
        for s in range(4):
            b = bs[s % len(bs)]
            jstate, loss, _ = jstep(jstate, _jax_batch(b))
            jl.append(float(loss))
    for s in range(4):  # the port as run_pretrain runs it: fused on
        loss, _ = tpretrain.train_step(tstate, bs[s % len(bs)].to("cpu"))
        tl.append(float(loss))
    assert tstate.step == 4
    assert len(set(np.round(tl, 6))) > 1  # the trajectory moved
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)


@pytest.mark.parametrize("domain", DOMAINS)
def test_state_dict_from_jax_keeps_att_and_bias(batches, domain):
    """GAT's raw leaves keep their names; the trunk has exactly the
    reference's keys and loads strictly."""
    batch = batches[domain, "masking", "blocked"][0]
    _, variables, _ = _pair(domain, "masking", batch)
    sd = state_dict_from_jax(_np_tree(variables["params"]),
                             _np_tree(variables["batch_stats"]))
    trunk = {k[len("gnn."):]: v for k, v in sd.items()
             if k.startswith("gnn.")}
    want = set()
    for k in range(LAYERS):
        want |= {f"gnns.{k}.att", f"gnns.{k}.bias",
                 f"gnns.{k}.weight_linear.weight",
                 f"gnns.{k}.weight_linear.bias"}
        if domain == "bio":
            want |= {f"gnns.{k}.edge_encoder.weight",
                     f"gnns.{k}.edge_encoder.bias"}
        else:
            want |= {f"gnns.{k}.edge_embedding1.weight",
                     f"gnns.{k}.edge_embedding2.weight"}
            want |= {f"batch_norms.{k}.{p}" for p in (
                "weight", "bias", "running_mean", "running_var",
                "num_batches_tracked")}
    want |= ({"gnns.0.input_node_embeddings.weight"} if domain == "bio"
             else {"x_embedding1.weight", "x_embedding2.weight"})
    assert set(trunk) == want
    assert trunk["gnns.0.att"].shape == (1, 2, 2 * EMB)
    assert trunk["gnns.0.bias"].shape == (EMB,)
    assert trunk["gnns.0.weight_linear.weight"].shape == (2 * EMB, EMB)
    edge = ("gnns.0.edge_encoder.weight" if domain == "bio"
            else "gnns.0.edge_embedding1.weight")
    assert trunk[edge].shape[0 if domain == "bio" else 1] == 2 * EMB
    np.testing.assert_array_equal(
        trunk["gnns.1.att"].numpy(),
        np.asarray(variables["params"]["gnn"]["gnns_1"]["att"]))
    TRUNKS[domain][1](num_layer=LAYERS, emb_dim=EMB,
                      gnn_type="gat").load_state_dict(trunk, strict=True)


@pytest.mark.parametrize("flags", [
    [],
    ["--objective", "edgepred", "--packing", "blocked"],
    ["--domain", "bio", "--n_synthetic", "256", "--packing", "blocked"],
    ["--domain", "bio", "--objective", "edgepred", "--n_synthetic", "256"],
])
def test_cli_gat_one_epoch_on_cpu(tmp_path, flags):
    out = tmp_path / "trunk"
    history = cli.main([
        "--gnn_type", "gat", "--device", "cpu", "--epochs", "1",
        "--num_layer", "2", "--emb_dim", "32", "--batch_size", "16",
        "--n_synthetic", "64", "--output_model_file", str(out), *flags,
    ])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] == 4 and history[0]["edges"] > 0
    trunk = torch.load(str(out) + ".pth")
    assert "gnns.1.att" in trunk and "gnns.1.bias" in trunk
    (tbio.GNN if "bio" in flags else tchem.GNN)(
        num_layer=2, emb_dim=32, gnn_type="gat").load_state_dict(
            trunk, strict=True)


def test_gat_on_cpu_launches_no_kernel(batches):
    before = dict(gat_conv.launches), dict(attention.launches)
    for mode in ("on", "off"):
        with fused(mode):
            tm = tpretrain.build_objective(_cfg("chem"))
            tm(batches["chem", "masking", "standard"][0].to("cpu"),
               train=True)[0].backward()
    assert (gat_conv.launches, attention.launches) == before


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A changed header changes the library's name, so a stale build is
    never loaded; the sources of gin_conv and gat share gemm.cuh, and so
    does K2's bfloat16 source (its tensor-core fragments)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("gin_conv", "gat", "spmm", "edge_dot")
    for name in ("gin_conv", "gat", "spmm_bf16"):
        assert csrc / "gemm.cuh" in _build._with_headers(csrc / f"{name}.cu")
    # spmm.cu shares K1's aggregation header, not the GEMM
    assert _build._with_headers(csrc / "spmm.cu") == [
        csrc / "spmm.cu", csrc / "edge_aggr.cuh"]
    before = {n: _build._target(n)[1].name for n in names}
    assert before == {n: _build._target(n)[1].name for n in names}
    with open(csrc / "gemm.cuh", "a") as f:
        f.write("// changed\n")
    after = {n: _build._target(n)[1].name for n in names}
    assert after["gin_conv"] != before["gin_conv"]
    assert after["gat"] != before["gat"]
    assert after["spmm"] != before["spmm"]  # through spmm_bf16.cu
    assert after["edge_dot"] == before["edge_dot"]
    # a header reached only through another header counts too
    (csrc / "inner.cuh").write_text("// inner\n")
    with open(csrc / "gemm.cuh", "a") as f:
        f.write('#include "inner.cuh"\n')
    nested = _build._target("gat")[1].name
    (csrc / "inner.cuh").write_text("// inner, changed\n")
    assert _build._target("gat")[1].name != nested
