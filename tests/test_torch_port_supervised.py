"""The port's supervised-pretraining slice (models/pools.py, GNNGraphPred of
models/chem.py and models/bio.py, the trunks' dropout, objectives/losses.
{masked_task_bce,plain_bce}, objectives/supervised.SupervisedObjective,
train/pretrain and the CLI with --objective supervised) against the JAX
package, on the same seeded data and the same batches.

Parameters are carried over with compat.from_jax.state_dict_from_jax
(strict). The JAX trunk runs on its XLA path and, where stated, on its
Pallas kernels in interpret mode and float32 (the JAX default compute
dtype is bfloat16, which would hide real differences). Sizes: 2 layers,
emb 32, batches of 16 graphs, blocks of 128 nodes / 384 edge slots.
Tolerances: loss rtol 1e-5; readouts, logits, gradients and batch-norm
statistics rtol 1e-4 / atol 1e-5 (float32 on both sides, another summation
order); a 4-step Adam trajectory rtol 5e-4. Dropout draws from another
generator than JAX's, so its masks are held to their own properties."""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.models import pools as jpools
from pretrain_gnns_tpu.objectives import losses as jlosses
from pretrain_gnns_tpu.objectives.supervised import (
    SupervisedObjective as JaxSupervised,
)
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.models import pools as tpools
from pretrain_gnns_tpu_torch.objectives import losses as tlosses
from pretrain_gnns_tpu_torch.objectives import supervised as tsup
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, N_GRAPHS, TASKS = 2, 32, 16, 40, 5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py
CPU = torch.device("cpu")


def _cfg(domain, packing="blocked", **kw):
    return tpretrain.PretrainConfig(
        objective="supervised", domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, packing=packing, seed=0, **kw)


def _graphs(domain, mod=tsyn):
    """The slice's graphs from the port's generators or, with ``mod`` the
    JAX package's, from theirs; chem labels have missing entries."""
    if domain == "bio":
        return mod.bio_dataset(N_GRAPHS, seed=3, num_pretrain=TASKS)
    return mod.molecule_dataset(N_GRAPHS, num_tasks=TASKS, seed=3,
                                mean_atoms=12, missing_frac=0.3)[0]


@pytest.fixture(scope="module", params=["chem", "bio"])
def domain(request):
    return request.param


@pytest.fixture(scope="module")
def data(domain):
    """(domain, supervised graphs, label width, two epochs' worth of
    blocked batches, the last of which has padded graph slots)."""
    graphs, T = tpretrain.supervised_graphs(_graphs(domain), domain)
    assert T == TASKS
    loader = tpretrain.build_loader(_cfg(domain, num_tasks=T), graphs, CPU,
                                    drop_last=False)
    batches = list(loader)
    assert len(batches) == 3 and not batches[-1].graph_mask.all()
    return domain, graphs, T, batches


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


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]),
        _np_tree(variables.get("batch_stats", {}))), strict=True)
    return module


# --- data ------------------------------------------------------------------


@pytest.mark.parametrize("T,missing", [(1, 0.0), (7, 0.25)])
def test_molecule_labels_identical(T, missing):
    port, _ = tsyn.molecule_dataset(24, num_tasks=T, seed=5,
                                    missing_frac=missing)
    ref, _ = jsyn.molecule_dataset(24, num_tasks=T, seed=5,
                                   missing_frac=missing)
    for a, b in zip(port, ref):
        assert a.y.dtype == b.y.dtype == np.float32 and a.y.shape == (T,)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
    ys = np.stack([g.y for g in port])
    assert set(np.unique(ys)) <= {-1.0, 0.0, 1.0}
    assert (ys == 0).any() == (missing > 0)


@pytest.mark.parametrize("packing", ["blocked", "standard"])
def test_supervised_batches_match_jax(domain, packing):
    """The port's supervised loader against the JAX PackedLoader without a
    transform, same seed and layout: the labels ``y [G, T]``, the graph
    mask and, for bio, the center nodes, element for element. Bio labels
    come from the ``go_target_pretrain`` extra."""
    graphs, T = tpretrain.supervised_graphs(_graphs(domain), domain)
    cfg = _cfg(domain, packing, num_tasks=T)
    port = tpretrain.build_loader(cfg, graphs, CPU)
    assert port.post_transform is None
    assert (port.blocks is None) == (packing == "standard")
    ref_graphs = _graphs(domain, jsyn)
    if domain == "bio":
        for g, r in zip(graphs, ref_graphs):
            np.testing.assert_array_equal(
                g.y, r.extras["go_target_pretrain"][0])
            assert sorted(g.extras) == ["center_node_idx"]
        ref_graphs = [dataclasses.replace(
            r, y=np.asarray(r.extras["go_target_pretrain"][0], np.float32),
            extras={"center_node_idx": r.extras["center_node_idx"]})
            for r in ref_graphs]
    ref = jpk.PackedLoader(
        graphs=ref_graphs, batch_size=BATCH, max_nodes=port.max_nodes,
        max_edges=port.max_edges, seed=0, blocks=port.blocks, drop_last=True,
        extra_pad={"center_node_idx": BATCH} if domain == "bio" else None)
    pb, rb = list(port), list(ref)
    assert len(pb) == len(rb) == N_GRAPHS // BATCH
    for p, r in zip(pb, rb):
        for f in ("node_feat", "senders", "receivers", "node_graph",
                  "node_mask", "edge_mask", "graph_mask", "y"):
            np.testing.assert_array_equal(
                np.asarray(getattr(p, f)), np.asarray(getattr(r, f)),
                err_msg=f)
        assert p.y.shape == (BATCH, T) and p.max_graphs == BATCH
        assert sorted(p.extras) == sorted(r.extras)
        for k in r.extras:
            np.testing.assert_array_equal(np.asarray(p.extras[k]),
                                          np.asarray(r.extras[k]), err_msg=k)
        if domain == "bio":
            assert p.extras["center_node_idx"].shape == (BATCH,)


# --- readouts ----------------------------------------------------------------


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "attention",
                                  "set2set2", "set2set3"])
def test_pool_matches_jax(data, pool):
    """Every readout on a batch with padded nodes and empty graph slots,
    value and gradient of ``h``; the modules' weights come from JAX."""
    batch = data[3][-1]
    rng = np.random.default_rng(0)
    h = (rng.normal(size=(batch.max_nodes, EMB)) * 2).astype(np.float32)
    g = rng.normal(size=(BATCH, EMB * (2 if "set2set" in pool else 1)))
    g = g.astype(np.float32)
    jb = _jax_batch(batch)
    if pool in ("sum", "mean", "max"):
        jfn = getattr(jpools, f"{pool}_pool")
        f = lambda hh: jfn(hh, jb)
        tfn, width = tpools.make_pool(pool, EMB)
        assert tfn is getattr(tpools, f"{pool}_pool") and width == EMB
    else:
        jmod = (jpools.GlobalAttentionPool(EMB) if pool == "attention" else
                jpools.Set2SetPool(EMB, int(pool[-1])))
        variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(h), jb)
        f = lambda hh: jmod.apply(variables, hh, jb)
        tfn, width = tpools.make_pool(pool, EMB)
        assert width == g.shape[1]
        _load(tfn, variables)
    ref, vjp = jax.vjp(f, jnp.asarray(h))
    (dh_ref,) = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).requires_grad_(True)
    out = tfn(ht, batch.to("cpu"))
    (dh,) = torch.autograd.grad(out, [ht], torch.from_numpy(g))
    assert out.shape == ref.shape == g.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **GRAD_TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_ref), **GRAD_TOL)
    # an empty graph slot reads 0 (set2set: its q from the LSTM biases)
    empty = ~np.asarray(batch.graph_mask)
    assert not out.detach().numpy()[empty, -EMB:].any()


def test_pool_names_and_lstm_layout():
    with pytest.raises(ValueError, match="pooling"):
        tpools.make_pool("median", EMB)
    with pytest.raises(ValueError, match="pooling"):
        tpools.make_pool("set2set2", EMB, allow_set2set=False)
    cell = tpools.Set2SetPool(EMB, 2).lstm
    assert cell.weight_ih.shape == (2 * EMB, 4 * EMB)
    assert cell.weight_hh.shape == (EMB, 4 * EMB)
    bound = 1 / math.sqrt(EMB)
    for p in cell.parameters():
        assert float(p.detach().abs().max()) <= bound
    a = tpools.Set2SetPool(EMB, 2)
    b = tpools.Set2SetPool(EMB, 2)
    for m in (a, b):
        tpretrain.init_parameters(m, torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


# --- the graph-level heads ---------------------------------------------------


def _pred_pair(domain, batch, T, **kw):
    jcls = jbio.GNNGraphPred if domain == "bio" else jchem.GNNGraphPred
    tcls = tbio.GNNGraphPred if domain == "bio" else tchem.GNNGraphPred
    args = dict(num_layer=LAYERS, emb_dim=EMB, num_tasks=T, **kw)
    jm = jcls(**args)
    variables = jm.init(jax.random.PRNGKey(2), _jax_batch(batch),
                        train=False)
    stats = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.arange(v.shape[0], dtype=v.dtype) / v.shape[0],
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    return jm, variables, _load(tcls(**args), variables)


@pytest.mark.parametrize("packing", ["blocked", "standard"])
@pytest.mark.parametrize("pooling,jk", [("mean", "last"), ("sum", "sum"),
                                        ("max", "last"),
                                        ("attention", "last")])
def test_graph_pred_matches_jax(domain, packing, pooling, jk):
    """Eval-mode logits of both domains' heads (bio: the pooled
    representation beside the center node's) on blocked and standard
    batches."""
    graphs, T = tpretrain.supervised_graphs(_graphs(domain), domain)
    batch = next(iter(tpretrain.build_loader(
        _cfg(domain, packing, num_tasks=T), graphs, CPU)))
    jm, variables, tm = _pred_pair(domain, batch, T, graph_pooling=pooling,
                                   jk=jk)
    with jax_backend("pallas" if packing == "blocked" else "xla"):
        ref = jm.apply(variables, _jax_batch(batch), train=False)
    with torch.no_grad():
        out = tm(batch.to("cpu"), train=False)
    assert out.shape == (BATCH, T)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("pooling,jk,width", [("set2set2", "last", 2 * EMB),
                                              ("mean", "concat",
                                               (LAYERS + 1) * EMB)])
def test_chem_graph_pred_widths_match_jax(pooling, jk, width):
    """The chem head under set2set (doubled width) and under JK concat."""
    graphs, T = tpretrain.supervised_graphs(_graphs("chem"), "chem")
    batch = next(iter(tpretrain.build_loader(_cfg("chem", num_tasks=T),
                                             graphs, CPU)))
    jm, variables, tm = _pred_pair("chem", batch, T, graph_pooling=pooling,
                                   jk=jk)
    assert tm.graph_pred_linear.in_features == width
    assert jm.jk_dim() == tm.jk_dim()
    ref = jm.apply(variables, _jax_batch(batch), train=False)
    with torch.no_grad():
        out = tm(batch.to("cpu"), train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


def test_bio_graph_pred_has_no_set2set():
    with pytest.raises(ValueError, match="pooling"):
        tbio.GNNGraphPred(num_layer=2, emb_dim=16, graph_pooling="set2set2")


# --- losses ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["masked_task_bce", "plain_bce"])
@pytest.mark.parametrize("case", ["mixed", "all_missing_or_padded"])
def test_losses_match_jax(name, case):
    """Both BCEs, value and gradient, with missing labels (0) and padded
    graph slots; with nothing valid the loss is 0 and finite."""
    rng = np.random.default_rng(3)
    G, T = 12, 7
    logits = (rng.normal(size=(G, T)) * 3).astype(np.float32)
    if name == "plain_bce":
        y = (rng.random((G, T)) < 0.3).astype(np.float32)
    else:
        y = rng.choice([-1.0, 0.0, 1.0], size=(G, T)).astype(np.float32)
    mask = np.arange(G) < 9
    if case == "all_missing_or_padded":
        if name == "plain_bce":
            mask = np.zeros(G, bool)
        else:
            y[mask] = 0.0
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    ref, dref = jax.value_and_grad(
        lambda l: jfn(l, jnp.asarray(y), jnp.asarray(mask)))(
            jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = tfn(lt, torch.from_numpy(y), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(dref), **GRAD_TOL)
    assert not lt.grad.numpy()[~mask].any()
    if case == "all_missing_or_padded":
        assert float(loss.detach()) == 0.0 and not lt.grad.any()


# --- the objective -----------------------------------------------------------


def _pair(data, pooling="mean"):
    """JAX objective + variables, and the port's objective holding the
    same parameters (strict load)."""
    domain, _, T, batches = data
    args = dict(num_tasks=T, num_layer=LAYERS, emb_dim=EMB,
                graph_pooling=pooling, domain=domain)
    jm = JaxSupervised(**args)
    variables = jm.init({"params": jax.random.PRNGKey(0)},
                        _jax_batch(batches[0]), train=False)
    return jm, variables, _load(tsup.SupervisedObjective(**args), variables)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_train_step_loss_grads_and_bn_stats_match_jax(data, backend):
    """One train-mode step (dropout 0) on the batch with padded graph
    slots: the loss, every gradient and the batch-norm statistics."""
    batch = data[3][-1]
    jm, variables, tm = _pair(data)

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
    assert tmetrics == {} and jmetrics == {}
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    names = [n for n, _ in tm.named_parameters()]
    assert "pred.graph_pred_linear.weight" in names
    assert tsup.TRUNK_PATH == ("pred", "gnn") and tm.gnn is tm.pred.gnn
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


def test_adam_trajectory_matches_jax(data):
    """Four Adam steps over the batches, dropout 0: the losses agree."""
    batches = data[3]
    jm, variables, tm = _pair(data)
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


@pytest.mark.parametrize("pooling", ["mean", "attention", "set2set2"])
def test_state_dict_from_jax_loads_supervised_objective(pooling):
    """The head's leaves by name; the LSTM's raw arrays keep their names
    and layout (they are not embedding tables)."""
    graphs, T = tpretrain.supervised_graphs(_graphs("chem"), "chem")
    batches = list(tpretrain.build_loader(_cfg("chem", num_tasks=T), graphs,
                                          CPU))
    _, variables, tm = _pair(("chem", graphs, T, batches), pooling)
    sd = state_dict_from_jax(_np_tree(variables["params"]),
                             _np_tree(variables["batch_stats"]))
    head = {k for k in sd if not k.startswith("pred.gnn.")}
    want = {"pred.graph_pred_linear.weight", "pred.graph_pred_linear.bias"}
    if pooling == "attention":
        want |= {"pred.pool.gate_nn.weight", "pred.pool.gate_nn.bias"}
    if pooling == "set2set2":
        want |= {f"pred.pool.lstm.{n}" for n in
                 ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        assert sd["pred.pool.lstm.weight_ih"].shape == (2 * EMB, 4 * EMB)
    assert head == want == {n for n in tm.state_dict()
                            if not n.startswith("pred.gnn.")}
    assert sd["pred.graph_pred_linear.weight"].shape == (
        T, EMB * (2 if pooling == "set2set2" else 1))


def test_build_objective_and_unported(data):
    domain, graphs, T, batches = data
    cfg = _cfg(domain, num_tasks=T, graph_pooling="attention",
               dropout_ratio=0.2)
    a, b = tpretrain.build_objective(cfg), tpretrain.build_objective(cfg)
    assert isinstance(a, tsup.SupervisedObjective)
    assert a.pred.graph_pred_linear.out_features == T
    assert a.gnn.drop_ratio == 0.2
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    with pytest.raises(ValueError, match="labels"):
        a(batches[0].replace(y=None).to("cpu"))
    # context prediction is ported too; an unknown objective is not
    assert hasattr(tpretrain.build_objective(tpretrain.PretrainConfig(
        objective="contextpred", domain=domain, num_layer=2, emb_dim=16)),
        "gnn_substruct")
    with pytest.raises(NotImplementedError, match="not ported"):
        tpretrain.build_objective(
            tpretrain.PretrainConfig(objective="graphcl", domain=domain))


# --- dropout -----------------------------------------------------------------


@pytest.mark.parametrize("trunk", ["chem", "bio"])
@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_masks(trunk, p):
    """Inverted dropout from a seeded generator: the same seed gives the
    same bits, another seed other bits; the kept share lies within 3 sigma
    of 1 - p; kept entries are scaled by 1 / (1 - p); eval mode is the
    identity."""
    cls = tbio.GNN if trunk == "bio" else tchem.GNN
    gnn = cls(num_layer=2, emb_dim=16, drop_ratio=p)
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(500, 40)).astype(np.float32)) + 5.0  # no zeros
    gnn.seed_dropout(7)
    a1, a2 = gnn.dropout(h, True), gnn.dropout(h, True)
    gnn.seed_dropout(7)
    b1 = gnn.dropout(h, True)
    gnn.seed_dropout(8)
    c1 = gnn.dropout(h, True)
    assert torch.equal(a1, b1)
    assert not torch.equal(a1, a2) and not torch.equal(a1, c1)
    kept = a1 != 0
    n = h.numel()
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(float(kept.float().mean()) - (1 - p)) <= 3 * sigma
    np.testing.assert_allclose(a1[kept].numpy(), (h[kept] / (1 - p)).numpy(),
                               rtol=1e-6)
    assert gnn.dropout(h, False) is h
    assert cls(num_layer=2, emb_dim=16).dropout(h, True) is h  # p = 0


def test_dropout_in_the_step(data):
    """Through the objective: train mode with dropout differs from the
    dropout-free loss and repeats under the same seed; eval mode ignores
    ``drop_ratio``; the seed comes from the config."""
    domain, _, T, batches = data
    batch = batches[0].to("cpu")
    cfg = _cfg(domain, num_tasks=T, dropout_ratio=0.5)
    m0 = tpretrain.build_objective(_cfg(domain, num_tasks=T))
    m1, m2 = tpretrain.build_objective(cfg), tpretrain.build_objective(cfg)
    with torch.no_grad():
        ref = float(m0(batch, train=True)[0])
        l1a, l1b = (float(m1(batch, train=True)[0]) for _ in range(2))
        l2 = float(m2(batch, train=True)[0])
        assert l1a == l2 and l1a != l1b and l1a != ref
        # eval mode, on fresh running statistics
        assert float(tpretrain.build_objective(cfg)(batch, train=False)[0]) \
            == float(tpretrain.build_objective(
                _cfg(domain, num_tasks=T))(batch, train=False)[0])
    m3 = tpretrain.build_objective(dataclasses.replace(cfg, seed=1))
    assert m3.gnn._dropout_seed == 1 and m1.gnn._dropout_seed == 0


# --- the entry points ----------------------------------------------------------


def test_run_pretrain_supervised_on_cpu(data):
    domain, graphs, T, _ = data
    cfg = _cfg(domain, num_tasks=T, dropout_ratio=0.2,
               graph_pooling="attention")
    res = tpretrain.run_pretrain(cfg, graphs, log=None, epochs=2,
                                 device="cpu")
    hist = res["history"]
    assert [h["steps"] for h in hist] == [N_GRAPHS // BATCH] * 2
    assert all(np.isfinite(h["loss"]) and h["edges"] > 0 for h in hist)
    assert sorted(hist[0]) == ["edges", "epoch", "loss", "steps"]


@pytest.mark.parametrize("flags,trunk", [
    ([], tchem.GNN), (["--graph_pooling", "set2set2"], tchem.GNN),
    (["--domain", "bio", "--graph_pooling", "attention"], tbio.GNN)])
def test_cli_supervised_one_epoch_on_cpu(tmp_path, flags, trunk):
    out = tmp_path / "trunk"
    history = cli.main([
        "--objective", "supervised", "--device", "cpu", "--epochs", "1",
        "--num_layer", "2", "--emb_dim", "32", "--batch_size", "16",
        "--n_synthetic", "256", "--packing", "blocked",
        "--output_model_file", str(out), *flags,
    ])
    # bio: max(256 // 4, 64) graphs, of which the species split keeps 60
    # (56 of the seven train/valid species and half of the 8 human ones)
    steps = 3 if "bio" in flags else 16
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] == steps and history[0]["edges"] > 0
    saved = torch.load(str(out) + ".pth")
    trunk(num_layer=2, emb_dim=32).load_state_dict(saved, strict=True)


def test_cli_dropout_default_and_unported_flags(tmp_path):
    parse = cli.build_parser().parse_args
    assert cli.resolve_dropout(parse(["--objective", "supervised"])) == 0.2
    assert cli.resolve_dropout(parse(["--objective", "masking"])) == 0.0
    assert cli.resolve_dropout(parse(["--objective", "supervised",
                                      "--dropout_ratio", "0.4"])) == 0.4
    assert parse([]).split == "species"  # ported: the JAX CLI's default
    # ported: --input_model_file (tests/test_torch_port_trunk_io.py)
    assert parse(["--input_model_file", "t.pth"]).input_model_file == \
        "t.pth"
    # real datasets come from the store under --data_root
    with pytest.raises(FileNotFoundError,
                       match="pretrain_gnns_tpu_torch.cli.featurize"):
        cli.main(["--objective", "supervised", "--device", "cpu",
                  "--dataset", "chembl_filtered", "--data_root",
                  str(tmp_path)])
