"""The port's fine-tuning stage against the JAX package's, on the same
seeded data: the splitters (data/splitters.py), the metrics
(train/metrics.py), ``optim.finetune_adam``, the loaders' ``shuffle``,
train/finetune.py (one train step, one eval pass, a 3-epoch run, the
10-fold protocol) and cli/finetune.py.

The JAX side runs its XLA path (``packing="standard"`` on the CPU) in
float32; the port starts from the JAX run's initial variables, carried
over by ``compat.from_jax.state_dict_from_jax`` in place of its own
seeded draws. Dropout is 0: its masks come from another generator than
flax's. Sizes: 2 layers, emb 32, batches of 16 graphs. Tolerances: the
train loss rtol 1e-5, gradients and batch-norm statistics rtol 1e-4 /
atol 1e-5, eval logits rtol 1e-5 / atol 1e-6 (float32 on both sides,
another summation order); over 3 epochs the per-epoch train loss rtol
1e-4 and the AUCs 1e-4. The splitters and metrics are equal exactly; the
cross-validation folds are scikit-learn's ``StratifiedKFold`` (checked
against scikit-learn 1.9.0, which the JAX package calls). About 60 s
alone."""

import contextlib
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pretrain_gnns_tpu.cli import finetune as jcli
from pretrain_gnns_tpu.compat import import_params as jimport
from pretrain_gnns_tpu.compat import torch_writer as jwriter
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import datasets as jdatasets
from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import splitters as jsplit
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.objectives import losses as jlosses
from pretrain_gnns_tpu.train import finetune as jft
from pretrain_gnns_tpu.train import metrics as jmetrics
from pretrain_gnns_tpu.train import optim as joptim
from pretrain_gnns_tpu_torch.cli import finetune as cli
from pretrain_gnns_tpu_torch.cli import pretrain as pcli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.core.graphs import NODE_IDX
from pretrain_gnns_tpu_torch.data import datasets as tdatasets
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data import splitters as tsplit
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.train import checkpoints
from pretrain_gnns_tpu_torch.train import finetune as tft
from pretrain_gnns_tpu_torch.train import metrics as tmetrics
from pretrain_gnns_tpu_torch.train import optim as toptim
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH = 2, 32, 16
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
AUC_TOL = 1e-4


# --- splitters ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n", [37, 240])
def test_splits_equal_jax(seed, n):
    """Random, scaffold and random-scaffold splits index for index, with
    and without a task filter, on the synthetic pseudo-scaffolds (few
    large groups) and on many small groups; the species split of the
    synthetic ego-networks."""
    graphs, pseudo = tsyn.molecule_dataset(n, num_tasks=3, seed=seed,
                                           mean_atoms=12, missing_frac=0.3)
    y = np.stack([g.y for g in graphs])
    rng = np.random.default_rng(seed)
    many = [f"c{int(v)}" for v in rng.integers(0, max(n // 3, 2), n)]
    for kw in ({}, {"y": y, "task_idx": 1}):
        assert (tsplit.random_split(n, seed=seed, **kw)
                == jsplit.random_split(n, seed=seed, **kw))
        for scaffolds in (pseudo, many):
            got = tsplit.scaffold_split(scaffolds, **kw)
            assert got == jsplit.scaffold_split(scaffolds, **kw)
            assert sum(map(len, got)) == (n if not kw else int(
                (y[:, 1] != 0).sum()))
            assert (tsplit.random_scaffold_split(scaffolds, seed=seed, **kw)
                    == jsplit.random_scaffold_split(scaffolds, seed=seed,
                                                    **kw))
    assert (tsplit.random_split(n, frac_train=0.5, frac_valid=0.5,
                                frac_test=0.0, seed=seed)
            == jsplit.random_split(n, frac_train=0.5, frac_valid=0.5,
                                   frac_test=0.0, seed=seed))
    species = np.array([g.extras["species_id"][0][0]
                        for g in tsyn.bio_dataset(n, seed=seed,
                                                  mean_nodes=12)])
    assert tsplit.species_split(species) == jsplit.species_split(species)


@pytest.mark.parametrize("labels", ["balanced", "skewed", "three_classes"])
@pytest.mark.parametrize("seed", [0, 7])
def test_cv_folds_equal_jax(labels, seed):
    """Every fold of the 10-fold stratified split equals the JAX one
    (scikit-learn's ``StratifiedKFold(shuffle=True)``); the folds
    partition the set, each class spread over the folds."""
    rng = np.random.default_rng(seed)
    n = 83
    if labels == "balanced":
        y = np.where(np.arange(n) % 2, 1.0, -1.0)
        rng.shuffle(y)
    elif labels == "skewed":
        y = np.where(rng.random(n) < 0.15, 1.0, -1.0)
    else:
        y = rng.choice([-1.0, 0.0, 1.0], n, p=[0.5, 0.3, 0.2])
    seen = []
    for fold in range(10):
        got = tsplit.cv_random_split(list(y), fold_idx=fold, seed=seed)
        assert got == jsplit.cv_random_split(list(y), fold_idx=fold,
                                             seed=seed)
        assert sorted(got[0] + got[1]) == list(range(n))
        seen += got[1]
    assert sorted(seen) == list(range(n))
    with pytest.raises(ValueError, match="n_splits"):
        tsplit.cv_random_split([1.0, -1.0] * 3, n_splits=10)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_bio"])
def test_synthetic_datasets_equal_jax(name):
    """The CLIs' datasets are the JAX ``load_dataset``'s: graphs, labels,
    scaffolds and task counts; a dataset that is not stored raises, naming
    the port's featurizer."""
    graphs, scaffolds, meta = tdatasets.load_dataset(name, "unused", 96,
                                                     seed=42)
    ref, ref_scaffolds, ref_meta = jdatasets.load_dataset(name, "unused", 96,
                                                          seed=42)
    assert meta == ref_meta and scaffolds == ref_scaffolds
    assert len(graphs) == len(ref) == (96 if name == "synthetic" else 64)
    for a, b in zip(graphs, ref):
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.y, b.y)
    with pytest.raises(FileNotFoundError,
                       match="pretrain_gnns_tpu_torch.cli.featurize"):
        tdatasets.load_dataset("tox21", "unused", 96)


# --- metrics -----------------------------------------------------------------


def test_metrics_equal_jax():
    """Exactly the JAX metrics: ties (integer scores), missing labels
    (chem's 0 entries), tasks with one class (left out; all of them: NaN),
    an absent class (bio's NaN) and scores of 0 (a negative sign)."""
    rng = np.random.default_rng(0)
    G, T = 50, 6
    for trial in range(10):
        s = rng.integers(-3, 4, (G, T)).astype(np.float32) if trial % 2 \
            else rng.normal(size=(G, T)).astype(np.float32)
        y = rng.choice([-1.0, 0.0, 1.0], (G, T)).astype(np.float32)
        y[:, 2] = np.where(y[:, 2] == 1, -1.0, y[:, 2])  # one class only
        assert tmetrics.chem_mean_auc(y, s) == jmetrics.chem_mean_auc(y, s)
        y01 = (rng.random((G, T)) < 0.3).astype(np.float32)
        y01[:, 4] = 0.0
        a, b = tmetrics.bio_auc_array(y01, s), jmetrics.bio_auc_array(y01, s)
        np.testing.assert_array_equal(a, b)
        assert np.isnan(a[4]) and not np.isnan(a[:4]).any()
        sign = np.where(y[:, 0] == 0, 1.0, y[:, 0])
        assert (tmetrics.accuracy_from_scores(sign, s[:, 0])
                == jmetrics.accuracy_from_scores(sign, s[:, 0]))
        for t in range(T):
            if 0 < y01[:, t].sum() < G:
                assert tmetrics.roc_auc(y01[:, t], s[:, t]) == \
                    jmetrics.roc_auc(y01[:, t], s[:, t])
    y[:, :] = -1.0
    assert np.isnan(tmetrics.chem_mean_auc(y, s))
    assert tmetrics.accuracy_from_scores(np.array([-1.0, 1.0]),
                                         np.array([0.0, 0.0])) == 0.5
    with pytest.raises(ValueError, match="both classes"):
        tmetrics.roc_auc(np.ones(4), np.arange(4.0))


# --- the optimizer -----------------------------------------------------------


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.gnn = nn.Linear(5, 4)
        self.pool = nn.Linear(4, 1)
        self.graph_pred_linear = nn.Linear(4, 3)


@pytest.mark.parametrize("lr_scale", [1.0, 2.0])
@pytest.mark.parametrize("decay", [0.0, 0.01])
def test_finetune_adam_matches_optax(lr_scale, decay):
    """Four steps on the same gradients: the trunk at lr, the pool and
    head at lr * lr_scale, AdamW under decay, as the JAX
    ``finetune_adam``: the parameters within float32 rounding of the
    update's arithmetic (atol 1e-6 against steps of about 1e-2)."""
    model = _Toy()
    opt = toptim.finetune_adam(model, 1e-2, lr_scale, decay)
    assert [g["lr"] for g in opt.param_groups] == [1e-2, 1e-2 * lr_scale]
    assert opt.param_groups[0]["params"] == list(model.gnn.parameters())
    assert isinstance(opt, torch.optim.AdamW if decay else torch.optim.Adam)

    def tree(f):
        return {name: {"kernel": f(m.weight).T, "bias": f(m.bias)}
                for name, m in model.named_children()}

    # copies: a zero-copy array would follow the in-place torch steps
    params = tree(lambda t: jnp.array(t.detach().numpy().copy()))
    tx = joptim.finetune_adam(1e-2, lr_scale, decay)
    opt_state = tx.init(params)
    rng = np.random.default_rng(1)
    for _ in range(4):
        for p in model.parameters():
            p.grad = torch.from_numpy(
                rng.normal(size=tuple(p.shape)).astype(np.float32))
        grads = tree(lambda t: jnp.array(t.grad.numpy().copy()))
        opt.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    got = tree(lambda t: t.detach().numpy())
    for name in got:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][leaf],
                                       np.asarray(params[name][leaf]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{leaf}")


# --- the loaders' shuffle ----------------------------------------------------


@pytest.mark.parametrize("flat", [True, False], ids=["FlatLoader",
                                                     "PackedLoader"])
def test_make_loader_shuffle(flat):
    """``shuffle=False`` keeps the graphs' order, and the epoch's generator
    ``default_rng((seed, epoch))`` still feeds ``post_transform``; the
    default shuffles as the JAX ``make_loader`` does, batch for batch, and
    both flags give the JAX loader's order."""
    graphs = [dataclasses.replace(g, y=np.array([i], np.float32), extras={})
              for i, g in enumerate(tsyn.molecule_dataset(40, seed=4)[0])]
    pad = None
    if not flat:  # a ragged extra: the graphs do not flatten
        for i, g in enumerate(graphs):
            g.extras["anchors"] = (np.arange(1 + i % 3), NODE_IDX)
        pad = {"anchors": 64}
    jgraphs = [jg.Graph(g.node_feat, g.edge_index, g.edge_feat, y=g.y,
                        extras=dict(g.extras)) for g in graphs]
    seen = []

    def post(batch, rng):
        seen.append(rng.random())
        return batch

    def order(loader):
        return [int(v) for b in loader
                for v in np.asarray(b.y)[np.asarray(b.graph_mask), 0]]

    for shuffle in (False, True):
        kw = dict(seed=7, extra_pad=pad, **({} if shuffle else
                                             {"shuffle": False}))
        with pytest.warns(UserWarning) if not flat else \
                contextlib.nullcontext():
            loader = tpk.make_loader(graphs, BATCH, post_transform=post, **kw)
        assert type(loader).__name__ == ("FlatLoader" if flat
                                         else "PackedLoader")
        seen.clear()
        got = [order(loader), order(loader)]
        assert len(seen) == 2 * len(loader)
        for epoch in (0, 1):  # the epoch's generator, after the shuffle
            rng = np.random.default_rng((7, epoch))
            if shuffle:
                rng.shuffle(np.arange(40))
            assert seen[epoch * len(loader)] == rng.random()
        ref = jpk.make_loader(jgraphs, BATCH, **kw)
        assert got == [order(ref), order(ref)]
        if not shuffle:
            assert got == [list(range(40))] * 2
        else:
            assert got[0] != list(range(40)) and got[0] != got[1]


# --- fine-tuning -------------------------------------------------------------


def _jax_batch(p):
    return jg.PackedGraphs(
        node_feat=jnp.asarray(p.node_feat), edge_feat=jnp.asarray(p.edge_feat),
        senders=jnp.asarray(p.senders), receivers=jnp.asarray(p.receivers),
        node_graph=jnp.asarray(p.node_graph),
        node_mask=jnp.asarray(p.node_mask),
        edge_mask=jnp.asarray(p.edge_mask),
        graph_mask=jnp.asarray(p.graph_mask),
        y=None if p.y is None else jnp.asarray(p.y),
        extras={k: jnp.asarray(v) for k, v in p.extras.items()})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dataset(domain, mod):
    """(graphs, scaffolds) from the port's generators or, with ``mod`` the
    JAX package's, from theirs: chem labels with missing entries, bio
    ego-networks of 16 nodes on average and 8 tasks."""
    if domain == "bio":
        return mod.bio_dataset(128, num_downstream=8, seed=5,
                               mean_nodes=16), None
    return mod.molecule_dataset(120, num_tasks=3, seed=5, mean_atoms=14,
                                missing_frac=0.2)


def _split(domain, graphs, scaffolds, split_of):
    split = "species" if domain == "bio" else "random"
    return split_of(types.SimpleNamespace(split=split, seed=3), graphs,
                    scaffolds)


def _cfgs(domain, **kw):
    kw = dict(domain=domain, num_tasks=8 if domain == "bio" else 3,
              num_layer=LAYERS, emb_dim=EMB, dropout_ratio=0.0,
              batch_size=BATCH, epochs=3, runseed=2, packing="standard",
              **kw)
    return jft.FinetuneConfig(**kw), tft.FinetuneConfig(**kw)


@pytest.fixture(scope="module", params=["chem", "bio"])
def run(request, tmp_path_factory):
    """Both packages' splits of the domain's dataset, the JAX model and its
    initial variables (``init_state``) with a JAX-exported trunk grafted
    into chem's, and both packages' 3-epoch runs from those variables."""
    domain = request.param
    splits = _split(domain, *_dataset(domain, tsyn), cli.split_dataset)
    jsplits = _split(domain, *_dataset(domain, jsyn), jcli.split_dataset)
    jcfg, tcfg = _cfgs(domain)
    jmodel = jft.build_model(jcfg)
    sample = next(iter(jpk.PackedLoader(
        jsplits[1], BATCH, shuffle=False,
        extra_pad={"center_node_idx": BATCH} if domain == "bio" else None)))
    trunk = jtrunk = None
    if domain == "chem":
        other = jft.build_model(jcfg).init(jax.random.PRNGKey(11), sample,
                                           train=False)
        path = tmp_path_factory.mktemp("trunk") / "t.pth"
        jwriter.save_state_dict(jimport.trunk_to_torch(_np_tree({
            "params": other["params"]["gnn"],
            "batch_stats": other["batch_stats"]["gnn"]})), str(path))
        jtrunk = jimport.load_trunk(str(path))
        trunk = checkpoints.load_trunk_any(path)
    jstate, _ = jft.init_state(jcfg, jmodel, sample)
    initial = state_dict_from_jax(_np_tree(jstate.params),
                                  _np_tree(jstate.batch_stats))
    jres = jft.run_finetune(jcfg, *jsplits[:3], pretrained_trunk=jtrunk,
                            log=None, extra_test=jsplits[3])
    with pytest.MonkeyPatch.context() as mp:
        # the port starts from the JAX run's draws, then grafts the trunk
        mp.setattr(tft, "init_parameters",
                   lambda model, gen: model.load_state_dict(initial,
                                                            strict=True))
        tres = tft.run_finetune(tcfg, *splits[:3], pretrained_trunk=trunk,
                                log=None, extra_test=splits[3],
                                device="cpu")
    return dict(domain=domain, splits=splits, jsplits=jsplits, jcfg=jcfg,
                tcfg=tcfg, jmodel=jmodel, jstate=jstate, initial=initial,
                jres=jres, tres=tres)


def _port_state(run):
    model = tft.build_model(run["tcfg"])
    model.load_state_dict(run["initial"], strict=True)
    cfg = run["tcfg"]
    return TrainState(model, toptim.finetune_adam(model, cfg.lr, cfg.lr_scale,
                                                  cfg.decay))


def test_splits_of_the_runs_equal_jax(run):
    """The CLI's ``split_dataset`` gives the JAX CLI's graphs (bio: the
    species split with its hard half of the human graphs)."""
    for mine, ref in zip(run["splits"][:3], run["jsplits"][:3]):
        assert len(mine) == len(ref) > 0
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.node_feat, b.node_feat)
            np.testing.assert_array_equal(a.y, b.y)
    if run["domain"] == "bio":
        assert [len(v) for v in run["splits"][3].values()] == [
            len(v) for v in run["jsplits"][3].values()] == [8]
    else:
        assert run["splits"][3] is run["jsplits"][3] is None


def test_train_step_matches_jax(run):
    """One train step on the first train batch (standard layout, dropout
    0): the loss, every gradient and the batch-norm statistics."""
    jcfg, jmodel, jstate = run["jcfg"], run["jmodel"], run["jstate"]
    batch = next(iter(tpk.make_loader(
        run["splits"][0], BATCH, shuffle=False,
        extra_pad={"center_node_idx": BATCH} if run["domain"] == "bio"
        else None)))
    jb = _jax_batch(batch)
    loss_of = (jlosses.plain_bce if run["domain"] == "bio"
               else jlosses.masked_task_bce)

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": jstate.batch_stats}, jb,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_of(out, jb.y, jb.graph_mask), mutated

    (jloss, mutated), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(jstate.params)
    state = _port_state(run)
    loss = tft.make_train_step(run["tcfg"].loss_kind)(state,
                                                      batch.to("cpu"))
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated["batch_stats"]))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    stats = [n for n, _ in state.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    # chem: one batch norm a layer; bio GIN: one inside each layer's MLP
    assert len(stats) == 2 * LAYERS
    for name, b in state.model.named_buffers():
        if name in stats:
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


def test_eval_pass_matches_jax(run):
    """An eval pass over the test loader (unshuffled, its last batch
    partly empty), batch norm from running statistics moved off their
    initial values: the logits of every graph slot and the metric."""
    jstate = run["jstate"].replace(batch_stats=jax.tree_util.tree_map(
        lambda v: v * 1.3 + 0.2, run["jstate"].batch_stats))
    state = _port_state(run)
    state.model.load_state_dict(state_dict_from_jax(
        _np_tree(jstate.params), _np_tree(jstate.batch_stats)), strict=True)
    pad = {"center_node_idx": BATCH} if run["domain"] == "bio" else None
    loader = tpk.make_loader(run["splits"][2], BATCH, shuffle=False,
                             extra_pad=pad)
    batches = list(loader)
    assert not batches[-1].graph_mask.all() and batches[-1].graph_mask.any()
    jstep, tstep = jft.make_eval_step(run["jmodel"]), tft.make_eval_step()
    for b in batches:
        ref = np.asarray(jstep(jstate, _jax_batch(b)))
        out = tstep(state, b.to("cpu"))
        assert not out.requires_grad and not state.model.training
        np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)
    metric = "bio_auc" if run["domain"] == "bio" else "chem_auc"
    ref = jft.evaluate(jstep, jstate, jpk.make_loader(
        run["jsplits"][2], BATCH, shuffle=False, extra_pad=pad), metric)
    got = tft.evaluate(tstep, state, loader, metric)
    assert abs(got - ref) <= 1e-6


def test_three_epoch_run_matches_jax(run):
    """``run_finetune`` for 3 epochs from the JAX run's initial variables
    (chem with a pretrained trunk grafted): per-epoch train loss, the
    validation and test curves (bio: ``test_hard`` too), the selected
    epoch, its AUCs and bio's per-task AUCs there."""
    jres, tres = run["jres"], run["tres"]
    assert set(tres["curves"]) == set(jres["curves"])
    np.testing.assert_allclose(tres["curves"]["train_loss"],
                               jres["curves"]["train_loss"], **RUN_LOSS_TOL)
    assert len(set(np.round(tres["curves"]["train_loss"], 6))) == 3
    for name in tres["curves"]:
        if name != "train_loss":
            np.testing.assert_allclose(tres["curves"][name],
                                       jres["curves"][name], rtol=0,
                                       atol=AUC_TOL, err_msg=name)
    assert tres["best_epoch"] == jres["best_epoch"]
    assert abs(tres["val_auc"] - jres["val_auc"]) <= AUC_TOL
    assert abs(tres["test_auc"] - jres["test_auc"]) <= AUC_TOL
    if run["domain"] == "bio":
        assert sorted(tres["task_auc"]) == sorted(jres["task_auc"]) == [
            "test", "test_hard"]
        for name, arr in tres["task_auc"].items():
            np.testing.assert_allclose(arr, jres["task_auc"][name], rtol=0,
                                       atol=AUC_TOL, err_msg=name)
    else:
        assert "task_auc" not in tres and "task_auc" not in jres
    hist = tres["history"]
    assert [h["steps"] for h in hist] == [len(run["splits"][0]) // BATCH
                                          + bool(len(run["splits"][0])
                                                 % BATCH)] * 3
    assert all(h["edges"] > 0 and h["eval_graphs"] > 0 for h in hist)
    assert tres["state"].step == sum(h["steps"] for h in hist)


def test_run_finetune_cv_matches_jax():
    """The 10-fold protocol's fold 3: the same validation fold, accuracy
    curve and selected epoch."""
    graphs, _ = tsyn.molecule_dataset(72, num_tasks=1, seed=8, mean_atoms=12)
    jgraphs, _ = jsyn.molecule_dataset(72, num_tasks=1, seed=8,
                                       mean_atoms=12)
    jcfg, tcfg = _cfgs("chem", seed=1)
    jcfg.num_tasks = tcfg.num_tasks = 1
    jcfg.batch_size = tcfg.batch_size = 8
    jcfg.epochs = tcfg.epochs = 2
    jmodel = jft.build_model(jcfg)
    sample = next(iter(jpk.PackedLoader(jgraphs, 8, shuffle=False)))
    jstate, _ = jft.init_state(jcfg, jmodel, sample)
    initial = state_dict_from_jax(_np_tree(jstate.params),
                                  _np_tree(jstate.batch_stats))
    jres = jft.run_finetune_cv(jcfg, jgraphs, fold_idx=3, log=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tft, "init_parameters",
                   lambda model, gen: model.load_state_dict(initial,
                                                            strict=True))
        tres = tft.run_finetune_cv(tcfg, graphs, fold_idx=3, log=None,
                                   device="cpu")
    assert tres["fold_idx"] == jres["fold_idx"] == 3
    labels = [float(g.y[0]) for g in graphs]
    assert len(tsplit.cv_random_split(labels, 3, seed=1)[1]) == 7
    np.testing.assert_allclose(tres["curves"]["val"], jres["curves"]["val"],
                               rtol=0, atol=1e-9)
    assert tres["curves"]["val"] == tres["curves"]["test"]
    assert tres["best_epoch"] == jres["best_epoch"]


# --- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_cli_finetune_writes_the_jax_result(domain, tmp_path, monkeypatch):
    """``cli.pretrain --device cpu`` writes a trunk, ``cli.finetune
    --device cpu --input_model_file`` fine-tunes from it and writes
    ``result.json``; the JAX CLI, handed the same run's result in place of
    its own, writes a file with the same keys and values (but ``config``,
    which holds each CLI's flags) at the same place."""
    pcli.main(["--domain", domain, "--device", "cpu", "--epochs", "1",
               "--num_layer", "2", "--emb_dim", "16", "--batch_size", "16",
               "--n_synthetic", "64", "--output_model_file",
               str(tmp_path / "trunk")])
    flags = ["--num_layer", "2", "--emb_dim", "16", "--epochs", "2",
             "--input_model_file", str(tmp_path / "trunk.pth")]
    if domain == "bio":
        flags += ["--domain", "bio", "--dataset", "synthetic_bio"]
    seen = {}
    real = tft.run_finetune

    def spy(*args, **kw):
        seen["res"] = real(*args, **kw)
        return seen["res"]

    monkeypatch.setattr(tft, "run_finetune", spy)
    out = cli.main([*flags, "--device", "cpu",
                    "--run_dir", str(tmp_path / "port")])
    name = f"{'synthetic_bio' if domain == 'bio' else 'synthetic'}_seed0"
    mine = json.loads((tmp_path / "port" / name / "result.json").read_text())
    assert mine == json.loads(json.dumps(out))
    assert len(mine["val"]) == 2 and mine["best_epoch"] in (1, 2)
    assert mine["config"]["device"] == "cpu"
    monkeypatch.setattr(jft, "run_finetune",
                        lambda *a, **kw: seen["res"])
    jcli.main([*flags, "--run_dir", str(tmp_path / "jax")])
    ref = json.loads((tmp_path / "jax" / name / "result.json").read_text())
    assert sorted(mine) == sorted(ref)
    if domain == "bio":
        assert {"test_hard", "test_hard_auc", "test_task_auc",
                "test_hard_task_auc"} <= set(mine)
    for key in ref:
        if key != "config":
            assert mine[key] == ref[key], key


def test_cli_finetune_cv_and_unported(tmp_path):
    """``--cv_fold``: batch 8 by default and a ``result.json`` with the
    JAX CLI's keys; a dataset that is not stored under ``--data_root``
    raises, naming the port's featurizer."""
    out = cli.main(["--device", "cpu", "--num_layer", "2", "--emb_dim", "16",
                    "--epochs", "1", "--n_synthetic", "64", "--cv_fold", "2",
                    "--run_dir", str(tmp_path)])
    assert sorted(out) == ["acc", "best_epoch", "dataset", "fold", "val_acc"]
    res = json.loads((tmp_path / "synthetic_drop0.5_bsize8_fold2"
                      / "result.json").read_text())
    assert sorted(res) == ["best_epoch", "config", "dataset", "fold",
                           "metric", "test", "val"]
    assert res["metric"] == "accuracy" and res["val"] == res["test"]
    with pytest.raises(FileNotFoundError,
                       match="pretrain_gnns_tpu_torch.cli.featurize"):
        cli.main(["--device", "cpu", "--dataset", "bbbp",
                  "--data_root", str(tmp_path)])
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    mine = {a.dest: a.default for a in cli.build_parser()._actions}
    # every flag of the JAX CLI with its default, but the halo's, which
    # waits for its module; plus --device
    assert {k: v for k, v in jflags.items() if k != "halo_devices"} == {
                k: v for k, v in mine.items() if k != "device"}
