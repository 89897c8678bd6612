"""The port's context prediction (data/transforms.py, data/context_loader.py,
objectives/contextpred.py, its routes through train/pretrain, train/graphed
and train/telemetry) against the JAX package, on the same seeded data.

The transforms are held element for element, under one generator, in both
domains; ``PresampledContextLoader``'s batches array for array with the
JAX loader's (both streams, the centre rows, the overlap rows and their
mask, ``last_epoch_stats``); ``blocked_pair_walk`` batch for batch and
start for start with the JAX ``DeviceContextLoader(blocked=True)
._iter_blocked`` on that loader's own lengths and geometry (and on a
geometry of one block a stream, so that batches close for room), and
``stream_layout`` with its ``layout``; a blocked pair batch gives the
standard one's loss on the same ids. The objective's loss, metrics, every
gradient of both trunks and the batch-norm statistics match the JAX
objective's on the same blocked batch (parameters carried over by
``compat.from_jax.state_dict_from_jax``, strict), in chem and bio, cbow
and skipgram, one and two negatives, mean and sum pooling, and one GAT
case; four Adam steps match too. The JAX trunks run their XLA path in
float32. Sizes: 2-3 layers, emb 16, batches of 16 graphs, 40 graphs (chem
contexts: the ring between hops 1 and 3 or 2 and 4). Tolerances: loss and
metrics rtol 1e-5, gradients and statistics rtol 1e-4 and atol 1e-5 of
the tensor's largest entry (at least 1e-5: sum pooling scales scores and
gradients by the overlap's size), the Adam trajectory rtol 5e-4 (as the
other objectives'), indices exact."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import context_loader as jcl
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.data import transforms as jtr
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.objectives import contextpred as jcp
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.core.graphs import PackedPair
from pretrain_gnns_tpu_torch.data import context_loader as tcl
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.data import transforms as ttr
from pretrain_gnns_tpu_torch.train import graphed, optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState
from pretrain_gnns_tpu_torch.train.telemetry import ThroughputMeter

LAYERS, EMB, BATCH, N_GRAPHS, VARIANTS = 3, 16, 16, 40, 2
CSIZE = 2  # chem: substructure 3 hops, context between hops 2 and 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)
DOMAINS = ["chem", "bio"]
CPU = torch.device("cpu")


def _graphs(domain, lib):
    if domain == "bio":
        return lib.bio_dataset(N_GRAPHS, seed=1)
    return lib.molecule_dataset(N_GRAPHS, seed=1)[0]


def _cfg(domain, **kw):
    return tpretrain.PretrainConfig(
        objective="contextpred", domain=domain, num_layer=LAYERS,
        emb_dim=EMB, batch_size=BATCH, csize=CSIZE, seed=0,
        context_variants=VARIANTS, **{"packing": "blocked", **kw})


def _jax_transform(cfg):
    if cfg.domain == "bio":
        return jtr.BioExtractSubstructureContextPair(cfg.l1, cfg.center)
    l1 = cfg.num_layer - 1
    return jtr.ExtractSubstructureContextPair(cfg.num_layer, l1,
                                              l1 + cfg.csize)


@contextlib.contextmanager
def jax_float32():
    """The JAX spmm dispatch on XLA in float32."""
    backend, dtype = jspmm.get_backend(), jspmm._DTYPE
    jspmm.set_backend("xla")
    jspmm.set_compute_dtype("float32")
    try:
        yield
    finally:
        jspmm.set_backend(backend)
        jspmm.set_compute_dtype(dtype)


def _jax_graphs(p):
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


FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
          "node_mask", "edge_mask", "graph_mask")


def _assert_same_stream(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert sorted(t.extras) == sorted(j.extras)
    for k in t.extras:
        np.testing.assert_array_equal(t.extras[k], np.asarray(j.extras[k]),
                                      err_msg=k)


# --- transforms --------------------------------------------------------------

TRANSFORMS = [
    ("chem", (5, 4, 7)), ("chem", (3, 2, 4)), ("chem", (1, 0, 2)),
    ("bio", (1, True)), ("bio", (0, True)), ("bio", (2, False)),
]


@pytest.mark.parametrize("domain,args", TRANSFORMS)
def test_transforms_match_jax(domain, args):
    """Every pair (or None) equal element for element, extras and their
    kinds included, from generators of one seed: the same draws."""
    cls = ("BioExtractSubstructureContextPair" if domain == "bio"
           else "ExtractSubstructureContextPair")
    jt, tt = getattr(jtr, cls)(*args), getattr(ttr, cls)(*args)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    nones = 0
    for jgr, tgr in zip(_graphs(domain, jsyn), _graphs(domain, tsyn)):
        jp, tp = jt(jgr, jr), tt(tgr, tr)
        assert (jp is None) == (tp is None)
        if jp is None:
            nones += 1
            continue
        for name in ("substruct", "context"):
            a, b = getattr(tp, name), getattr(jp, name)
            for f in ("node_feat", "edge_index", "edge_feat"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.extras.keys() == b.extras.keys()
            for k, (v, kind) in a.extras.items():
                assert kind == b.extras[k][1]
                assert v.dtype == b.extras[k][0].dtype
                np.testing.assert_array_equal(v, b.extras[k][0])
    assert nones < N_GRAPHS // 2
    assert jr.integers(1 << 30) == tr.integers(1 << 30)  # as many draws


def test_k_hop_nodes_match_jax():
    graphs = tsyn.molecule_dataset(8, seed=5)[0]
    for g in graphs:
        for root in (0, g.num_nodes - 1):
            for k in (-1, 0, 1, 3, 40):
                np.testing.assert_array_equal(
                    ttr.k_hop_nodes(g.edge_index, g.num_nodes, root, k),
                    jtr.k_hop_nodes(g.edge_index, g.num_nodes, root, k))


# --- loaders -----------------------------------------------------------------


@pytest.mark.parametrize("domain", DOMAINS)
def test_presampled_loader_matches_jax(domain):
    """Three epochs (the two variants and the first again) of the standard
    layout: the same batches array for array, the same statistics; the
    meter's edge count of a pair batch is the statistics' share."""
    cfg = _cfg(domain, packing="standard")
    graphs = _graphs(domain, tsyn)
    # tight enough to close some batches early
    mn, me = (16 * 40, 16 * 120) if domain == "bio" else (16 * 8, 16 * 18)
    jl = jcl.PresampledContextLoader(_graphs(domain, jsyn), BATCH,
                                     _jax_transform(cfg), mn, me, seed=0,
                                     variants=VARIANTS, drop_last=False)
    tl = tcl.PresampledContextLoader(graphs, BATCH,
                                     tpretrain.context_transform(cfg), mn,
                                     me, seed=0, variants=VARIANTS,
                                     drop_last=False)
    for _ in range(3):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > 2
        for t, (js, jc) in zip(tb, jb):
            assert isinstance(t, PackedPair)
            _assert_same_stream(t.substruct, js)
            _assert_same_stream(t.context, jc)
        assert tl.last_epoch_stats == jl.last_epoch_stats
        assert sum(ThroughputMeter.counts_of(b)["edges"] for b in tb) == (
            tl.last_epoch_stats["edges"])
    assert any(int(b.substruct.graph_mask.sum()) < BATCH for b in tb[:-1])


def _jax_device_loader(domain):
    cfg = _cfg(domain)
    return jcl.DeviceContextLoader(
        _graphs(domain, jsyn), BATCH, _jax_transform(cfg), 1024, 4096,
        seed=0, variants=VARIANTS, blocked=True, drop_last=False)


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("domain", DOMAINS)
def test_blocked_walk_matches_jax(domain, tight):
    """``blocked_pair_walk`` on the JAX device loader's chunk-rounded
    lengths and geometry gives its ``_iter_blocked``'s batches and starts
    in both streams, epoch after epoch; with ``tight`` one block a stream,
    so that batches close when a stream runs out of room. Its
    ``stream_layout`` is the loader's ``layout``."""
    dl = _jax_device_loader(domain)
    for aux, geo in ((dl._aux_s, (dl.nb_s, dl.bn_s, dl.be_s)),
                     (dl._aux_c, (dl.nb_c, dl.bn_c, dl.be_c))):
        assert tcl.stream_layout(
            np.concatenate([a["lens_n8"] for a in aux]),
            np.concatenate([a["lens_e8"] for a in aux]), BATCH) == geo
    if tight:
        dl.nb_s = dl.nb_c = 1
    geometry = ((dl.nb_s, dl.bn_s, dl.be_s), (dl.nb_c, dl.bn_c, dl.be_c))
    short = 0
    for epoch in range(3):
        want = list(dl._iter_blocked())
        v = epoch % VARIANTS
        order = np.arange(len(dl._sub[v]))
        np.random.default_rng((0, epoch)).shuffle(order)
        lens = ((dl._aux_s[v]["lens_n8"], dl._aux_s[v]["lens_e8"]),
                (dl._aux_c[v]["lens_n8"], dl._aux_c[v]["lens_e8"]))
        got = list(tcl.blocked_pair_walk(order, lens, geometry, BATCH,
                                         drop_last=False))
        assert len(got) == len(want)
        batch, starts, n = native.plan_pair_epoch(*lens, order, BATCH,
                                                  *geometry)
        assert n == len(want)
        for b, (ids, (s_sub, s_ctx)) in enumerate(got):
            np.testing.assert_array_equal(order[batch == b], ids)
            np.testing.assert_array_equal(
                starts[batch == b], np.stack([*s_sub, *s_ctx], axis=1))
        for (ids, starts), (wv, wids, wstarts) in zip(got, want):
            assert wv == v
            np.testing.assert_array_equal(ids, wids)
            for a, b in zip(np.asarray(starts).reshape(4, -1),
                            np.asarray(wstarts).reshape(4, -1)):
                np.testing.assert_array_equal(a, b)
            short += len(ids) < BATCH
    assert short > 3 * tight


def test_blocked_walk_raises_on_a_pair_too_large():
    lens = ((np.array([10, 200]), np.array([8, 8])),
            (np.array([5, 5]), np.array([4, 4])))
    geometry = ((1, 128, 384), (1, 128, 384))
    with pytest.raises(ValueError, match="exceeds"):
        list(tcl.blocked_pair_walk([0, 1], lens, geometry, 4))
    with pytest.raises(ValueError, match="exceeds"):
        native.plan_pair_epoch(*lens, [0, 1], 4, *geometry)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_pair_epoch_equals_its_plain_version(seed):
    """The C++ joint walk against the Python one on random lengths and
    tight geometries (batches close for room in either stream)."""
    rng = np.random.default_rng(seed)
    n = 300
    lens = ((rng.integers(1, 60, n), rng.integers(0, 150, n)),
            (rng.integers(1, 30, n), rng.integers(0, 90, n)))
    geometry = ((3, 64, 192), (2, 48, 128))
    order = rng.permutation(n)
    batch, starts, n_batches = native.plan_pair_epoch(*lens, order, 16,
                                                      *geometry)
    want = list(tcl.blocked_pair_walk(order, lens, geometry, 16,
                                      drop_last=False))
    assert n_batches == len(want) > n // 16
    for b, (ids, (s_sub, s_ctx)) in enumerate(want):
        np.testing.assert_array_equal(order[batch == b], ids)
        np.testing.assert_array_equal(starts[batch == b],
                                      np.stack([*s_sub, *s_ctx], axis=1))


@pytest.mark.parametrize("domain", DOMAINS)
def test_blocked_batches_place_each_graph_at_its_start(domain):
    """The port's blocked loader: each stream has its own geometry, every
    batch both streams' layouts, each graph's rows at the walk's start in
    its stream, the centre rows offset by the substructures' starts and
    the overlap rows by the contexts' (pointing at rows of their own
    graph), static shapes of centre [batch_size] and overlap [context
    rows]."""
    loader = tpretrain.build_loader(_cfg(domain), _graphs(domain, tsyn), CPU,
                                    drop_last=False)
    (nb_s, bn_s, be_s), (nb_c, bn_c, be_c) = loader.blocks
    for v, ids, placement in loader._iter_blocked():
        (ns_s, _), (ns_c, _) = placement
        b = loader._batch_blocked(v, ids, placement)
        sub, ctx = b.substruct, b.context
        assert (sub.block_nodes, sub.block_edges) == (bn_s, be_s)
        assert (ctx.block_nodes, ctx.block_edges) == (bn_c, be_c)
        assert sub.max_nodes == nb_s * bn_s and ctx.max_nodes == nb_c * bn_c
        G = len(ids)
        np.testing.assert_array_equal(sub.node_graph[ns_s], np.arange(G))
        np.testing.assert_array_equal(ctx.node_graph[ns_c], np.arange(G))
        center = sub.extras["center_substruct_idx"]
        assert center.shape == (BATCH,)
        np.testing.assert_array_equal(
            center[:G], ns_s + loader._sub[v].extras[
                "center_substruct_idx"][0][ids, 0])
        ov = ctx.extras["overlap_context_substruct_idx"]
        m = ctx.extras["overlap_context_substruct_idx_mask"]
        assert ov.shape == m.shape == (ctx.max_nodes,)
        assert ctx.node_mask[ov[m]].all()
        per_graph = np.diff(loader._ov_off[v])[ids]
        np.testing.assert_array_equal(ctx.node_graph[ov[m]],
                                      np.repeat(np.arange(G), per_graph))


@pytest.mark.parametrize("domain", DOMAINS)
def test_blocked_batch_gives_the_standard_loss(domain):
    """The same pairs packed blocked and standard give one loss, train and
    eval mode."""
    cfg = _cfg(domain)
    pairs = tpretrain.presample_context(cfg, _graphs(domain, tsyn))
    blocked = tpretrain.build_loader(cfg, pairs, CPU)
    standard = tpretrain.build_loader(
        dataclasses.replace(cfg, packing="standard"), pairs, CPU)
    assert blocked.blocks is not None and standard.blocks is None
    v, ids, placement = next(blocked._iter_blocked())
    model = tpretrain.build_objective(cfg)
    for train in (True, False):
        with torch.no_grad():
            a = model(blocked._batch_blocked(v, ids, placement).to(CPU),
                      train=train)[0]
            b = model(standard._batch(v, ids).to(CPU), train=train)[0]
        np.testing.assert_allclose(float(a), float(b), **LOSS_TOL)


def test_presampled_pairs_are_shared_and_checked():
    """``presample_context`` once, two loaders on it: the same batches as
    from the graphs; pairs of another seed or transform are refused."""
    cfg = _cfg("chem")
    graphs = _graphs("chem", tsyn)
    pairs = tpretrain.presample_context(cfg, graphs)
    assert pairs.seconds > 0 and len(pairs.sub) == VARIANTS
    a = list(tpretrain.build_loader(cfg, pairs, CPU))
    b = list(tpretrain.build_loader(cfg, graphs, CPU))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for (k, u), w in zip(x.leaves().items(), y.leaves().values()):
            np.testing.assert_array_equal(u, w, err_msg=k)
    for other in (dataclasses.replace(cfg, seed=1),
                  dataclasses.replace(cfg, csize=3),
                  dataclasses.replace(cfg, context_variants=3)):
        with pytest.raises(ValueError, match="presampled"):
            tpretrain.build_loader(other, pairs, CPU)


# --- the objective -----------------------------------------------------------


@pytest.fixture(scope="module")
def batches():
    """{domain: one epoch of blocked pair batches (drop_last off)}."""
    return {d: list(tpretrain.build_loader(_cfg(d), _graphs(d, tsyn), CPU,
                                           drop_last=False))
            for d in DOMAINS}


def _pair(cfg, batch0):
    """The JAX objective and its variables, and the port's objective
    holding the same parameters (strict load)."""
    jm = jcp.ContextPredObjective(
        num_layer=cfg.num_layer, csize=3 if cfg.domain == "bio" else
        cfg.csize, emb_dim=EMB, gnn_type=cfg.gnn_type, mode=cfg.mode,
        neg_samples=cfg.neg_samples, context_pooling=cfg.context_pooling,
        **({"trunk": jbio.GNN} if cfg.domain == "bio" else {}))
    with jax_float32():
        variables = dict(jm.init(jax.random.PRNGKey(0),
                                 _jax_graphs(batch0.substruct),
                                 _jax_graphs(batch0.context), train=False))
    tm = tpretrain.build_objective(cfg)
    sd = state_dict_from_jax(_np_tree(variables["params"]),
                             _np_tree(variables.get("batch_stats", {})))
    assert {k.split(".")[0] for k in sd} == {"gnn_substruct", "gnn_context"}
    tm.load_state_dict(sd, strict=True)
    return jm, variables, tm


def _assert_close(got, want, name):
    want = want.numpy()
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=GRAD_RTOL,
                               atol=atol, err_msg=name)


STEP_CASES = [
    ("chem", "gin", "cbow", 1, "mean", 0),
    ("chem", "gin", "cbow", 2, "sum", 2),
    ("chem", "gin", "skipgram", 1, "mean", 2),
    ("chem", "gin", "skipgram", 2, "mean", 0),
    ("chem", "gat", "cbow", 1, "mean", 0),
    ("bio", "gin", "cbow", 1, "sum", 2),
    ("bio", "gin", "cbow", 2, "mean", 0),
    ("bio", "gin", "skipgram", 1, "mean", 0),
    ("bio", "gin", "skipgram", 2, "sum", 2),
]


@pytest.mark.parametrize("domain,gnn_type,mode,neg,pooling,which",
                         STEP_CASES)
def test_step_matches_jax(batches, domain, gnn_type, mode, neg, pooling,
                          which):
    """One train-mode forward and backward on a full batch and on the
    epoch's short one: loss, balanced loss, accuracy, every gradient of
    both trunks and the batch-norm statistics."""
    cfg = _cfg(domain, gnn_type=gnn_type, mode=mode, neg_samples=neg,
               context_pooling=pooling)
    batch = batches[domain][which]
    assert (int(batch.substruct.graph_mask.sum()) < BATCH) == (which == 2)
    jm, variables, tm = _pair(cfg, batch)
    stats = variables.get("batch_stats", {})

    def loss_fn(params):
        (loss, metrics), mutated = jm.apply(
            {"params": params, "batch_stats": stats},
            _jax_graphs(batch.substruct), _jax_graphs(batch.context),
            train=True, mutable=["batch_stats"])
        return loss, (metrics, mutated)

    with jax_float32():
        (jloss, (jmetrics, mutated)), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    tloss, tmetrics = tm(batch.to(CPU), train=True)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    assert sorted(tmetrics) == sorted(jmetrics) == ["acc", "balanced_loss"]
    for k in tmetrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()),
                                   float(jmetrics[k]), err_msg=k, **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated.get("batch_stats", {})))
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        _assert_close(p.grad, ref[name], name)
    n_stats = 0
    for name, b in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            _assert_close(b, ref[name], name)
    assert n_stats > 0


@pytest.mark.parametrize("domain", DOMAINS)
def test_adam_trajectory_matches_jax(batches, domain):
    """Four Adam steps over the epoch's batches, the short one included:
    the losses agree."""
    cfg = _cfg(domain)
    bs = batches[domain]
    jm, variables, tm = _pair(cfg, bs[0])
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jstate = JaxState.create(dict(variables), tx, jax.random.PRNGKey(2))
    jstep = jpretrain.make_pretrain_step(jm, tx)
    tstate = TrainState(tm, optim.adam(tm.parameters(), lr=1e-3))
    jl, tl = [], []
    with jax_float32():
        for s in range(4):
            b = bs[s % len(bs)]
            jstate, loss, _ = jstep(jstate, _jax_graphs(b.substruct),
                                    _jax_graphs(b.context))
            jl.append(float(loss))
            loss, _ = tpretrain.train_step(tstate, b.to(CPU))
            tl.append(float(loss))
    assert tstate.step == 4
    assert len(set(np.round(tl, 6))) > 1
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)


@pytest.mark.parametrize("domain", DOMAINS)
def test_scan_steps_run_pairs_bit_equal(domain):
    """``run_pretrain`` at scan_steps 2 (the ScanStep's slots hold pair
    batches; on the CPU the steps run in turn) equals scan_steps 1 bit for
    bit, and its edge counts are the loader's."""
    graphs = _graphs(domain, tsyn)
    runs = [tpretrain.run_pretrain(_cfg(domain, scan_steps=k), graphs,
                                   log=None, epochs=3, device="cpu")
            for k in (1, 2)]
    assert runs[1]["replays"] > 0
    assert runs[0]["history"] == runs[1]["history"]
    for name, v in runs[0]["model"].state_dict().items():
        assert torch.equal(runs[1]["model"].state_dict()[name], v), name
    assert runs[0]["history"][-1]["edges"] == (
        runs[0]["loader"].last_epoch_stats["edges"])


def test_scan_step_signature_holds_both_streams(batches):
    """The signature names both streams' layouts and leaves; a pair whose
    context stream has another geometry is refused."""
    b = graphed.as_tensors(batches["chem"][0])
    sig = graphed.signature(b)
    assert sig[:2] == ((b.substruct.block_nodes, b.substruct.block_edges),
                       (b.context.block_nodes, b.context.block_edges))
    names = [s[0] for s in sig[2:]]
    assert "substruct/extras/center_substruct_idx" in names
    assert "context/extras/overlap_context_substruct_idx_mask" in names
    model = tpretrain.build_objective(_cfg("chem"))
    scan = tpretrain.make_scan_pretrain_step(
        TrainState(model, optim.adam(model.parameters(), lr=1e-3)), b, 2)
    other = PackedPair(b.substruct, b.context.replace(
        block_nodes=2 * b.context.block_nodes))
    with pytest.raises(ValueError, match="signature"):
        scan.step(other)
