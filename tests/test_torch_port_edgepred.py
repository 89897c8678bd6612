"""The port's edge-prediction path (data/batch_transforms.{BatchNegativeEdge,
NativeNegativeEdge}, native/negatives.cpp, objectives/edgepred.py, the GCN
and GraphSAGE convs of models/{chem,bio}.py, core/graphs.in_degree,
train/pretrain and the CLI with --objective edgepred) against the JAX
package, on the same seeded data and the same batches.

Parameters are carried over with compat.from_jax.state_dict_from_jax
(strict). The JAX objective runs on its XLA path and on its Pallas kernels
(K2 in the trunk, K3 in both scoring heads) in interpret mode and float32
(the JAX default compute dtype is bfloat16, which would hide real
differences). Sizes: 2 layers, emb 16, batches of 64 graphs, blocks of 128
nodes / 384 edge slots."""

import collections
import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_gnns_tpu import native as jnative
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import batch_transforms as jbt
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives.edgepred import (
    EdgePredObjective as JaxEdgePred,
)
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu.train.state import TrainState as JaxState
from pretrain_gnns_tpu_torch import native as tnative
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.data import batch_transforms as tbt
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.objectives.edgepred import EdgePredObjective
from pretrain_gnns_tpu_torch.train import optim
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain
from pretrain_gnns_tpu_torch.train.state import TrainState

LAYERS, EMB, BATCH, N_GRAPHS = 2, 16, 64, 128
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_trajectory_all.py
DOMAINS = ["chem", "bio"]
CONVS = ["gin", "gcn", "graphsage"]
TRUNKS = {"chem": (jchem.GNN, tchem.GNN), "bio": (jbio.GNN, tbio.GNN)}


def _graphs(domain):
    if domain == "bio":
        return tsyn.bio_dataset(N_GRAPHS, seed=0)
    return tsyn.molecule_dataset(N_GRAPHS, seed=0)[0]


def _cfg(domain, packing="blocked", gnn_type="gin"):
    return tpretrain.PretrainConfig(
        objective="edgepred", domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, packing=packing, gnn_type=gnn_type, seed=0)


@pytest.fixture(scope="module")
def batches():
    """{(domain, packing): the two batches of one epoch}, negatives from
    the loader that ``build_loader`` picks for the layout."""
    out = {}
    for domain in DOMAINS:
        for packing in ("blocked", "standard"):
            loader = tpretrain.build_loader(_cfg(domain, packing),
                                            _graphs(domain),
                                            torch.device("cpu"))
            out[domain, packing] = list(loader)
            assert len(out[domain, packing]) == N_GRAPHS // BATCH
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


def _pair(domain, gnn_type, batch0):
    """JAX objective + variables, and the port's objective holding the
    same parameters (strict load)."""
    jtrunk, ttrunk = TRUNKS[domain]
    jm = JaxEdgePred(num_layer=LAYERS, emb_dim=EMB, gnn_type=gnn_type,
                     trunk=jtrunk)
    variables = dict(jm.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        _jax_batch(batch0), train=False))
    variables.setdefault("batch_stats", {})  # bio GCN/GraphSAGE: no BN
    tm = EdgePredObjective(num_layer=LAYERS, emb_dim=EMB, gnn_type=gnn_type,
                           trunk=ttrunk)
    tm.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    return jm, variables, tm


# -- negative sampling ------------------------------------------------------

def _check_negatives(batch, pairs, mask, blocked_layout=None):
    """The constraints of tests/test_edgepred_fast.py::_check_negatives."""
    ng, nm = np.asarray(batch.node_graph), np.asarray(batch.node_mask)
    snd, rcv = np.asarray(batch.senders), np.asarray(batch.receivers)
    em = np.asarray(batch.edge_mask)
    edge_set = set(zip(snd[em].tolist(), rcv[em].tolist()))
    sel = pairs[mask]
    assert len(sel) > 0
    assert len(set(map(tuple, sel.tolist()))) == len(sel), "duplicates"
    assert all(a != b for a, b in sel), "self-loops"
    assert all((a, b) not in edge_set for a, b in sel), "existing edges"
    assert all(nm[a] and nm[b] and ng[a] == ng[b] for a, b in sel), \
        "cross-graph or padded endpoints"
    eper = collections.Counter(ng[snd[em]].tolist())
    per = collections.Counter(ng[sel[:, 0]].tolist())
    assert all(per[g] <= eper[g] // 2 for g in per), "quota exceeded"
    if blocked_layout is not None:
        bn, half = blocked_layout
        for s, (a, b) in zip(np.nonzero(mask)[0], sel):
            assert s // half == a // bn == b // bn, "pair not in its block"
    assert not pairs[~mask].any()
    return len(sel), sum(v // 2 for v in eper.values())


@pytest.mark.parametrize("domain", DOMAINS)
def test_loader_picks_sampler_by_layout(batches, domain):
    """A blocked batch carries the C++ sampler's block-aligned negatives,
    a standard one the compact numpy ones; both obey every NegativeEdge
    constraint and nearly fill the quota."""
    for b in batches[domain, "blocked"]:
        assert sorted(k for k in b.extras if k.startswith("neg")) == [
            "negative_edges_blocked", "negative_edges_blocked_mask"]
        pairs = b.extras["negative_edges_blocked"]
        n_blocks = b.max_nodes // b.block_nodes
        assert pairs.shape == (n_blocks * b.block_edges // 2, 2)
        assert pairs.dtype == np.int32
        got, quota = _check_negatives(
            b, pairs, b.extras["negative_edges_blocked_mask"],
            blocked_layout=(b.block_nodes, b.block_edges // 2))
        assert got >= 0.98 * quota
    for b in batches[domain, "standard"]:
        assert b.block_nodes == 0 and "negative_edges_blocked" not in b.extras
        got, quota = _check_negatives(b, b.extras["negative_edges"],
                                      b.extras["negative_edges_mask"])
        assert got >= 0.98 * quota


@pytest.mark.parametrize("packing", ["blocked", "standard"])
@pytest.mark.parametrize("domain", DOMAINS)
def test_batch_negative_edge_matches_jax(batches, domain, packing):
    """``BatchNegativeEdge`` element for element under the same
    generator, on both layouts."""
    for i, b in enumerate(batches[domain, packing]):
        clean = b.replace(extras={k: v for k, v in b.extras.items()
                                  if not k.startswith("negative_edges")})
        port = tbt.BatchNegativeEdge()(clean, np.random.default_rng(i))
        ref = jbt.BatchNegativeEdge()(_jax_batch(clean).replace(
            extras=dict(clean.extras)), np.random.default_rng(i))
        for k in ("negative_edges", "negative_edges_mask"):
            a, r = np.asarray(port.extras[k]), np.asarray(ref.extras[k])
            assert a.dtype == r.dtype and a.shape == r.shape, k
            np.testing.assert_array_equal(a, r, err_msg=k)
        assert port.extras["negative_edges_mask"].sum() > 0


def test_selection_helpers_match_jax():
    """The numpy helpers on the same draws, the sorted fallback for large
    keyspaces included."""
    n_per = np.array([5, 9, 0, 14])
    e_per = np.array([8, 16, 0, 30])
    got = tbt.negative_candidates_np(np.random.default_rng(3), n_per, e_per)
    want = jbt.negative_candidates_np(np.random.default_rng(3), n_per, e_per)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    gid, a, b, cand_per = got
    M = 14
    key = gid * (M * M) + a * M + b
    rng = np.random.default_rng(4)
    exist = np.unique(rng.integers(0, 4 * M * M, 40))
    for keyspace in (4 * M * M, (1 << 24) + 1):
        for fn in ("select_first_valid_np", "select_negatives_np"):
            args = (key, exist, keyspace, a == b, cand_per, e_per // 2, gid)
            np.testing.assert_array_equal(getattr(tbt, fn)(*args),
                                          getattr(jbt, fn)(*args))


def _sampler_arrays(graphs, batch):
    """The C++ sampler's inputs derived from the host graphs in batch
    order (not from the packed batch, as the transform does)."""
    send = np.concatenate([g.edge_index[1] for g in graphs]).astype(np.int32)
    recv = np.concatenate([g.edge_index[0] for g in graphs]).astype(np.int32)
    lens_e = np.array([g.num_edges for g in graphs])
    edge_off = np.concatenate([[0], np.cumsum(lens_e)]).astype(np.int64)
    lens_n = np.array([g.num_nodes for g in graphs], np.int64)
    ng, eg = batch.node_graph, batch.node_graph[batch.receivers]
    nstarts = np.array([np.flatnonzero((ng == i) & batch.node_mask)[0]
                        for i in range(len(graphs))], np.int64)
    estarts = np.array([np.flatnonzero((eg == i) & batch.edge_mask)[0]
                        for i in range(len(graphs))], np.int64)
    return send, recv, edge_off, lens_n, nstarts, estarts


def _unsampled_batch(domain, packing):
    """The one batch of ``BATCH`` graphs without its transform, and the
    graphs in its slot order: the loader's shuffle of epoch 0."""
    graphs = _graphs(domain)[:BATCH]
    cfg = _cfg(domain, packing)
    loader = tpretrain.build_loader(cfg, graphs, torch.device("cpu"))
    loader.post_transform = None
    (batch,) = list(loader)
    order = np.arange(len(graphs))
    np.random.default_rng((cfg.seed, 0)).shuffle(order)
    return [graphs[i] for i in order], batch


@pytest.mark.parametrize("domain", DOMAINS)
def test_native_sampler_matches_jax_library(domain):
    """The port's sampler, called by ``NativeNegativeEdge`` on a packed
    batch, gives the JAX package's library's output on the same arrays and
    seed."""
    lib = jnative.load()
    if lib is None:
        pytest.skip("the JAX package's native library is unavailable")
    graphs, batch = _unsampled_batch(domain, "blocked")
    port = tbt.NativeNegativeEdge()(batch, np.random.default_rng(11))
    seed = int(np.random.default_rng(11).integers(np.uint64(2**63)))

    send, recv, edge_off, lens_n, nstarts, estarts = _sampler_arrays(
        graphs, batch)
    ids = np.arange(len(graphs), dtype=np.int64)
    as_c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    i64 = ctypes.c_int64
    be, n_blocks = batch.block_edges, batch.max_edges // batch.block_edges
    pairs = np.zeros((n_blocks * (be // 2), 2), np.int32)
    m = np.zeros(n_blocks * (be // 2), np.uint8)
    r = lib.sample_negatives_blocked(
        as_c(send), as_c(recv), as_c(edge_off), as_c(ids),
        i64(len(ids)), as_c(lens_n), as_c(nstarts), as_c(estarts),
        i64(be), i64(n_blocks), ctypes.c_uint64(seed), as_c(pairs),
        as_c(m))
    key = "negative_edges_blocked"
    assert r == m.sum() > 0
    np.testing.assert_array_equal(port.extras[key], pairs)
    np.testing.assert_array_equal(port.extras[key + "_mask"], m.astype(bool))
    assert port.extras[key].dtype == np.int32
    assert port.extras[key + "_mask"].dtype == bool


@pytest.mark.parametrize("domain", DOMAINS)
def test_native_negative_edge_needs_blocked_batch(domain):
    """A standard batch has no block regions to write into: the transform
    raises and leaves such batches to ``BatchNegativeEdge``."""
    _, batch = _unsampled_batch(domain, "standard")
    assert batch.block_nodes == 0
    with pytest.raises(ValueError, match="needs a blocked batch"):
        tbt.NativeNegativeEdge()(batch, np.random.default_rng(11))


def test_native_sampler_checks_its_inputs():
    tri = dict(send=[0, 1, 1, 2], recv=[1, 0, 2, 1], edge_off=[0, 4],
               lens_n=[3], nstarts=[0], estarts=[0])
    lay = dict(block_edges=8, n_blocks=1, seed=1)
    pairs, m = tnative.sample_negatives_blocked(**tri, **lay)
    assert m.sum() == 2 and {tuple(p) for p in pairs[m]} == {(0, 2), (2, 0)}
    two = dict(send=[0, 1], recv=[1, 0], edge_off=[0, 2], lens_n=[2],
               nstarts=[0], estarts=[0])
    pairs, m = tnative.sample_negatives_blocked(**two, **lay)
    assert not m.any()  # two nodes, both directions taken: nothing left
    with pytest.raises(ValueError, match="outside its graph"):
        tnative.sample_negatives_blocked(**{**two, "send": [0, 2]}, **lay)
    with pytest.raises(ValueError, match="partition"):
        tnative.sample_negatives_blocked(**{**two, "edge_off": [0, 3]}, **lay)
    with pytest.raises(ValueError, match="number of graphs"):
        tnative.sample_negatives_blocked(**{**tri, "estarts": [0, 0]}, **lay)
    with pytest.raises(ValueError, match="no block layout"):
        tnative.sample_negatives_blocked(**tri, **{**lay, "block_edges": 0})
    with pytest.raises(ValueError, match="overflowed"):  # block 1 of 1
        tnative.sample_negatives_blocked(**{**tri, "estarts": [8]}, **lay)


# -- graph helpers ----------------------------------------------------------

@pytest.mark.parametrize("domain", DOMAINS)
def test_in_degree_and_nodes_per_graph_match_jax(batches, domain):
    b = batches[domain, "blocked"][0]
    t, j = b.to("cpu"), _jax_batch(b)
    for self_loop in (False, True):
        got = t.in_degree(include_self_loop=self_loop)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j.in_degree(include_self_loop=self_loop)))
    np.testing.assert_array_equal(t.nodes_per_graph().numpy(),
                                  np.asarray(j.nodes_per_graph()))


# -- the objective ----------------------------------------------------------

def _assert_step_matches(domain, gnn_type, batch, backend):
    jm, variables, tm = _pair(domain, gnn_type, batch)

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
                              _np_tree(mutated.get("batch_stats", {})))
    names = [n for n, _ in tm.named_parameters()]
    assert names and all(n.startswith("gnn.") for n in names)
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("gnn_type", CONVS)
@pytest.mark.parametrize("domain", DOMAINS)
def test_blocked_step_matches_jax(batches, domain, gnn_type, backend):
    """One train-mode step on a blocked batch with all-padding blocks:
    loss, accuracy, every gradient (finite: GraphSAGE's L2 guard) and the
    BN statistics. On "pallas" the JAX side runs K2 and K3."""
    batch = batches[domain, "blocked"][0]
    used = batch.node_mask.reshape(-1, batch.block_nodes).any(axis=1)
    assert used.any() and not used.all()
    _assert_step_matches(domain, gnn_type, batch, backend)


@pytest.mark.parametrize("gnn_type", CONVS)
@pytest.mark.parametrize("domain", DOMAINS)
def test_standard_step_matches_jax(batches, domain, gnn_type):
    """The compact negatives and the ``[::2]`` positive pairs of a
    standard batch, against the JAX take path."""
    _assert_step_matches(domain, gnn_type, batches[domain, "standard"][0],
                         "xla")


@pytest.mark.parametrize("domain", DOMAINS)
def test_adam_trajectory_matches_jax(batches, domain):
    """Four Adam steps over the two blocked batches: the losses agree."""
    bs = batches[domain, "blocked"]
    jm, variables, tm = _pair(domain, "gin", bs[0])
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


@pytest.mark.parametrize("gnn_type", ["gcn", "graphsage"])
@pytest.mark.parametrize("domain", DOMAINS)
def test_trunk_forward_matches_jax(batches, domain, gnn_type):
    """Eval-mode GCN and GraphSAGE trunks on a blocked batch; the conv's
    ``linear`` loads from the reference's key."""
    batch = batches[domain, "blocked"][1]
    jtrunk, ttrunk = TRUNKS[domain]
    jgnn = jtrunk(num_layer=LAYERS, emb_dim=EMB, gnn_type=gnn_type)
    variables = dict(jgnn.init(jax.random.PRNGKey(4), _jax_batch(batch),
                               train=False))
    with jax_backend("pallas"):
        href = jgnn.apply(variables, _jax_batch(batch), train=False)
    sd = state_dict_from_jax(_np_tree(variables["params"]),
                             _np_tree(variables.get("batch_stats", {})))
    assert {"gnns.1.linear.weight", "gnns.1.linear.bias"} <= set(sd)
    tgnn = ttrunk(num_layer=LAYERS, emb_dim=EMB, gnn_type=gnn_type)
    tgnn.load_state_dict(sd, strict=True)
    with torch.no_grad():
        h = tgnn(batch.to("cpu"), train=False)
    assert not h[~torch.from_numpy(batch.node_mask)].any()
    np.testing.assert_allclose(h.numpy(), np.asarray(href), **GRAD_TOL)


def test_batch_without_negatives_raises(batches):
    b = batches["chem", "blocked"][0]
    clean = b.replace(extras={})
    tm = EdgePredObjective(num_layer=LAYERS, emb_dim=EMB)
    with pytest.raises(ValueError, match="no negative edges"):
        tm(clean.to("cpu"), train=True)


@pytest.mark.parametrize("flags,metric_steps", [
    ([], 4),
    (["--gnn_type", "gcn", "--packing", "blocked"], 4),
    (["--domain", "bio", "--gnn_type", "graphsage", "--n_synthetic", "256",
      "--packing", "blocked"], 4),
])
def test_cli_edgepred_one_epoch_on_cpu(tmp_path, flags, metric_steps):
    out = tmp_path / "trunk"
    history = cli.main([
        "--objective", "edgepred", "--device", "cpu", "--epochs", "1",
        "--num_layer", "2", "--emb_dim", "32", "--batch_size", "16",
        "--n_synthetic", "64", "--output_model_file", str(out), *flags,
    ])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] == metric_steps and history[0]["edges"] > 0
    assert 0.0 <= history[0]["acc"] <= 1.0
    trunk = torch.load(str(out) + ".pth")
    bio = "bio" in flags
    gnn_type = flags[flags.index("--gnn_type") + 1] if "--gnn_type" in flags \
        else "gin"
    (tbio.GNN if bio else tchem.GNN)(
        num_layer=2, emb_dim=32, gnn_type=gnn_type).load_state_dict(
            trunk, strict=True)
