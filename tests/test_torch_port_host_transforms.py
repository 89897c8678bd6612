"""The port's host-side transforms under ``transform_device="host"``
(data/transforms.{MaskAtom,MaskEdge,NegativeEdge},
data/packing.PackedLoader(transform=), data/batch_transforms.
BlockAlignNegatives, data/context_loader.ContextPairLoader, the host
branches of train/pretrain.build_loader, masking_mode and the CLI's
--transform_device) against the JAX package, on the same seeded data.

The transforms are held element for element over 64 graphs a domain under
one generator; the loaders batch for batch (every field and extra, two
epochs and a ``set_epoch(1)`` restart), the JAX ``build_loader``'s host
batches in the standard layout; the blocked ``ContextPairLoader`` draws
the JAX loader's pairs in its order, and its batches give the standard
layout's loss on the same pairs. The block-aligned host negatives give the
flat list's edge-prediction loss, gradients and ``dx`` (rtol 1e-6) and the
JAX objective's loss on the same blocked batch (rtol 1e-5). One train step
under ``host`` matches the JAX objective (chem masking GIN, bio edge
prediction GIN; rtol 1e-5 forward, 1e-4 gradients and statistics), and a
4-step ``run_pretrain`` matches the JAX ``run_pretrain`` from the same
initial weights (losses rtol 2e-4, atol 2e-5, tests/test_torch_trajectory.py's
limits). Sizes: 2 layers, emb 16, batches of 16 graphs, 64 graphs a
domain; the JAX side in float32 on XLA."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.cli import pretrain as jcli
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import context_loader as jcl
from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.data import transforms as jtr
from pretrain_gnns_tpu.ops import spmm as jspmm
from pretrain_gnns_tpu.train import pretrain as jpretrain
from pretrain_gnns_tpu_torch.cli import pretrain as tcli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.core.graphs import Graph, PackedPair
from pretrain_gnns_tpu_torch.data import batch_transforms as tbt
from pretrain_gnns_tpu_torch.data import context_loader as tcl
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.data import transforms as ttr
from pretrain_gnns_tpu_torch.ops import spmm as tspmm
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain

LAYERS, EMB, BATCH, N_GRAPHS = 2, 16, 16, 64
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LAYOUT_TOL = dict(rtol=1e-6, atol=1e-7)
TRAJ_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_trajectory.py:202
DOMAINS = ["chem", "bio"]
CPU = torch.device("cpu")


def _graphs(domain, lib):
    if domain == "bio":
        return lib.bio_dataset(N_GRAPHS, seed=1)
    return lib.molecule_dataset(N_GRAPHS, seed=1)[0]


def _cfg(lib, objective, domain, **kw):
    return lib.PretrainConfig(
        objective=objective, domain=domain, num_layer=LAYERS, emb_dim=EMB,
        batch_size=BATCH, seed=0, csize=2,
        **{"packing": "standard", "transform_device": "host", **kw})


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


FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
          "node_mask", "edge_mask", "graph_mask", "y")


def _assert_same_batch(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
    assert (t.block_nodes, t.block_edges) == (j.block_nodes, j.block_edges)
    assert sorted(t.extras) == sorted(j.extras)
    for k in t.extras:
        np.testing.assert_array_equal(np.asarray(t.extras[k]),
                                      np.asarray(j.extras[k]), err_msg=k)
        assert np.asarray(t.extras[k]).dtype == np.asarray(j.extras[k]).dtype


def _assert_same_graph(t, j):
    for f in ("node_feat", "edge_index", "edge_feat"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    assert sorted(t.extras) == sorted(j.extras)
    for k, (arr, kind) in t.extras.items():
        jarr, jkind = j.extras[k]
        assert kind == jkind, k
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(jarr),
                                      err_msg=k)
        assert np.asarray(arr).dtype == np.asarray(jarr).dtype, k


# --- the per-graph transforms ------------------------------------------------

TRANSFORMS = [
    ("mask_atom", "chem", dict(mask_edge=True)),
    ("mask_atom", "chem", dict(mask_edge=False)),
    ("mask_atom", "chem", dict(mask_edge=True, given=True)),
    ("mask_atom", "chem", dict(mask_edge=False, mask_rate=0.4)),
    ("mask_edge", "bio", dict()),
    ("mask_edge", "bio", dict(given=True)),
    ("negative_edge", "chem", dict()),
    ("negative_edge", "bio", dict()),
]


def _make(lib, name, kw):
    if name == "mask_atom":
        return lib.MaskAtom(mask_rate=kw.get("mask_rate", 0.15),
                            mask_edge=kw["mask_edge"])
    if name == "mask_edge":
        return lib.MaskEdge(0.15)
    return lib.NegativeEdge()


@pytest.mark.parametrize("name,domain,kw", TRANSFORMS)
def test_transforms_match_jax(name, domain, kw):
    """64 graphs through one generator each side: the same graphs and
    extras (values, dtypes, kinds), the generators left in one state, the
    inputs unchanged."""
    tgraphs, jgraphs = _graphs(domain, tsyn), _graphs(domain, jsyn)
    before = copy.deepcopy(tgraphs)
    t, j = _make(ttr, name, kw), _make(jtr, name, kw)
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    for i, (tg, jgr) in enumerate(zip(tgraphs, jgraphs)):
        if kw.get("given"):
            n = tg.num_nodes if name == "mask_atom" else tg.num_edges // 2
            idx = np.arange(0, n, 3)
            idx = idx if name == "mask_atom" else 2 * idx
            _assert_same_graph(t(tg, rt, idx), j(jgr, rj, idx))
        else:
            _assert_same_graph(t(tg, rt), j(jgr, rj))
    assert rt.integers(1 << 30) == rj.integers(1 << 30)
    for a, b in zip(tgraphs, before):
        _assert_same_graph(a, b)


# --- PackedLoader(transform=) ------------------------------------------------

@pytest.mark.parametrize("layout", ["standard", "blocked"])
@pytest.mark.parametrize("name,domain,kw", [TRANSFORMS[0], TRANSFORMS[4],
                                            TRANSFORMS[7]])
def test_packed_loader_transform_matches_jax(name, domain, kw, layout):
    """The JAX ``PackedLoader(transform=)`` batch for batch over two
    epochs, then the port's ``set_epoch(1)`` pass against the JAX second
    pass; buffers tight enough (standard) to flush some batches early."""
    tgraphs, jgraphs = _graphs(domain, tsyn), _graphs(domain, jsyn)
    pad = {"masked_atom_indices": 200, "mask_node_label": 200,
           "connected_edge_indices": 400, "mask_edge_label": 400,
           "masked_edge_idx": 800, "negative_edges": 4000,
           "center_node_idx": BATCH}
    if layout == "blocked":
        geo = dict(blocks=tpk.block_layout(tgraphs, BATCH, 128, 384))
    else:
        mn, me = tpk.buffer_sizes(tgraphs, BATCH)
        geo = dict(max_nodes=mn * 3 // 4, max_edges=me * 3 // 4)
    kwargs = dict(seed=3, drop_last=False, extra_pad=pad, **geo)
    tl = tpk.PackedLoader(tgraphs, BATCH, transform=_make(ttr, name, kw),
                          **kwargs)
    jl = jpk.PackedLoader(jgraphs, BATCH, transform=_make(jtr, name, kw),
                          **kwargs)
    passes = []
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) >= N_GRAPHS // BATCH
        for a, b in zip(tb, jb):
            _assert_same_batch(a, b)
        assert tl.last_epoch_stats == jl.last_epoch_stats
        passes.append(tb)
    if layout == "standard":
        assert len(passes[0]) > N_GRAPHS // BATCH  # early flushes
    tl.set_epoch(1)
    for a, b in zip(list(tl), passes[1]):
        _assert_same_batch(a, b)


# --- ContextPairLoader -------------------------------------------------------

def _context_loaders(domain, mn, me):
    cfg = _cfg(tpretrain, "contextpred", domain)
    jt = (jtr.BioExtractSubstructureContextPair(cfg.l1, cfg.center)
          if domain == "bio" else jtr.ExtractSubstructureContextPair(
              LAYERS, LAYERS - 1, LAYERS - 1 + cfg.csize))
    jl = jcl.ContextPairLoader(_graphs(domain, jsyn), BATCH, jt, mn, me,
                               seed=0, drop_last=False)
    tl = tcl.ContextPairLoader(_graphs(domain, tsyn), BATCH,
                               tpretrain.context_transform(cfg), mn, me,
                               seed=0, drop_last=False)
    return tl, jl


@pytest.mark.parametrize("domain", DOMAINS)
def test_context_pair_loader_matches_jax(domain):
    """Standard layout: two epochs of the JAX loader pair for pair (both
    streams, the centre and the overlap rows with their masks), the
    batches closed for room where the JAX loader closes them; then the
    port's ``set_epoch(1)`` pass against the JAX second pass."""
    mn, me = (16 * 40, 16 * 120) if domain == "bio" else (16 * 5, 16 * 10)
    tl, jl = _context_loaders(domain, mn, me)
    passes = []
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > N_GRAPHS // BATCH
        for t, (js, jc) in zip(tb, jb):
            assert isinstance(t, PackedPair)
            _assert_same_batch(t.substruct, js)
            _assert_same_batch(t.context, jc)
        assert tl.last_epoch_stats["graphs"] == sum(
            int(np.asarray(s.graph_mask).sum()) for s, _ in jb)
        assert tl.last_epoch_stats["batches"] == len(jb)
        passes.append(tb)
    assert any(int(b.substruct.graph_mask.sum()) < BATCH
               for b in passes[0][:-1])  # closed for room
    tl.set_epoch(1)
    for a, b in zip(list(tl), passes[1]):
        for x, y in zip(a.leaves().values(), b.leaves().values()):
            np.testing.assert_array_equal(x, y)


def _unpack(g, center_key=None):
    """A stream's graphs in slot order: node features, local edges, edge
    features and the graph's rows of ``center_key`` (local)."""
    ng, nm = np.asarray(g.node_graph), np.asarray(g.node_mask)
    em = np.asarray(g.edge_mask)
    rcv, snd = np.asarray(g.receivers), np.asarray(g.senders)
    out = []
    for gi in np.flatnonzero(np.asarray(g.graph_mask)):
        rows = np.flatnonzero(nm & (ng == gi))
        slots = np.flatnonzero(em & (ng[rcv] == gi))
        item = [np.asarray(g.node_feat)[rows],
                np.stack([rcv[slots], snd[slots]]) - rows[0],
                np.asarray(g.edge_feat)[slots]]
        if center_key is not None:
            idx = np.asarray(g.extras[center_key])[
                np.asarray(g.extras[center_key + "_mask"])]
            item.append(np.sort(idx[ng[idx] == gi]) - rows[0])
        out.append(item)
    return out


@pytest.mark.parametrize("domain", DOMAINS)
def test_blocked_context_pair_loader_draws_the_jax_pairs(domain):
    """Blocked, on the graphs' geometry: every pair the JAX loader draws
    appears once, in its draw order (substructures with their centre,
    contexts with their overlap rows), each stream on the one geometry
    the whole run; each blocked batch gives the loss of a standard batch
    of the same pairs (rtol 1e-5)."""
    tgraphs = _graphs(domain, tsyn)
    blocks = tpk.block_layout(tgraphs, BATCH, 128, 384)
    cfg = _cfg(tpretrain, "contextpred", domain, packing="blocked")
    loader = tpretrain.build_loader(cfg, tgraphs, CPU, drop_last=False)
    assert isinstance(loader, tcl.ContextPairLoader)
    assert loader.blocks == (blocks, blocks)
    _, jl = _context_loaders(domain, 4096, 16384)
    model = tpretrain.build_objective(cfg)
    for _ in range(2):
        want = [(s, c) for js, jc in jl
                for s, c in zip(_unpack(js, "center_substruct_idx"),
                                _unpack(jc, "overlap_context_substruct_idx"))]
        got, n_batches = [], 0
        for ids, b in loader.iter_blocked():
            n_batches += 1
            for stream in (b.substruct, b.context):
                assert stream.max_nodes == blocks[0] * blocks[1]
                assert (stream.block_nodes, stream.block_edges) == blocks[1:]
            got += list(zip(_unpack(b.substruct, "center_substruct_idx"),
                            _unpack(b.context,
                                    "overlap_context_substruct_idx")))
            std = loader.pack_standard([loader.pairs[i] for i in ids])
            with torch.no_grad():
                a = float(model(b.to(CPU), train=True)[0])
                s = float(model(std.to(CPU), train=True)[0])
            np.testing.assert_allclose(a, s, rtol=1e-5)
        assert len(got) == len(want) == loader.last_epoch_stats["graphs"]
        assert n_batches == loader.last_epoch_stats["batches"]
        for (gs, gc), (ws, wc) in zip(got, want):
            for x, y in zip(gs + gc, ws + wc):
                np.testing.assert_array_equal(x, y)


# --- the block-aligned host negatives ---------------------------------------

def _edgepred_host_batches(domain):
    """The first blocked host batch and the same batch with the flat list
    kept (no re-layout)."""
    cfg = _cfg(tpretrain, "edgepred", domain, packing="blocked")
    loader = tpretrain.build_loader(cfg, _graphs(domain, tsyn), CPU)
    assert isinstance(loader.post_transform, tbt.BlockAlignNegatives)
    post, loader.post_transform = loader.post_transform, None
    flat = next(iter(loader))
    loader.set_epoch(0)
    loader.post_transform = post
    return cfg, next(iter(loader)), flat


@pytest.mark.parametrize("domain", DOMAINS)
def test_block_aligned_negatives(domain):
    """The re-layout moves each graph's pairs, in order, into its block's
    slots: the same pairs, both ends in the block, batch order within a
    block, the flat list gone."""
    cfg, blocked, flat = _edgepred_host_batches(domain)
    assert "negative_edges" not in blocked.extras
    pairs = flat.extras["negative_edges"][flat.extras["negative_edges_mask"]]
    got = blocked.extras["negative_edges_blocked"]
    m = blocked.extras["negative_edges_blocked_mask"]
    half = blocked.block_edges // 2
    assert got.shape == (blocked.max_edges // 2, 2) and got.dtype == np.int32
    slots = np.flatnonzero(m)
    assert len(slots) == len(pairs) > 0
    assert (slots // half == got[slots, 0] // blocked.block_nodes).all()
    assert (got[slots, 1] // blocked.block_nodes
            == got[slots, 0] // blocked.block_nodes).all()
    assert not got[~m].any()
    blk = pairs[:, 0] // blocked.block_nodes
    np.testing.assert_array_equal(got[slots],
                                  pairs[np.argsort(blk, kind="stable")])
    # within a block, from its first slot on
    per = np.bincount(slots // half, minlength=blocked.max_edges // 2 // half)
    for b in np.flatnonzero(per):
        assert m[b * half: b * half + per[b]].all()


@pytest.mark.parametrize("domain", DOMAINS)
def test_block_aligned_negatives_give_the_flat_loss(domain):
    """The edge-prediction loss, every gradient and ``dx`` of the negative
    head on the re-laid-out batch equal the flat list's (rtol 1e-6), and
    the JAX objective's loss on the same blocked batch (rtol 1e-5)."""
    from pretrain_gnns_tpu.models import bio as jbio
    from pretrain_gnns_tpu.models import chem as jchem
    from pretrain_gnns_tpu.objectives.edgepred import (
        EdgePredObjective as JaxEdgePred,
    )

    cfg, blocked, flat = _edgepred_host_batches(domain)
    model = tpretrain.build_objective(cfg)
    out = {}
    for name, b in (("blocked", blocked), ("flat", flat)):
        model.zero_grad()
        loss, _ = model(b.to(CPU), train=True)
        loss.backward()
        out[name] = float(loss.detach()), {
            n: p.grad.clone() for n, p in model.named_parameters()}
    np.testing.assert_allclose(out["blocked"][0], out["flat"][0],
                               **LAYOUT_TOL)
    for n, g in out["flat"][1].items():
        np.testing.assert_allclose(out["blocked"][1][n].numpy(), g.numpy(),
                                   err_msg=n, **LAYOUT_TOL)
    # dx of the negative head alone
    h0 = torch.randn(blocked.max_nodes, 8, generator=torch.Generator()
                     .manual_seed(0), dtype=torch.float64)
    dx = {}
    for name, b in (("blocked", blocked.to(CPU)), ("flat", flat.to(CPU))):
        h = h0.clone().requires_grad_(True)
        if name == "blocked":
            neg = b.extras["negative_edges_blocked"]
            s = tspmm.edge_dot(h, neg[:, 0].contiguous(),
                               neg[:, 1].contiguous(),
                               b.extras["negative_edges_blocked_mask"],
                               b.block_nodes, b.block_edges // 2)
        else:
            neg = b.extras["negative_edges"]
            s = tspmm.edge_dot(h, neg[:, 0], neg[:, 1],
                               b.extras["negative_edges_mask"])
        torch.sigmoid(s).pow(2).sum().backward()
        dx[name] = h.grad
    assert dx["flat"].abs().sum() > 0
    np.testing.assert_allclose(dx["blocked"].numpy(), dx["flat"].numpy(),
                               **LAYOUT_TOL)
    # the JAX objective on the same blocked batch
    jm = JaxEdgePred(num_layer=LAYERS, emb_dim=EMB,
                     trunk=jbio.GNN if domain == "bio" else jchem.GNN)
    with jax_float32():
        variables = dict(jm.init({"params": jax.random.PRNGKey(0),
                                  "mask": jax.random.PRNGKey(1)},
                                 _jax_batch(blocked), train=False))
        variables.setdefault("batch_stats", {})
        (jloss, _), _ = jm.apply(variables, _jax_batch(blocked), train=True,
                                 mutable=["batch_stats"])
    model.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    with torch.no_grad():
        tloss = float(model(blocked.to(CPU), train=True)[0])
    np.testing.assert_allclose(tloss, float(jloss), **LOSS_TOL)


def _tiny_blocked(n_pairs, cross=False):
    """Two 3-atom molecules of one bond each, both in block 0 of two
    blocks of 8 nodes / 4 slots (2 pair slots a block), and ``n_pairs``
    flat pairs in block 0 (with ``cross`` the first pair's second end in
    block 1)."""
    g = Graph(node_feat=np.zeros((3, 2), np.int64),
              edge_index=np.array([[0, 1], [1, 0]], np.int64),
              edge_feat=np.zeros((2, 2), np.int64))
    b = next(iter(tpk.PackedLoader([g, g], 2, blocks=(2, 8, 4),
                                   shuffle=False)))
    assert b.node_mask[:6].all() and not b.node_mask[8:].any()
    pad = np.zeros((8, 2), np.int32)
    pad[:n_pairs] = [[0, 2 + 8 * cross]] + [[3, 5]] * (n_pairs - 1)
    m = np.zeros(8, bool)
    m[:n_pairs] = True
    return b.replace(extras={"negative_edges": pad,
                             "negative_edges_mask": m})


def test_block_aligned_negatives_raise():
    """A block past its ``block_edges // 2`` slots, a pair that crosses
    its block and a standard batch raise."""
    align = tbt.BlockAlignNegatives()
    assert align(_tiny_blocked(2)).extras[
        "negative_edges_blocked_mask"].sum() == 2
    with pytest.raises(ValueError, match="exceed"):
        align(_tiny_blocked(3))
    with pytest.raises(ValueError, match="crosses"):
        align(_tiny_blocked(1, cross=True))
    standard = next(iter(tpk.PackedLoader(
        _graphs("chem", tsyn)[:4], 4, shuffle=False)))
    with pytest.raises(ValueError, match="blocked"):
        align(standard)


# --- build_loader, the resolution and the CLI --------------------------------

@pytest.mark.parametrize("objective,domain", [
    ("masking", "chem"), ("masking", "bio"), ("edgepred", "chem"),
    ("edgepred", "bio"), ("contextpred", "chem"), ("contextpred", "bio")])
def test_build_loader_host_matches_jax(objective, domain):
    """``build_loader(transform_device="host")`` in the standard layout:
    the JAX ``build_loader``'s batches element for element, two epochs."""
    kw = dict(mask_edge=True) if objective == "masking" else {}
    tl = tpretrain.build_loader(_cfg(tpretrain, objective, domain, **kw),
                                _graphs(domain, tsyn), CPU)
    jl = jpretrain.build_loader(_cfg(jpretrain, objective, domain, **kw),
                                _graphs(domain, jsyn))
    assert type(tl).__name__ == type(jl).__name__
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > 0
        for t, j in zip(tb, jb):
            if objective == "contextpred":
                _assert_same_batch(t.substruct, j[0])
                _assert_same_batch(t.context, j[1])
            else:
                _assert_same_batch(t, j)


def test_transform_device_resolution_matches_jax():
    """``masking_mode`` over every (objective, domain, choice); "device"
    on chem masking builds the JAX package's ``FusedMaskingObjective`` on
    the clean batches of its loader (it raised ``NotImplementedError``
    until the port had that objective), and elsewhere builds the "batch"
    loader, as the JAX package does without its device-resident dataset;
    an unknown choice raises."""
    for objective in tpretrain.PORTED_OBJECTIVES:
        for domain in DOMAINS:
            for choice in tpretrain.TRANSFORM_DEVICES:
                t = _cfg(tpretrain, objective, domain,
                         transform_device=choice)
                j = _cfg(jpretrain, objective, domain,
                         transform_device=choice)
                assert tpretrain.masking_mode(t) == jpretrain.masking_mode(j)
    cfg = _cfg(tpretrain, "masking", "chem", transform_device="device")
    jcfg = _cfg(jpretrain, "masking", "chem", transform_device="device")
    assert (type(tpretrain.build_objective(cfg)).__name__
            == type(jpretrain.build_objective(jcfg)).__name__
            == "FusedMaskingObjective")
    clean = list(tpretrain.build_loader(cfg, _graphs("chem", tsyn), CPU))
    jclean = list(jpretrain.build_loader(jcfg, _graphs("chem", jsyn)))
    assert len(clean) == len(jclean) > 1
    for t, j in zip(clean, jclean):
        assert not t.extras
        _assert_same_batch(t, j)
    for objective, domain in (("edgepred", "chem"), ("masking", "bio")):
        graphs = _graphs(domain, tsyn)
        dev = tpretrain.build_loader(
            _cfg(tpretrain, objective, domain, transform_device="device"),
            graphs, CPU)
        batch = tpretrain.build_loader(
            _cfg(tpretrain, objective, domain, transform_device="batch"),
            graphs, CPU)
        assert type(dev) is type(batch) and type(dev) is not (
            tpk.PackedLoader)
        for a, b in zip(dev, batch):
            for x, y in zip(a.leaves().values(), b.leaves().values()):
                np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="transform_device"):
        tpretrain.build_loader(
            _cfg(tpretrain, "masking", "bio", transform_device="gpu"),
            _graphs("bio", tsyn), CPU)


def test_cli_transform_device_matches_jax():
    """``--transform_device``: the JAX CLI's choices and default."""
    def flag(parser):
        return next(a for a in parser._actions
                    if a.dest == "transform_device")

    t, j = flag(tcli.build_parser()), flag(jcli.build_parser())
    assert (t.default, t.choices) == (j.default, j.choices)
    assert t.default == "auto" and list(t.choices) == [
        "auto", "host", "batch", "device"]


@pytest.mark.parametrize("domain,objective", [
    ("chem", "masking"), ("bio", "masking"), ("chem", "edgepred"),
    ("bio", "contextpred")])
def test_cli_host_one_epoch_on_cpu(tmp_path, domain, objective):
    """One epoch through the CLI under ``--transform_device host``, blocked
    (the card's layout) on the CPU."""
    history = tcli.main([
        "--domain", domain, "--objective", objective, "--device", "cpu",
        "--epochs", "1", "--num_layer", str(LAYERS), "--emb_dim", str(EMB),
        "--batch_size", str(BATCH), "--n_synthetic", "256", "--csize", "2",
        "--packing", "blocked", "--transform_device", "host",
        "--output_model_file", str(tmp_path / "trunk")])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["steps"] >= 3 and history[0]["edges"] > 0


@pytest.mark.parametrize("objective,domain", [
    ("masking", "chem"), ("masking", "bio"), ("edgepred", "chem"),
    ("edgepred", "bio"), ("contextpred", "chem"), ("contextpred", "bio")])
def test_host_runs_replay_bit_equal(objective, domain):
    """``run_pretrain`` under ``host``, blocked, at scan_steps 2 (the
    ScanStep's slots: every host batch keeps the first one's signature)
    equals scan_steps 1 bit for bit."""
    graphs = _graphs(domain, tsyn)
    runs = [tpretrain.run_pretrain(
        _cfg(tpretrain, objective, domain, packing="blocked", scan_steps=k),
        graphs, log=None, epochs=2, device="cpu") for k in (1, 2)]
    assert runs[1]["replays"] > 0
    assert runs[0]["history"] == runs[1]["history"]
    for name, v in runs[0]["model"].state_dict().items():
        assert torch.equal(runs[1]["model"].state_dict()[name], v), name


# --- one step and a trajectory against the JAX package -----------------------

HOST_PATHS = [("masking", "chem"), ("edgepred", "bio")]


def _jax_init(jcfg, graphs):
    """The JAX ``run_pretrain``'s initial variables (its key split and
    first batch)."""
    jm = jpretrain.build_objective(jcfg)
    first = next(iter(jpretrain.build_loader(jcfg, graphs)))
    rng = jax.random.PRNGKey(jcfg.seed)
    rng, init_rng, mask_rng = jax.random.split(rng, 3)
    variables = dict(jm.init({"params": init_rng, "mask": mask_rng}, first,
                             train=False))
    variables.setdefault("batch_stats", {})
    return jm, variables, first


def _port_model(cfg, variables, build=None):
    model = (build or tpretrain.build_objective)(cfg)
    model.load_state_dict(state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])),
        strict=True)
    return model


@pytest.mark.parametrize("objective,domain", HOST_PATHS)
def test_host_step_matches_jax(objective, domain):
    """One train-mode step on the first host batch: loss and metrics
    (rtol 1e-5), every gradient and the batch-norm statistics (rtol 1e-4,
    atol 1e-5 of the tensor's largest entry)."""
    kw = dict(mask_edge=True) if objective == "masking" else {}
    jcfg = _cfg(jpretrain, objective, domain, **kw)
    cfg = _cfg(tpretrain, objective, domain, **kw)
    with jax_float32():
        jm, variables, first = _jax_init(jcfg, _graphs(domain, jsyn))
    batch = next(iter(tpretrain.build_loader(cfg, _graphs(domain, tsyn),
                                             CPU)))
    _assert_same_batch(batch, first)

    def loss_fn(params):
        (loss, metrics), mutated = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            _jax_batch(batch), train=True, mutable=["batch_stats"],
            rngs={"mask": jax.random.PRNGKey(3)})
        return loss, (metrics, mutated)

    with jax_float32():
        (jloss, (jmetrics, mutated)), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    model = _port_model(cfg, variables)
    tloss, tmetrics = model(batch.to(CPU), train=True)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **LOSS_TOL)
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in tmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   err_msg=k, **LOSS_TOL)
    ref = state_dict_from_jax(_np_tree(jgrads),
                              _np_tree(mutated.get("batch_stats", {})))
    checked = [(n, p.grad) for n, p in model.named_parameters()] + [
        (n, b) for n, b in model.named_buffers()
        if n.endswith(("running_mean", "running_var"))]
    assert len(checked) > 4
    for name, got in checked:
        want = ref[name].numpy()
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(1.0, float(np.abs(want).max())),
            err_msg=name)


@pytest.mark.parametrize("objective,domain", HOST_PATHS)
def test_host_trajectory_matches_jax_run_pretrain(monkeypatch, objective,
                                                  domain):
    """Four epochs of one step each through both ``run_pretrain``s under
    ``host`` from the JAX run's initial weights: the per-step losses (the
    metrics count signs and argmaxes, which one rounding can flip, so they
    are not held). The JAX run draws its first batch before its first epoch
    (ROADMAP F11), so its epoch E takes the loader's pass E; the port's
    loader is started one pass on to match."""
    kw = dict(mask_edge=True) if objective == "masking" else {}
    jcfg = _cfg(jpretrain, objective, domain, **kw)
    cfg = _cfg(tpretrain, objective, domain, **kw)
    jgraphs = _graphs(domain, jsyn)[:BATCH]
    with jax_float32():
        _, variables, _ = _jax_init(jcfg, jgraphs)
        jres = jpretrain.run_pretrain(jcfg, jgraphs, log=None, epochs=4)
    build_loader, build_objective = (tpretrain.build_loader,
                                     tpretrain.build_objective)

    def one_pass_on(*a, **k):
        loader = build_loader(*a, **k)
        start = loader.set_epoch
        loader.set_epoch = lambda e: start(e + 1)
        return loader

    monkeypatch.setattr(tpretrain, "build_objective",
                        lambda c: _port_model(c, variables, build_objective))
    monkeypatch.setattr(tpretrain, "build_loader", one_pass_on)
    tres = tpretrain.run_pretrain(cfg, _graphs(domain, tsyn)[:BATCH],
                                  log=None, epochs=4, device="cpu")
    th, jh = tres["history"], jres["history"]
    assert [h["steps"] for h in th] == [1] * 4 and len(jh) == 4
    assert len({round(h["loss"], 6) for h in th}) > 1  # it moved
    assert sorted(k for k in th[0] if k not in ("edges", "steps")) == (
        sorted(jh[0]))
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], **TRAJ_TOL)
