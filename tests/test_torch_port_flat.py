"""The port's flat dataset and C++ packer (native/packer.cpp and its
bindings, data/flat.{FlatGraphs,FlatLoader,plan_epoch_plain,pack_plain},
data/packing.make_loader and build_loader's routing) against the JAX
package's FlatLoader and the port's PackedLoader, on the same seeded data.

Sizes: chem 80 molecules, bio 48 ego-networks, batches of 16 graphs,
blocks of 128 nodes / 384 edge slots (and 2 such blocks to force early
flushes). About 15 s alone."""

import dataclasses
import shutil
import warnings

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu_torch import native as tnative
from pretrain_gnns_tpu_torch.core.graphs import NODE_IDX, Graph
from pretrain_gnns_tpu_torch.data import flat as tflat
from pretrain_gnns_tpu_torch.data import packing as tpk
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain

BATCH = 16
N_GRAPHS = {"chem": 80, "bio": 48}
FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
          "node_mask", "edge_mask", "graph_mask", "y")
CPU = torch.device("cpu")


def _graphs(domain, module=tsyn, supervised=False):
    if domain == "bio":
        graphs = module.bio_dataset(N_GRAPHS["bio"], seed=2)
    else:
        graphs = module.molecule_dataset(N_GRAPHS["chem"], num_tasks=3,
                                         seed=2)[0]
    if supervised:  # bio: the labels move into y (train.pretrain)
        graphs = tpretrain.supervised_graphs(graphs, domain)[0]
    return graphs


def _assert_same(a, b, int_features=None):
    """Every field and extra equal in value; with ``int_features``, the
    port's integer features have that dtype."""
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)
    assert sorted(a.extras) == sorted(b.extras)
    for k in a.extras:
        np.testing.assert_array_equal(np.asarray(a.extras[k]),
                                      np.asarray(b.extras[k]), err_msg=k)
    assert (a.block_nodes, a.block_edges) == (b.block_nodes, b.block_edges)
    if int_features is not None and np.issubdtype(a.node_feat.dtype,
                                                  np.integer):
        assert a.node_feat.dtype == int_features
        assert a.edge_feat.dtype == int_features


def _layout(graphs, layout):
    """(blocks, max_nodes, max_edges); "tight" forces early flushes."""
    mn, me = tpk.buffer_sizes(graphs, BATCH)
    if layout == "blocked":
        return tpk.block_layout(graphs, BATCH, 128, 384), mn, me
    if layout == "tight blocked":
        return (2, 128, 384), mn, me
    if layout == "tight standard":
        return None, 256, 768
    return None, mn, me


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("layout", ["blocked", "standard", "tight blocked",
                                    "tight standard"])
@pytest.mark.parametrize("domain", ["chem", "bio", "bio supervised"])
def test_flat_loader_matches_jax_and_packed_loader(domain, layout,
                                                   drop_last):
    """Two epochs of the port's FlatLoader against the JAX package's
    make_loader (its FlatLoader) and the port's PackedLoader, same seed:
    every field and extra (bio: ``center_node_idx`` and its mask; bio
    supervised: ``y [G, 60]``) and the epoch's statistics. Chem
    features are int32 in the flat dataset (int64 in the graphs)."""
    dom, supervised = domain.split()[0], "supervised" in domain
    graphs = _graphs(dom, supervised=supervised)
    ref_graphs = _graphs(dom, jsyn, supervised)
    blocks, mn, me = _layout(graphs, layout)
    kw = dict(seed=3, blocks=blocks, drop_last=drop_last,
              extra_pad={"center_node_idx": BATCH} if dom == "bio" else None)
    port = tpk.make_loader(graphs, BATCH, mn, me, **kw)
    ref = jpk.make_loader(ref_graphs, BATCH, mn, me, **kw)
    packed = tpk.PackedLoader(graphs, BATCH, mn, me, **kw)
    assert type(port).__name__ == type(ref).__name__ == "FlatLoader"
    for _ in range(2):
        pb, rb, kb = list(port), list(ref), list(packed)
        assert len(pb) == len(rb) == len(kb) > 0
        for p, r, k in zip(pb, rb, kb):
            _assert_same(p, r, int_features=np.int32)
            _assert_same(p, k)
        assert port.last_epoch_stats == ref.last_epoch_stats == (
            packed.last_epoch_stats)
        st = port.last_epoch_stats
        assert isinstance(st["graphs"], int) and isinstance(st["edges"], int)
        if "tight" in layout:
            assert st["graphs_per_batch"] < BATCH  # early flushes ran
        if dom == "bio":
            assert pb[0].extras["center_node_idx_mask"].sum() == (
                pb[0].graph_mask.sum())
        if supervised:  # the go_target_pretrain labels, stacked once
            assert pb[0].y.shape == (BATCH, 60)
        full = N_GRAPHS[dom] // BATCH if "tight" not in layout else None
        if full is not None:
            assert len(pb) == full + (not drop_last and bool(
                N_GRAPHS[dom] % BATCH))


@pytest.mark.parametrize("domain", ["chem", "bio"])
@pytest.mark.parametrize("objective", tpretrain.PORTED_OBJECTIVES)
def test_build_loader_is_flat_for_every_objective(domain, objective):
    """``build_loader`` gives a FlatLoader on the synthetic datasets, and
    its batches, the objective's transform applied, equal PackedLoader's
    with the same transform and seed for two epochs."""
    graphs = _graphs(domain, supervised=objective == "supervised")
    cfg = tpretrain.PretrainConfig(
        objective=objective, domain=domain, num_layer=2, emb_dim=16,
        batch_size=BATCH, packing="blocked", seed=1,
        num_tasks=1 if objective != "supervised" else
        np.asarray(graphs[0].y).shape[0])
    loader = tpretrain.build_loader(cfg, graphs, CPU)
    assert type(loader).__name__ == "FlatLoader"
    assert (loader.post_transform is None) == (
        objective in ("infomax", "supervised"))
    ref = tpk.PackedLoader(
        graphs, BATCH, loader.max_nodes, loader.max_edges, seed=1,
        blocks=loader.blocks, drop_last=True, extra_pad=loader.extra_pad,
        post_transform=loader.post_transform)
    for _ in range(2):
        pb, rb = list(loader), list(ref)
        assert len(pb) == len(rb) == N_GRAPHS[domain] // BATCH
        for p, r in zip(pb, rb):
            _assert_same(p, r)


def _lens(seed, n):
    rng = np.random.default_rng(seed)
    lens_n = rng.integers(1, 60, n)
    return lens_n, lens_n * 2 + rng.integers(0, 40, n), rng.permutation(n)


@pytest.mark.parametrize("layout", [(8, 128, 384), (2, 128, 384),
                                    (1, 700, 2000), (3, 64, 160)])
@pytest.mark.parametrize("batch_size", [1, 7, 32])
def test_plan_epoch_matches_plain_walk(layout, batch_size):
    """The C++ planner against the Python first-fit walk: batch, node row
    and edge slot of every graph, and the number of batches."""
    lens_n, lens_e, order = _lens(batch_size, 300)
    got = tnative.plan_epoch(lens_n, lens_e, order, batch_size, *layout)
    want = tflat.plan_epoch_plain(lens_n, lens_e, order, batch_size, layout)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] >= 300 // batch_size
    assert np.all(np.diff(got[0]) >= 0)


def test_plan_epoch_raises_when_a_graph_exceeds_a_block():
    lens_n, lens_e, order = _lens(0, 50)
    lens_n[order[20]] = 129
    for plan in (lambda: tnative.plan_epoch(lens_n, lens_e, order, 16, 4,
                                            128, 384),
                 lambda: tflat.plan_epoch_plain(lens_n, lens_e, order, 16,
                                                (4, 128, 384))):
        with pytest.raises(ValueError, match="batch exceeds packed buffers"):
            plan()


@pytest.mark.parametrize("layout", ["blocked", "standard"])
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_pack_matches_plain_numpy_loop(domain, layout):
    """``FlatGraphs.pack`` (C++) against ``pack_plain`` (numpy), dtypes
    included, on the graphs of one shuffled batch; the extras' cursors
    come from the same placement."""
    flat = tflat.FlatGraphs.from_graphs(_graphs(domain))
    blocks, mn, me = _layout(_graphs(domain), layout)
    ids = np.random.default_rng(5).permutation(len(flat))[:BATCH]
    pad = {"center_node_idx": BATCH + 3}
    _, nstart, _, n = tnative.plan_epoch(flat.lens_n, flat.lens_e, ids,
                                         BATCH, *(blocks or (1, mn, me)))
    assert n == 1
    got = flat.pack(ids, mn, me, BATCH, blocks=blocks, extra_pad=pad,
                    nstart=nstart)
    want = tflat.pack_plain(flat, ids, mn, me, BATCH, blocks=blocks,
                            extra_pad=pad)
    _assert_same(got, want)
    for f in FIELDS[:-1]:
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for k in got.extras:
        assert got.extras[k].dtype == want.extras[k].dtype, k


def test_batches_own_their_buffers():
    """Each batch is packed into fresh arrays: the prefetch thread pins a
    batch while the next one is packed."""
    graphs = _graphs("chem")
    loader = tpk.make_loader(graphs, BATCH, blocks=(8, 128, 384))
    a, b = list(loader)[:2]
    for f in FIELDS[:-1]:
        assert not np.shares_memory(getattr(a, f), getattr(b, f)), f


def test_overflowing_batch_raises_as_jax():
    """A graph larger than a block: the JAX FlatLoader's ValueError, from
    ``pack`` and from the loader."""
    graphs = _graphs("chem")[:20]
    big = dataclasses.replace(graphs[0], node_feat=np.zeros((129, 2),
                                                            np.int64))
    flat = tflat.FlatGraphs.from_graphs(graphs + [big])
    with pytest.raises(ValueError, match="batch exceeds packed buffers"):
        tnative.plan_epoch(flat.lens_n, flat.lens_e, np.arange(21), 32, 4,
                           128, 384)
    with pytest.raises(ValueError, match="batch exceeds packed buffers"):
        list(tflat.FlatLoader(flat, BATCH, blocks=(4, 128, 384)))
    with pytest.raises(ValueError, match="needs nstart"):
        flat.pack(np.arange(20), 0, 0, 32, blocks=(4, 128, 384))
    with pytest.raises(ValueError, match="batch exceeds packed buffers"):
        flat.pack(np.arange(20), 100, 5000, 32)  # standard: too few rows


def test_flat_graphs_checks_and_shrinks():
    graphs = _graphs("chem")
    assert graphs[0].node_feat.dtype == np.int64
    flat = tflat.FlatGraphs.from_graphs(graphs)
    assert flat.node_feat.dtype == flat.edge_feat.dtype == np.int32
    assert flat.y.shape == (len(graphs), 3)
    bad = [Graph(g.node_feat, g.edge_index.copy(), g.edge_feat)
           for g in graphs[:3]]
    bad[1].edge_index[0, 0] = bad[1].num_nodes
    with pytest.raises(ValueError, match="outside its graph"):
        tflat.FlatGraphs.from_graphs(bad)


@pytest.mark.parametrize("fault", ["endpoint", "labels"])
def test_build_loader_raises_on_bad_graphs(fault):
    """Only extras that do not flatten take the PackedLoader route: an edge
    endpoint outside its graph, or labels of varying shapes, raise from
    ``build_loader`` with no fallback warning."""
    graphs = [dataclasses.replace(g, edge_index=g.edge_index.copy())
              for g in _graphs("chem")[:32]]
    if fault == "endpoint":
        graphs[5].edge_index[1, 0] = graphs[5].num_nodes
        match = "outside its graph"
    else:
        graphs[5] = dataclasses.replace(graphs[5], y=np.zeros(4))
        match = "same shape"
    cfg = tpretrain.PretrainConfig(objective="infomax", num_layer=2,
                                   emb_dim=16, batch_size=BATCH)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match=match):
            tpretrain.build_loader(cfg, graphs, "cpu")


def test_make_loader_falls_back_on_ragged_extras():
    """Graphs whose extras do not flatten get a PackedLoader, with a
    warning that says why."""
    graphs = _graphs("chem")[:32]
    for i, g in enumerate(graphs):
        g.extras["anchors"] = (np.arange(1 + i % 3), NODE_IDX)
    with pytest.warns(UserWarning, match="varying shapes"):
        loader = tpk.make_loader(graphs, BATCH, extra_pad={"anchors": 64})
    assert type(loader).__name__ == "PackedLoader"
    assert len(list(loader)) == 2


def test_wrappers_check_their_inputs():
    flat = tflat.FlatGraphs.from_graphs(_graphs("chem")[:8])
    arrays = flat._arrays()
    with pytest.raises(ValueError, match="outside the dataset"):
        tnative.pack_batch(*arrays, [0, 8], 512, 1024, 8)
    with pytest.raises(ValueError, match="recv must be a vector"):
        tnative.pack_batch(*arrays[:2], arrays[2][:-1], *arrays[3:], [0],
                           512, 1024, 8)
    with pytest.raises(ValueError, match="node_off does not partition"):
        tnative.pack_batch(arrays[0], arrays[1][:-1] + 0, *arrays[2:], [0],
                           512, 1024, 8)
    with pytest.raises(ValueError, match="block_of"):
        tnative.pack_batch(*arrays, [0, 1], 0, 0, 8, blocks=(2, 128, 384),
                           block_of=[0])
    with pytest.raises(ValueError, match="outside lens_n"):
        tnative.plan_epoch(flat.lens_n, flat.lens_e, [0, 8], 4, 1, 512,
                           1024)
    with pytest.raises(ValueError, match="lens_e"):
        tnative.plan_epoch(flat.lens_n, flat.lens_e[:-1], [0], 4, 1, 512,
                           1024)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that cannot run, or a source that does not
    compile, raises; so does every path that needs the library."""
    with pytest.raises(RuntimeError, match="could not run"):
        tnative.compile_library(tnative.SRC, tmp_path / "a.so",
                                cxx="no-such-compiler-xyz")
    broken = tmp_path / "packer.cpp"
    shutil.copy(tnative.SRC, broken)
    broken.write_text(broken.read_text() + "\nthis is not C++;\n")
    if shutil.which(tnative.CXX) is None:
        pytest.skip("no g++ to fail with")
    with pytest.raises(RuntimeError, match="failed"):
        tnative.compile_library(broken, tmp_path / "b.so")
    assert not (tmp_path / "b.so").exists()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    loader = tpk.make_loader(_graphs("chem"), BATCH, blocks=(8, 128, 384))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # and no fallback warning either
        with pytest.raises(RuntimeError, match="could not run"):
            next(iter(loader))
