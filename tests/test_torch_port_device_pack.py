"""The port's device-resident dataset (data/device_pack.py: build_device_flat,
stream_descriptor, materialize, EpochStackMixin.epoch_stack,
DeviceBatchLoader; data/context_loader.DeviceContextLoader; the compact
C++ sampler native.sample_negatives) against the JAX package's, on the same
seeded data, on the CPU.

Everything the host draws or plans is held element for element over two
epochs: the resident arrays and their offset tables, every descriptor
field (the shuffle, the chunk-aligned placements, the masking draws, the
negative pairs of the C++ sampler, block-aligned and compact, and of the
numpy sampler), the stacked epochs (``steps_cap`` padding, overflow,
``n_dev=2``) and the batches ``materialize`` builds from the descriptors,
extras included, dtypes too. Sizes: batches of 8 graphs, 48 graphs a
domain, blocks of 128 nodes and 384 edge slots."""

import copy

import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.data import context_loader as jcl
from pretrain_gnns_tpu.data import device_pack as jdp
from pretrain_gnns_tpu.data import flat as jflat
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.data import transforms as jtr
from pretrain_gnns_tpu_torch import native
from pretrain_gnns_tpu_torch.data import context_loader as tcl
from pretrain_gnns_tpu_torch.data import device_pack as tdp
from pretrain_gnns_tpu_torch.data import flat as tflat
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.data import transforms as ttr

BATCH, N_GRAPHS = 8, 48
MN, ME = 512, 1024  # the standard layout's buffers
BLOCKS = (4, 128, 384)
FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_graph",
          "node_mask", "edge_mask", "graph_mask", "y")


def _graphs(domain, lib):
    if domain == "bio":
        return lib.bio_dataset(N_GRAPHS, seed=1)
    return lib.molecule_dataset(N_GRAPHS, seed=1)[0]


def _flats(domain):
    return (jflat.FlatGraphs.from_graphs(_graphs(domain, jsyn)),
            tflat.FlatGraphs.from_graphs(_graphs(domain, tsyn)))


def _assert_same_arrays(t, j):
    """Two dicts of arrays: the same keys, values and dtypes."""
    assert sorted(t) == sorted(j)
    for k in j:
        a, b = np.asarray(t[k]), np.asarray(j[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_same_batch(t, j):
    """A port batch (torch leaves) and a JAX batch: every field and extra,
    value and dtype, and the layout."""
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _assert_same_arrays({f: a.numpy()}, {f: np.asarray(b)})
    assert (t.block_nodes, t.block_edges) == (j.block_nodes, j.block_edges)
    _assert_same_arrays({k: v.numpy() for k, v in t.extras.items()},
                        {k: np.asarray(v) for k, v in j.extras.items()})


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_build_device_flat_matches_jax(domain):
    """The chunked resident arrays (bio's float indicator features stored
    as int32) and the host tables, element for element; the port's arrays
    are tensors on the device asked for, numpy with ``as_numpy``."""
    jf, tf = _flats(domain)
    jdev, jaux = jdp.build_device_flat(jf, as_numpy=True)
    tdev, taux = tdp.build_device_flat(tf, "cpu")
    ndev, naux = tdp.build_device_flat(tf, as_numpy=True)
    assert all(isinstance(v, torch.Tensor) for v in tdev.values())
    assert all(isinstance(v, np.ndarray) for v in ndev.values())
    _assert_same_arrays({k: v.numpy() for k, v in tdev.items()}, jdev)
    _assert_same_arrays(ndev, jdev)
    assert sorted(taux) == sorted(jaux) == sorted(naux)
    for k in jaux:
        if isinstance(jaux[k], np.ndarray):
            _assert_same_arrays({k: taux[k]}, {k: jaux[k]})
        else:
            assert taux[k] == jaux[k], k
    if domain == "bio":
        assert taux["node_dtype"] is not None


def test_build_device_flat_refuses_fractional_features():
    g = tsyn.bio_dataset(4, seed=1)
    g[0].edge_feat = g[0].edge_feat * 0.5
    with pytest.raises(ValueError, match="integral edge features"):
        tdp.build_device_flat(tflat.FlatGraphs.from_graphs(g))


MASK = dict(rate=0.15, node_budget=200, edge_budget=ME // 2,
            atom_token=119, bond_token=5)
LOADERS = [
    ("chem", {}),
    ("chem", dict(mask_spec=dict(MASK, mask_edge=True))),
    ("chem", dict(mask_spec=dict(MASK, mask_edge=False))),
    ("chem", dict(neg_spec=dict(budget=ME // 2))),
    ("bio", dict(bio_mask_spec=dict(rate=0.15, budget=300))),
    ("bio", dict(neg_spec=dict(budget=ME // 2))),
    ("bio", dict(center_spec=True)),
]


@pytest.mark.parametrize("blocks", [None, BLOCKS], ids=["standard",
                                                        "blocked"])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("domain,specs", LOADERS)
def test_device_batch_loader_matches_jax(domain, specs, blocks, drop_last):
    """Two epochs: every descriptor (the compact or block-aligned C++
    negatives alike), the epoch statistics and the batch ``materialize``
    builds from each descriptor, against the JAX loader's and its
    ``materialize``'s."""
    jf, tf = _flats(domain)
    kw = dict(seed=3, blocks=blocks, drop_last=drop_last, **specs)
    jl = jdp.DeviceBatchLoader(jf, BATCH, MN, ME, **kw)
    tl = tdp.DeviceBatchLoader(tf, BATCH, MN, ME, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        jd, td = list(jl), list(tl)
        assert len(td) == len(jd) > 1
        for t, j in zip(td, jd):
            assert isinstance(t, tdp.Descriptor)
            _assert_same_arrays(t, j)
            _assert_same_batch(tl.prepare(t.to("cpu")), jl.prepare(j))
        assert tl.last_epoch_stats == jl.last_epoch_stats


def test_numpy_negative_sampler_matches_jax(monkeypatch):
    """``neg_spec["sampler"] = "numpy"``: the JAX loader's numpy rejection
    sampler (the JAX package takes it where its C++ library is missing),
    pair for pair."""
    from pretrain_gnns_tpu import native as jnative

    monkeypatch.setattr(jnative, "load", lambda: None)
    jf, tf = _flats("chem")
    jl = jdp.DeviceBatchLoader(jf, BATCH, MN, ME, seed=3,
                               neg_spec=dict(budget=ME // 2))
    tl = tdp.DeviceBatchLoader(tf, BATCH, MN, ME, seed=3,
                               neg_spec=dict(budget=ME // 2,
                                             sampler="numpy"))
    for t, j in zip(list(tl) + list(tl), list(jl) + list(jl)):
        _assert_same_arrays(t, j)


def test_compact_native_sampler_checks_its_inputs():
    """``native.sample_negatives``: graph ids outside the dataset and an
    overflowing budget raise; the pairs of a budget that fits them all
    equal the larger budget's prefix."""
    flat = tflat.FlatGraphs.from_graphs(_graphs("chem", tsyn))
    edges = native.DatasetEdges(flat.send, flat.recv, flat.edge_off,
                                flat.lens_n)
    ids = np.arange(4)
    starts = np.concatenate([[0], np.cumsum(flat.lens_n[ids])[:-1]])
    pairs, m = native.sample_negatives(edges, ids, starts, 7, budget=400)
    n = int(m.sum())
    assert n and not m[n:].any()
    again, m2 = native.sample_negatives(edges, ids, starts, 7, budget=n)
    np.testing.assert_array_equal(again, pairs[:n])
    assert m2.all()
    with pytest.raises(ValueError, match="budget"):
        native.sample_negatives(edges, ids, starts, 7, budget=n - 1)
    with pytest.raises(ValueError, match="outside the dataset"):
        native.sample_negatives(edges, [len(flat)], [0], 7, budget=8)


def test_chunk_alignment_is_checked():
    _, tf = _flats("chem")
    with pytest.raises(ValueError, match="chunk multiples"):
        tdp.DeviceBatchLoader(tf, BATCH, blocks=(4, 124, 384))


@pytest.mark.parametrize("steps_cap,n_dev", [(0, 1), (12, 1), (3, 1),
                                              (0, 2), (2, 2)],
                         ids=["exact", "padded", "overflow", "n_dev2",
                              "n_dev2_overflow"])
def test_epoch_stack_matches_jax(steps_cap, n_dev):
    """Two epochs of ``epoch_stack``: the stacked descriptors, ``valid``,
    the step count, the overflow descriptors and the statistics."""
    jf, tf = _flats("chem")
    kw = dict(seed=0, blocks=BLOCKS, mask_spec=dict(MASK, mask_edge=True))
    jl = jdp.DeviceBatchLoader(jf, BATCH, **kw)
    tl = tdp.DeviceBatchLoader(tf, BATCH, **kw)
    for _ in range(2):
        j = jl.epoch_stack(steps_cap=steps_cap, n_dev=n_dev)
        t = tl.epoch_stack(steps_cap=steps_cap, n_dev=n_dev)
        _assert_same_arrays(t["stacked"], j["stacked"])
        _assert_same_arrays({"v": t["valid"]}, {"v": j["valid"]})
        assert t["n_steps"] == j["n_steps"] and t["stats"] == j["stats"]
        assert len(t["overflow"]) == len(j["overflow"])
        for a, b in zip(t["overflow"], j["overflow"]):
            _assert_same_arrays(a, b)
    if steps_cap == 12:
        assert not t["valid"].all()
    if steps_cap in (3, 2):
        assert t["overflow"]


def _context(domain, lib):
    if domain == "bio":
        return lib.BioExtractSubstructureContextPair(1, True)
    return lib.ExtractSubstructureContextPair(2, 1, 3)


@pytest.mark.parametrize("blocked", [False, True], ids=["standard",
                                                         "blocked"])
@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_device_context_loader_matches_jax(domain, blocked):
    """Two variants, two epochs, and the two layouts: every descriptor
    (both streams' plans over the 8-padded lengths, ``center_slots``, the
    overlap rows), the statistics and both streams of the ``PackedPair``
    built from each, against the JAX ``DeviceContextLoader``; then the
    epoch's stack."""
    kw = dict(seed=0, variants=2, blocked=blocked)
    jl = jcl.DeviceContextLoader(_graphs(domain, jsyn), BATCH,
                                 _context(domain, jtr), MN, ME, **kw)
    tl = tcl.DeviceContextLoader(_graphs(domain, tsyn), BATCH,
                                 _context(domain, ttr), MN, ME, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        jd, td = list(jl), list(tl)
        assert len(td) == len(jd) > 1
        for t, j in zip(td, jd):
            _assert_same_arrays(t, j)
            pair = tl.prepare(t.to("cpu"))
            js, jc = jl.prepare(j)
            _assert_same_batch(pair.substruct, js)
            _assert_same_batch(pair.context, jc)
        assert tl.last_epoch_stats == jl.last_epoch_stats
    t, j = tl.epoch_stack(steps_cap=2), jl.epoch_stack(steps_cap=2)
    _assert_same_arrays(t["stacked"], j["stacked"])
    assert len(t["overflow"]) == len(j["overflow"])


def test_descriptor_moves_and_counts():
    """A descriptor moves, pins and counts as a batch does: its leaves as
    tensors, its valid edges, nodes and graphs (a context pair's both
    streams)."""
    _, tf = _flats("chem")
    tl = tdp.DeviceBatchLoader(tf, BATCH, blocks=BLOCKS)
    d = next(iter(tl))
    moved = d.to("cpu")
    assert isinstance(moved, tdp.Descriptor) and moved.layout == ()
    assert all(isinstance(v, torch.Tensor) for v in moved.values())
    assert d.counts() == moved.counts() == {
        "edges": int(d["edge_mask"].sum()), "nodes": int(d["node_mask"].sum()),
        "graphs": int(d["gmask"].sum())}
    pair = tcl.DeviceContextLoader(_graphs("chem", tsyn), BATCH,
                                   _context("chem", ttr), MN, ME, variants=1)
    p = next(iter(pair))
    assert p.counts()["edges"] == int(p["s_edge_mask"].sum()
                                      + p["c_edge_mask"].sum())


def test_materialize_restores_float_features():
    """Bio's indicator features come back in their own dtype."""
    _, tf = _flats("bio")
    tl = tdp.DeviceBatchLoader(tf, BATCH, blocks=BLOCKS)
    b = tl.prepare(next(iter(tl)).to("cpu"))
    assert b.node_feat.dtype == torch.from_numpy(tf.node_feat).dtype
    assert b.edge_feat.dtype == torch.from_numpy(tf.edge_feat).dtype
    assert b.senders.dtype == torch.int32


def test_set_epoch_restarts_the_pass():
    _, tf = _flats("chem")
    tl = tdp.DeviceBatchLoader(tf, BATCH, MN, ME, seed=2,
                               mask_spec=dict(MASK, mask_edge=True))
    passes = [list(tl) for _ in range(3)]
    twin = copy.copy(tl)
    twin.set_epoch(2)
    for t, j in zip(list(twin), passes[2]):
        _assert_same_arrays(t, j)
